"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py [--profile]

Phases, each fatal on failure (the script then exits non-zero and
prints no result line):

1. environment: the card's name and power limit, torch/CUDA/nvcc
   versions, the build of every kernel from ``paddle_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once), and the count of ``HGMMA``
   (wgmma) and ``UTMALDG`` (TMA load) instructions in the SASS of the
   tensor-core flash library, each of which must be above 0, and of
   ``HMMA`` (mma.sync, above 0) and ``LDGSTS``/``UBLKCP`` (cp.async or
   bulk copies, above 0 together) in the tensor-core ragged attention
   library, and of ``LDG.E.128``/``STG.E.128`` (16-byte loads and
   stores, each above 0) in the AdamW library;
2. kernel vs plain: each kernel against its plain PyTorch version on the
   card, in float32, bfloat16 and float16, with the errors, the median
   times, the bounds and the library call's time: the serving kernels at
   the serving path's widths (GPT-2: 12 heads, head_dim 64, hidden 768,
   KV blocks of 16; the quantized KV kernel over int8 and float8_e4m3fn
   pools in blocks of 32), the training kernels at the training path's
   (flash attention at [8, 1024, 12, 64] and at the ragged length 1000,
   causal, on both routes: bfloat16 and float16 on the tensor-core
   kernels (a second call must give the same bits), bfloat16 also at
   head_dim 128, float32 and the same 16-bit operands at an unaligned
   base on the CUDA-core kernels; the LayerNorm forward and backward at
   [8192, 768]; AdamW on a [50304, 768] parameter, and K8's group kernel
   on its edge list (each dtype combination at sizes 0, 1, 3, 5, 4097 and
   3 chunks + 7, a view at an offset of one element, 40 more tensors
   than a launch holds; launches counted equal to ``adamw_plan``'s) and
   over GPT-2 small's whole parameter list as ``AdamW.step()`` hands it
   over (``fused_adamw_step``: device ms, launches, the host wall of
   ``opt.step()``, ``AdamW(fused=True)`` over float32 copies, the
   list's bytes as the bound)). Each LayerNorm case
   runs on the warp-row kernels and, on the same operands at an unaligned
   base, on the CTA-per-row kernels, checked and timed on both; and both
   LayerNorm routes are held against the plain versions at D 1, 768,
   1024, 1600, 2049 and 16384 by 1, 7, 300 and 8192 rows in both dtypes;
3. engine: GPT-2 small (124M width, random weights from a seed, bf16)
   served through ``GenerationEngine(kv_layout="paged",
   attention="fused")`` — 16 concurrent requests with a chunked long
   prompt and a shared preamble — with the serving kernels' launch
   counts read around that run (every attention launch on the
   tensor-core route), and a float32 reference check of the engine's
   greedy tokens against the model's full forward;
3b. quantized KV: the same 16 requests served from an int8 pool
   (``kv_dtype="int8", block_size=32``) with the quantized kernel's
   launches counted and the float kernel's held at 0, the share of first
   tokens equal to phase 3's, the logit drift of one step against a bf16
   pool holding the same prompt, then 4 requests from a float8_e4m3fn
   pool; and the capacity line: the int8 tokens that fit phase 3's pool
   bytes;
3c. generate: ``model.generate`` on the same bf16 model (GPT-2 small at
   full width and depth): 8 unmasked prompts of 512 tokens, 64 new
   tokens, greedy, then sampled (top-k 50, top-p 0.9, seed 1); 4
   left-padded prompts of 96-256 real tokens in a 256-wide batch, 32 new
   tokens. Each run's K2 and K4 launches are counted around it and held
   to (2L + 1) x N and L (0 when masked), every K2 launch on the
   warp-row route and every K4 launch on the tensor-core route;
   generated tokens/s, prefill ms (a ``max_new_tokens=1`` call) and
   decode ms per token step; ``call_op``'s host cost per call. Then the
   unmasked greedy case in float32 at GPT-2 width cut to 2 layers, on
   the card and on a CPU copy (plain versions): the first step's logits
   within ``GEN_TOL``, and each row's tokens equal up to the first step
   where the CPU's top-2 logit margin falls below ``GEN_TOL``. Beam
   search (``num_beams=4``, 32 new tokens) on the 8 unmasked prompts (K4
   L times in the prefill, K2 (2L + 1) x steps at [32, 768] rows) and on
   the left-padded batch with ``length_penalty=0.6`` and an
   ``eos_token_id`` (no K4; the steps counted by a spy); beam tokens/s
   and ms a step; then a float32 2-layer beam search on the card and on
   a CPU copy: every row whose K + 1 best candidates never come within
   ``GEN_TOL`` of each other gives the same tokens;
3d. gather engines: phase 3's 16 requests (64 new tokens, greedy) on the
   same bf16 model through ``GenerationEngine(kv_layout="dense",
   attention="gather", min_bucket=32)``, ``kv_layout="paged",
   attention="gather", block_size=16`` and the same with
   ``kv_dtype="int8", block_size=32``: tokens/s, mean step ms, TTFT;
   K2 launches equal to (2L + 1) x (prefills + decode steps), K4 and
   K1/K1q held at 0 launches (the gather path computes attention
   without them). Then float32 at GPT-2 width cut to 2 layers: the dense
   and paged gather engines on the card against a CPU copy (first-step
   logits within ``GEN_TOL``), and the dense, paged gather and fused
   engines on the card agreeing token for token up to each request's
   first top-2 logit margin below ``GEN_TOL``; the int8 paged gather
   engine and the int8 fused engine each on the card against a CPU copy
   of itself (the fused one over K1q's plain version there), one request
   at a time (every step's logits within ``QUANT_GEN_TOL``, tokens equal
   up to the first top-2 margin below it), and to that step each
   engine's concurrent run on the card giving the same tokens;
3e. float16 serving: GPT-2 small in float16 (full width and depth,
   random weights from a seed) through the fused engine over a float16
   pool (blocks of 16) and over int8 and fp8 pools (blocks of 32), phase
   3's 16 requests each: K1/K1q 12 launches a step, all on the
   tensor-core route, K2 (2L + 1) a step, tokens/s, TTFT, mean step ms;
   the float16 dense gather engine on the same requests as the card's
   oracle (K1/K1q at 0; its tokens equal the fused float16 engine's up
   to each request's first top-2 logit margin below ``F16_GEN_TOL``);
   the int8 pool's one-step logit drift against a float16 pool within
   phase 3b's bound; ``generate`` over 8 unmasked prompts of 512, 32 new
   tokens (K4 float16 on the tensor-core route in the prefill); no plain
   version on the card; then a 2-layer float16 fused engine on the card
   and on a CPU copy: the first step's logits within ``F16_GEN_TOL``.
   Forward pre-hooks record the shape of every float16 K2 launch of the
   phase under ``fused_layer_norm_serve_f16``;
3f. speculative serving: phase 3's 16 requests on the bf16 model
   through ``GenerationEngine(..., spec_draft=..., spec_k=4)``: the
   default 2-layer draft (``"auto"``) over a bf16 pool (blocks of 16),
   the agreeing draft (the target itself) over the same pool, and the
   2-layer draft over an int8 pool (blocks of 32). Each: tokens/s, TTFT,
   mean cycle ms, accept rate and tokens per slot-cycle from the flight
   recorder (dumped to JSON and read back), one draft dispatch on every
   speculative cycle; K1/K1q 12 launches a fused launch, every one on
   the tensor-core route; K2 (2L + 1) a target launch plus (2 Ld + 1) a
   draft step or draft prefill, on the warp-row route, every shape
   recorded under ``fused_layer_norm_spec``; every draft and verify call
   under ``torch.cuda.set_sync_debug_mode("error")``; no plain version;
   the tokens equal phase 3's (phase 3b's for the int8 pool) before each
   request's first top-2 margin below ``SPEC_TIE_TOL`` (int8:
   ``SPEC_QUANT_TIE_TOL``). Then a 2-layer float32 speculative engine (a
   1-layer draft) on the card and on a CPU copy: the first verify
   launch's logits within ``GEN_TOL``, the tokens equal before each
   request's first CPU near-tie;
4. train: GPT-2 small at full width, bf16 AMP O2, AdamW with float32
   master weights, batch 8 x 1024 with next-token labels and the LM loss
   in 8 chunks (``bench.py``'s ``bench_gpt2`` configuration), through
   ``Model.fit``: 2 warm-up steps, then 8 timed steps with every training
   kernel's launch count read around them, every flash launch on the
   tensor-core route and every LayerNorm launch on the warp-row route (as
   in each engine run of phase 3); the same batch repeated must lower the
   loss; one float32 step of GPT-2 width at 2 layers on the card
   (kernels, flash on the CUDA-core route) against a CPU copy of the same
   weights (plain versions): loss, every gradient and every updated
   parameter;
4b. the recipe: GPT-2 small (full width and depth) trained through
   ``Model.fit`` the way it is trained: AdamW with f32 masters, bf16 O2,
   ``LinearWarmup(CosineAnnealingDecay(6e-4))`` over 4 warmup steps,
   ``ClipGradByGlobalNorm(1.0)``, no decay on biases and LayerNorm, 2
   epochs of 8 batches of 8 x 1024 tokens, 2 held-out batches evaluated
   after each epoch, checkpoints in a temporary ``save_dir`` and
   ``History``: each step's lr equal to the
   scheduler's closed form, each step's pre-clip global norm logged
   (GPT-2's stays below 1.0 here, so after the fit one more step runs
   with the clip norm at half the smallest, and its clipped gradients
   must have that global norm), the launches as phase 4 derives them plus
   the evaluated batches' forward kernels, and no call of any plain
   version; ``evaluate`` and ``eval_batch`` give 0.0 (GPT's labels are
   among its inputs, so there is no label batch: the JAX package's
   value), and the held-out loss is read from ``predict``'s first output
   (the network's own loss) and must be finite; a fresh ``Model`` loaded
   from the ``final`` checkpoint gives the same held-out loss and takes
   two more train steps within ``RESUME_TOL`` of the live one;
4c. float16: GPT-2 small in float16 O2 through the eager loop
   ``scaler.scale(loss).backward(); scaler.step(opt); scaler.update()``
   (``GradScaler(2**15, decr_every_n_nan_or_inf=1)``, AdamW with f32
   masters), 8 steps: flash on the tensor-core route in float16, AdamW on
   f32 masters with float16 gradients and copies, K8's plan launches
   over every parameter tensor for each step the scaler applied, no
   plain version; then one
   step whose gradient a hook makes non-finite: parameters, masters and
   moments keep their bits, AdamW launches 0 times, the scale halves, the
   optimizer's step stays; the next step applies. Then the same loop at
   GPT-2 width cut to 2 layers (batch 2 x 128) on the card and on a CPU
   copy: losses within ``FP16_LOSS_TOL`` and the same loss scales;
4d. bf16 O1: GPT-2 small with float32 parameters through ``Model.fit``
   at ``amp_configs={"level": "O1"}``, 8 steps on one repeated batch:
   AdamW on f32 parameters and gradients (no master), flash in bf16 on
   the tensor-core route, LayerNorm in f32, the loss finite and falling.
   Each of 4b-4d prints tokens/s, ms a step (wall / steps and the median
   step) and the peak memory, with the card's name and power limit;
5. observability (phase 5), on GPT-2 small bf16 at full width and
   depth: (i) phase 3's 16 requests through a fresh fused engine twice,
   admitted together (one schedule), once unarmed and once under the
   port's ``Profiler`` (CPU and GPU targets) and a span session: the
   same tokens both times, and phase 3's before each request's first
   top-2 margin below ``SPEC_TIE_TOL``; the device-op table read back
   from the Kineto trace (``profiler.device_op_table``) lists K1's
   (``rpa_tc_kernel``, ``rpa_tc_combine_kernel``) and K2's
   (``ln_fwd_warp_kernel``) launches equal to the wrappers' counters
   over the window; every ``serving/cycle`` span has its sweep and admit
   children and every step its dispatch and fetch; the unified trace has
   host spans, request lanes, memory counters and device events;
   ``stats()`` gives ``model_flops_per_token`` and ``serving_mfu``; the
   ledger's crosscheck gap and tokens/s armed and unarmed are printed;
   (ii) GPT-2 small bf16 O2 at 8 x 1024 through ``Model.fit`` for 6
   steps with ``numerics="warn"``, an inf injected into the 6th step's
   loss and ``ProfilerCallback(1, 4)``: exactly one anomaly with its
   postmortem, K4-K8 in the device-op table over steps 1-3 equal to the
   counters, steps 2-4 under ``torch.cuda.set_sync_debug_mode("error")``,
   ``hapi/mfu``; (iii) a fit at a batch of 512 x 1024 raises the
   allocator's ``torch.cuda.OutOfMemoryError`` after a memory postmortem
   holding the ledger and the largest live tensors;
6. the op library and Transformer (base) (``phase_transformer``): every
   op of the library (``ops/op_cases.py``) on CUDA tensors against the
   same op on the CPU within ``SWEEP_TOL`` (integers exactly,
   decompositions by their identities, samplers in distribution), each
   result on the card, the ops that read the card back listed (a second
   call under ``set_sync_debug_mode("error")``); a 2 + 2-layer
   ``nn.Transformer`` at base width in float32 on the card against a CPU
   copy (``TF_PARITY_TOL``); then Transformer (base), Vaswani et al. 2017
   Table 3 (6 + 6 layers, d_model 512, 8 heads, ffn 2048, WMT14 en-de's
   37000-token vocabulary, ``attn_dropout=0.0`` so the flash kernels are
   allowed), built from ``nn`` alone, trained through ``Model.fit`` at
   bf16 O1 with AdamW for 8 steps on one batch of 16 x (256 + 256)
   tokens: the loss finite and falling, each step's K2/K3/K4/K6/K8
   launches equal to the network's structure (K8: ``adamw_plan``'s
   launches over its 255 tensors, each tensor once; the decoder's masked
   self-attentions counted apart: the op's plain body), every flash
   launch tensor-core and every LayerNorm launch warp-row, no plain
   version; the six ``_transformer`` rows of the kernels line (the sixth,
   ``fused_adamw_step_transformer``, K8 over the fit's whole float32
   parameter list);
7. ResNet-50 (``phase_resnet``): ``bench.py``'s ``bench_resnet50``
   configuration, not cut (``resnet50(num_classes=1000,
   data_format="NHWC")``, random weights from the seed, bf16 AMP O2 with
   BatchNorm on the black list, ``Momentum(0.1, 0.9,
   multi_precision=True)``, ``nn.CrossEntropyLoss``, ``metric.Accuracy``,
   ``RandomState`` images ``[128, 224, 224, 3]`` and labels in
   ``[0, 1000)``) through ``Model.fit``: 1 warm-up and 8 timed steps on
   the fixed batch (up to 16 when 8 do not lower the loss), the loss
   finite and lower at the last timed step than at the first, every
   kernel counter (K1-K8) set to 0 before the fit and still 0 after it
   (the JAX package runs this network without a Pallas kernel), no plain
   version; one more step under ``set_sync_debug_mode("error")``; one
   more counted for the copies aten runs (dtype casts, layout copies) and
   the kernels of its device trace; ms a step, images/s and peak memory;
   first ``resnet18(num_classes=10)`` float32 on the card against a CPU
   copy, NCHW and NHWC, batch 4 at 32 x 32 (``rn_parity``: logits,
   loss, gradients, one Momentum step, the running statistics), and the
   22 ``extra_nn_ops`` among phase 6's swept ops;
10. BERT-base (``phase_bert``, run after phase 7): ``bench.py``'s
   ``bench_bert`` configuration, not cut (``BertConfig()`` with both
   dropouts 0, the QA head behind ``_QATrain``, bf16 AMP O2 with
   LayerNorm on the black list, ``AdamW(3e-5, weight_decay=0.01,
   multi_precision=True)``, ``RandomState(0)`` ids, start and end
   positions ``[32, 128]``) through the eager loop ``loss.backward();
   opt.step(); opt.clear_grad()``, 5 warm-up and 30 timed steps on the
   fixed batch: each step's launches K2 = K3 = 25 (all warp-row), K4 =
   K6 = 12 (all tensor-core), K8 = ``adamw_plan``'s over the 199
   parameter tensors with a gradient (the pooler's two get none), no
   plain version, the loss finite and lower at the last timed step than
   at the first, one more step under ``set_sync_debug_mode("error")``;
   steps/s, tokens/s, ms a step (wall / steps, and the median of CUDA
   events between steps), peak memory and MFU (``bench.py``'s formula
   over the card's peak). First a 2-layer BERT at base width in float32
   on the card against a CPU copy: the QA head masked and unmasked and
   the masked-LM head (tied decoder), logits, loss and every gradient
   within ``TF_PARITY_TOL``. The kernels line's ``_bert`` rows hold
   K2/K3 float32 ``[4096, 768]``, K4/K6 bf16 ``[32, 128, 12, 64]`` not
   causal and K8 over the fit's parameter list against their plain
   versions, with SDPA, ``F.layer_norm`` and ``AdamW(fused=True)``
   beside them;
11. the text models (``phase_text``): the 13 ``sequence_ops`` among
   phase 6's swept ops, none reading the card back; ``TransformerModel``
   at phase 6's width (6 + 6 layers, d_model 512, 8 heads, ffn 2048,
   vocabulary 37000) in float32 at 2 + 2 layers greedy on the card
   against a CPU copy (tokens equal before each row's first CPU top-2
   margin below ``GEN_TOL``); ``nn.LSTM``/``nn.GRU`` (2 layers,
   bidirectional, with ``sequence_length``) and ``dynamic_decode`` over
   an ``LSTMCell`` beam decoder on the card against the CPU
   (``RNN_TOL``); then the full model in bf16 decoding 16 padded sources
   to 64 tokens greedily and with 4 beams: K2 launches = 2 x 6 + 3 x 6 a
   decode step, all warp-row, K4-K7 0 (every attention is masked), no
   plain version, ms a step and generated tokens/s;
12. the deployment path (``phase_deploy``, after phase 11): (i) BERT-base
   as phase 10 builds it (bf16 AMP O2) saved through ``Model(net,
   inputs=[InputSpec([None, 128], "int64", "input_ids"),
   InputSpec([None, 128], "int64", "token_type_ids")]).save(path,
   training=False)`` (``jit.save``: a ``torch.export`` artifact whose
   graph calls the K2/K4 custom ops) and served by
   ``inference.create_predictor`` on ``RandomState(0)`` ``[32, 128]``
   ids (token types 0): each ``Predictor.run`` launches exactly K2 = 25
   (warp-row) and K4 = 12 (tensor-core) from inside the loaded program,
   no plain version; start and end logits against the eager network on
   the card within bf16's ``TOL``; the same artifact at batch 1 and 7;
   export and load seconds, artifact bytes, ``Predictor.run`` ms (median
   of CUDA events) and sequences/s beside the same forward eager and
   through ``jit.to_static``; a 2-layer float32 copy saved on the CPU and
   run on the card against the CPU within ``TF_PARITY_TOL``. (ii)
   ``bench.py``'s ``bench_serve``: LeNet saved with ``InputSpec([None,
   1, 28, 28])``, ``BatchingEngine(max_batch_size=32, max_delay_ms=0)``
   p50/p95 over 3 warm and 50 timed singles, then ``max_batch_size=64,
   max_delay_ms=3.0`` with 8 clients x 40 requests (requests/s), each
   client's rows equal to a single-request run. (iii) static mode:
   ``enable_static()``, ``Model.fit`` of LeNet at ``bench_lenet``'s
   batch of 256 with ``Adam(1e-3)``: K8 ``adamw_plan``'s launches a
   step, the loss finite and falling; ``save_inference_model`` /
   ``load_inference_model`` against the static test program. (iv) the C
   API built with ``g++`` runs one LeNet batch from C through ctypes,
   equal to the ``Predictor``'s. Phase 12's K2/K4 launches at ``[32,
   128]`` join the ``_bert`` rows; ``fused_adamw_step_lenet`` holds K8
   over LeNet's float32 list;
13. the core API (``phase_core_api``, after phase 12): GPT-2 small as
   phase 4 trains it (bf16 O2, AdamW with f32 masters, 8 x 1024) through
   ``Model.fit``, fed as a GPT-2 trainer feeds it: a ``uint16`` token file
   of ``RandomState(SEED)`` tokens read through ``np.memmap`` windows, a
   shuffled ``io.DistributedBatchSampler`` (one replica, epoch 0) and
   ``io.DataLoader`` with ``default_collate_fn``. Run A: no worker,
   ``prefetch=False``; run B: 2 worker processes and ``device_prefetch``
   (pinned copies on its own stream); in the order A, B, B, A from the
   same seeded weights: every run sees the same batches (a checksum of
   each batch's ids) and the same losses within bf16's ``TOL``, launches
   K2 = K3 = 25, K4 = K6 = 12 (tensor-core, warp-row) and K8 =
   ``adamw_plan``'s count a step, exactly, with no plain version; B's
   steps from the second on run under ``set_sync_debug_mode("error")``
   (the prefetch producer's and consumer's work in them too); ms a step
   (CUDA events), tokens/s, ``prefetch_wait_ms`` p50/p95 and the workers'
   start-up. Then gradient accumulation at full width: two
   ``train_batch(update=False)`` calls on the halves of a batch leave
   ``.grad`` equal to the sum of ``autograd.grad`` of each half (within
   bf16 ``TOL`` of each tensor's largest), with K8 0 and K6 12 a call and
   ``.grad`` untouched by ``autograd.grad``; an ``update=True`` call
   launches K8's plan and clears ``.grad``. ``Model.summary``'s
   ``total_params`` equals the parameters' count; ``flops`` of one
   ``[8, 1024]`` forward beside 6 x parameters x tokens;
   ``device.cuda.max_memory_allocated()`` equals torch's, and
   ``device.memory_summary()`` is printed; a ``utils.dlpack`` round trip
   keeps the tensor's ``data_ptr()``. Its launches join the GPT-2 train
   rows (K2/K3 f32, K4/K6 and K8 bf16);
14. the legacy static surface (``phase_legacy``, after phase 13):
   BERT-base at phase 10's configuration (bf16 O2, AdamW with f32
   masters, 32 x 128) under a 1.x head (``static.nn.fc(768, gelu)``,
   ``static.nn.layer_norm``, ``static.nn.fc(2)``) built in a
   ``fluid.program_guard`` from ``fluid.layers.data`` feeds, the loss
   ``mean(fluid.layers.softmax_with_cross_entropy)``, ``minimize`` with
   the three embedding tables in ``no_grad_set``, trained by
   ``fluid.Executor(CUDAPlace(0)).run``: the first run's loss and
   ``static.gradients``' head-weight gradient held to an eager step of
   the same weights (bf16 ``TOL``; relative ``REL_TOL``), every step's
   launches K2 = K3 = 26, K4 = K6 = 12 (tensor-core, warp-row), K8 =
   ``adamw_plan``'s count over the stepped list, no plain version, the
   tables bit-equal after; ms a step (CUDA events) and
   ``Executor.run``'s host share. An ``ExponentialMovingAverage``
   updated after each step: ``apply()`` changes the test program's
   logits, ``restore()`` gives every parameter back bit for bit.
   ``static.save``/``static.load`` and ``serialize_persistables`` into a
   freshly built program: logits bit-equal. ``fluid.io.
   save_inference_model``/``load_inference_model`` serve the batch on
   the card (K2 26, K4 12 a forward, within bf16 ``TOL``). ResNet-50
   (phase 7's configuration) exported by ``onnx.export`` on the card:
   every parameter's initializer bit-equal to the card's, the graph
   equal to the CPU export of the same weights. Its launches join the
   ``_bert`` rows; ``fused_adamw_step_bert_static`` holds K8 over the
   stepped list;
15. the exported generate artifact (``phase_serving``, after phase 14):
   GPT-2 small (bf16, full width and depth) at ``bench.py``'s
   ``bench_gpt2_decode`` configuration (8 prompts of 128 tokens, 128
   new, greedy, no EOS) exported by ``models.save_for_serving`` on the
   card (export seconds, artifact bytes, the node counts of the top
   graph and of the ``while_loop``'s body), loaded by ``jit.load`` and
   ``inference.create_predictor``: both give eager ``generate()``'s
   tokens on the card, each call launching K2 (2L + 1) x 128 = 3200
   times on the warp-row route and K4 L = 12 times (the prefill) on the
   tensor-core route, counted by the wrappers with the counts set to 0
   around it, no plain version; served and eager ms per token step in
   the same run. A beam artifact (4 beams, 32 new) gives eager beam
   search's tokens; a ``runtime_key`` artifact (sampled at temperature
   0.8, 32 new) equal tokens for equal keys and other tokens for another
   key. Rows ``fused_layer_norm_serving`` (every K2 launch of the phase,
   held at each shape) and ``flash_attention_fwd_serving`` (K4 at the
   served prefill's bf16 [8, 128, 12, 64]);
16. the rest of ``vision`` (``phase_vision``): (i) MobileNetV2 (scale
   1.0, 1000 classes, 224 x 224) under ``bench_resnet50``'s recipe
   (NHWC, bf16 O2, Momentum 0.9 with float32 masters, batch 128) through
   ``Model.fit`` from a ``vision.datasets.DatasetFolder`` of 256 x 256
   uint8 ``.npy`` images the phase writes into 8 class folders, through
   ``Compose([RandomResizedCrop(224), RandomHorizontalFlip(),
   Transpose, Normalize(ImageNet, HWC)])`` in 2 loader workers with
   prefetch: 10 steps, every loss finite, no kernel of the port and no
   plain version (none is on this path), ms a step, images/s and the
   loader's wait; (ii) each other family (VGG-16, AlexNet,
   SqueezeNet 1.1, MobileNetV1, MobileNetV3-Large, ShuffleNetV2 1.0x,
   DenseNet-121, GoogLeNet with its auxiliary heads, InceptionV3 at 299
   x 299) forward at 224 x 224: a bf16 batch of 32 timed, a float32
   batch of 4 on the card held against the same weights on the CPU
   within ``ZOO_TOL``; (iii) the seven detection ops at detection shapes
   held against the same calls on the CPU: ``yolo_box`` over
   YOLOv3-COCO's three heads (608 x 608, 80 classes, grids 19/38/76, the
   nine anchors, batch 8) and categorical ``nms`` (IoU 0.45) over each
   image's 1000 best pairs, ``yolo_loss`` forward and backward with 50
   boxes an image, ``roi_align`` (14 x 14) and ``roi_pool`` (7 x 7) at
   Faster R-CNN C4's [2, 1024, 50, 76] with 512 regions an image,
   ``psroi_pool`` at R-FCN's 7 x 7 x 21 classes, a ``deform_conv2d`` v2
   3 x 3 256 -> 256 on [2, 256, 50, 76];
17. quantization (``phase_quant``): BERT-base fine-tuned
   quantization-aware through ``Model.fit`` and served from its
   int8-weight artifact, PTQ, float32 card against CPU, the numerics
   libraries card against CPU; rows ``_qat``;
18. ``incubate`` (``phase_incubate``): (i) a 12-layer bf16
   ``FusedMultiTransformer`` at GPT-2 small width served from its
   CacheKV: the context stage over 8 x 512 tokens, 64 scalar decode
   steps, 16 slot-indexed steps (a ``[8]`` ``time_step``), each call K2
   24 times on the warp-row route and K4 never, every row within
   ``INC_DEC_TOL`` of one uncached causal forward over the 576
   positions, the caches passed in never written; a 2-layer float32 copy
   card against CPU within ``GEN_TOL``; (ii) a fused encoder at
   BERT-base width (``Embedding(30522, 768)``, 12
   ``FusedTransformerEncoderLayer`` s, a mean pool, ``Linear(768, 2)``)
   in bf16 O2, 2:4-pruned, under ``asp.decorate(LookAhead(AdamW))`` with
   ``ModelAverage`` beside it, 12 steps of ``[32, 128]``: K2 = K3 = 24,
   K4 = K6 = 12, K8 the plan's, exact, no plain call; 2:4 on every
   pruned weight's JAX view after every step; masters and parameters
   bit-equal to the sync recomputed from snapshots at steps 4, 8, 12;
   the averages bit-equal to the recomputed ones inside
   ``ModelAverage.apply()``, the live weights back bit for bit after it;
   the loss falling; (iii) ``MoELayer`` (8 experts of 3072, top-2,
   capacity factor 1.25) bf16 on ``[32, 128, 768]`` timed, float32 card
   against CPU within ``MOE_TOL`` with the routing checked (a choice made
   differently must be a near-tie, which the CPU then takes from the
   card); (iv) the graph ops over 100,000 nodes and 1,000,000 edges card
   against CPU, the causal masked softmax of bf16 ``[8, 12, 1024,
   1024]``, and ``CostModel.profile_measure`` over one more encoder step
   (``layer_norm`` and ``scaled_dot_product_attention`` seen). Rows
   ``fused_layer_norm_incubate`` (bf16 ``[4096, 768]``, with ``[8,
   768]`` and the encoder's f32 ``[4096, 768]`` held too),
   ``fused_layer_norm_bwd_incubate``, ``flash_attention_fwd_incubate``/
   ``_bwd_incubate`` (bf16 ``[32, 128, 12, 64]`` not causal),
   ``fused_adamw_step_incubate``;
8. real operands: the layer-0 operands of one real step of each path
   through kernel and plain: the engine's attention rows (float, int8
   and fp8 pools) at its widest step and at its last decode-only step
   with the most sequences, each with a "work shape" line (q blocks,
   tiles, splits, CTAs, the longest page walk, the CUDA-core kernel's
   grid), through the tensor-core route and through the CUDA-core
   kernel's C entry on the same operands, both checked and timed, and a
   second call's bits; the engine's LayerNorm input, timed; the training step's
   q/k/v/dO, LayerNorm input and output gradient and the token
   embedding's AdamW operands, each output held to its own scale (max
   |error| over max |plain|), since the gradients of a loss averaged
   over 8192 tokens lie below any fixed atol;
9. a ``{"kernels": [...]}`` line, the card's name and power limit, and
   last the ``{"ok": true, "device": ...}`` line. The training kernels'
   errors and times in it come from phase 2 at the train path's shapes
   and dtypes (flash bf16 [8, 1024, 12, 64] causal, the LayerNorm
   forward (``fused_layer_norm_train``) and backward f32 [8192, 768],
   AdamW with an f32 master and a bf16 gradient and copy), their
   launches from phase 4; the ``fused_layer_norm`` row times the
   engine's widest step's rows and counts the three engine runs; the
   ``_f32`` flash rows (the CUDA-core kernels) take phase 2's float32
   flash case and the float32 step's launches (and the forward, the
   float32 generate's and beam search's); ``fused_layer_norm_generate``,
   ``fused_layer_norm_beam`` and ``fused_layer_norm_gather`` count the K2
   launches of phase 3c's generate runs, of its beam searches and of
   phase 3d's gather engines: forward pre-hooks on the model's LayerNorm
   modules record the dtype and rows of each of those launches, every
   such shape is held against the plain version and timed, and each row
   reports the largest error and the times at its decode step's rows
   (bf16 [8, 768], [32, 768] and [8, 768]);
   ``flash_attention_fwd_generate`` (K4 at the prefill's shape, bf16 [8,
   512, 12, 64] causal) counts the unmasked generate and beam prefills.
   The float16 rows (``_f16``: flash [8, 1024, 12, 64] causal on the
   tensor-core kernels beside SDPA in float16, with the CUDA-core
   kernels' time on the same operands as ``core_ms``, the LayerNorm
   forward and
   backward at [8192, 768], AdamW with an f32 master and a float16
   gradient and copy) and ``fused_adamw_f32`` (an f32 parameter and
   gradient) come from phase 2 too; the float16 rows count phase 4c's
   launches, ``fused_adamw_f32`` phase 4d's and the float32 step's. The
   float16 LayerNorm rows count 0, with the reason: LayerNorm is on the
   AMP black list, so every AMP path runs it in float32, and the f32
   rows count phases 4, 4b, 4c and 4d; the bf16 tensor-core flash rows
   count phases 4, 4b and 4d. ``fused_adamw_step`` (phase 2's K8 over
   GPT-2 small's whole list) counts phase 4's K8 launches, which its
   dtype row counts too. Phase 3e's rows: K1 float16 and K1q
   int8/fp8 with float16 q (``ragged_paged_attention_f16``,
   ``_int8_f16``, ``_fp8_f16``) on the layer-0 operands of each float16
   engine's widest and decode-only steps, with the CUDA-core kernel on
   the same operands (``core_ms``); ``fused_layer_norm_serve_f16``
   (every float16 K2 launch of phase 3e, held at each shape, timed at
   the widest fused step's rows, the row route as ``core_ms``);
   ``flash_attention_fwd_generate_f16`` (K4 float16 at [8, 512, 12,
   64] causal, the float16 generate's prefill). Phase 3f's rows:
   ``ragged_paged_attention_spec`` (K1, the bf16 engines' launches) and
   ``ragged_paged_attention_int8_spec`` (K1q) on the layer-0 operands of
   the 2-layer-draft engines' widest verify launch (``verify_only_*``:
   their last launch in which every sequence verifies), with the
   CUDA-core kernel on the same operands; ``fused_layer_norm_spec``
   (every K2 launch of phase 3f, held at each shape, timed at the widest
   verify launch's rows).

``--profile`` adds one more batch to the bf16 and the int8 engines, to
the speculative engine with the 2-layer draft (phase 3f) and to the
dense and paged gather engines, one more tiered bf16 load run (phase
3g, with device ms a cycle), one more greedy generate, one more beam
search, two more train steps, two more BERT steps (phase 10), one
more greedy ``TransformerModel`` decode (phase 11) and two more fluid
program steps (phase 14) under the port's
``Profiler`` and prints device time by kernel (``profiler.device_op_table``) and the
device's idle share.

Times come from CUDA events around single launches, median of 20,
with the 50 MB L2 cache flushed and the device kept busy until the
launch is queued, so neither a warm cache nor the host's launch
overhead enters them. Float32 products run without TF32.
"""
from __future__ import annotations

import collections
import contextlib
import faulthandler
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

SEED = 0
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_OPS = {torch.bfloat16: 989e12,   # dense tensor-core rate
            torch.float16: 989e12,
            torch.float32: 67e12}     # outside the tensor cores
TOL = {torch.float32: (1e-4, 0.0),    # (atol, rtol)
       torch.bfloat16: (2e-2, 1e-2),  # one bf16 ulp of |y| < 4 is <= 1.6e-2
       torch.float16: (5e-3, 5e-3)}   # a few f16 ulps (P, dS rounded to f16)
# max |kernel - plain| over max |plain|, for the operands of a real step:
# f32 sums in another order; a little over two bf16 ulps of the largest value
REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 5e-3}
RPA_SRC = "paddle_tpu_torch/csrc/ragged_paged_attention.cu"
RPA_TC_SRC = "paddle_tpu_torch/csrc/ragged_paged_attention_sm90.cu"
LN_SRC = "paddle_tpu_torch/csrc/layer_norm.cu"
FA_SRC = "paddle_tpu_torch/csrc/flash_attention.cu"
FA_TC_SRC = "paddle_tpu_torch/csrc/flash_attention_sm90.cu"
ADAMW_SRC = "paddle_tpu_torch/csrc/adamw.cu"
RPA_TPU = "paddle_tpu/ops/ragged_paged_attention.py:198"
RPA_COUNTS = ("launches", "quant_launches", "tc_launches", "core_launches",
              "combine_launches")
QMAX = {torch.int8: 127.0, torch.float8_e4m3fn: 448.0}
QNAME = {torch.int8: "int8", torch.float8_e4m3fn: "fp8"}
LN_TPU = "paddle_tpu/ops/pallas_kernels.py:868"
LN_BWD_TPU = "paddle_tpu/ops/pallas_kernels.py:893"
FA_FWD_TPU = "paddle_tpu/ops/pallas_kernels.py:269"
FA_BWD_TPU = "paddle_tpu/ops/pallas_kernels.py:305"
ADAMW_TPU = "paddle_tpu/ops/pallas_kernels.py:1003"
# the kernels line's row suffix of each dtype's measurements
DTYPE_TAIL = {torch.bfloat16: "", torch.float32: "_f32",
              torch.float16: "_f16"}
# the bench_gpt2 configuration (bench.py:158)
BATCH, SEQ, LM_CHUNKS, LR, WD = 8, 1024, 8, 1e-4, 0.01
WARM_STEPS, TIMED_STEPS = 2, 8
# generate: 8 prompts x 512 tokens, 64 new; 4 left-padded rows of a
# 256-wide batch, 32 new
GEN_BATCH, GEN_PROMPT, GEN_NEW = 8, 512, 64
GEN_MASKED = (4, 256, 32)
# beam search: 4 beams, 32 new tokens, on the generate prompts
BEAM_K, BEAM_NEW = 4, 32
# float32 first-step logits, card vs CPU: the same f32 arithmetic summed
# in other orders over 2 blocks and a 768-wide head, |logits| ~ 1
GEN_TOL = 2e-4
# float32 logits over an int8 pool, card vs CPU: a K/V value that lies
# within float32 rounding of a code boundary takes the neighbouring code
# on one side, and one such code moves a logit by far more than GEN_TOL
QUANT_GEN_TOL = 5e-3
# float16 serving (phase 3e): logits of |x| < ~3 carry float16 rounding
# at every block; one float16 forward of GPT-2 small lies within 3.7e-3
# of the float32 one (measured on the CPU), so two float16 paths may
# pick either of two tokens whose logits are closer than this
F16_GEN_TOL = 1e-2
# float16 generate: 8 unmasked prompts of 512 tokens, 32 new
F16_GEN = (8, 512, 32)
# the dtype and [rows, D] of every LayerNorm a path ran, under the
# kernels line's row that counts its launches (see ln_shapes)
LN_SHAPES = collections.defaultdict(collections.Counter)
_LN_SHAPES_LOCK = threading.Lock()


def log(*a):
    print(*a, flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


class Timer:
    """Median device ms of single launches, L2 flushed before each. A
    GPU-side spin ahead of the start event lets the host enqueue the
    launch before the device reaches it, so the host's launch overhead
    stays out of the reading; ``spin`` (clock cycles, ~1 ms the 2e6 of
    the default) must outlast the host's work in ``fn``."""

    def __init__(self, device):
        self._flush = torch.empty(128 << 20, dtype=torch.uint8,
                                  device=device)

    def ms(self, fn, reps: int = 20, warmup: int = 3,
           spin: int = 2_000_000) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self._flush.zero_()
            torch.cuda._sleep(spin)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def check_close(name, got, want, dtype, tol=None):
    atol, rtol = tol or TOL[dtype]
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} values outside atol={atol} "
            f"rtol={rtol}; max abs err {err.max().item()}")
    return err.max().item() if err.numel() else 0.0


def check_scaled(name, got, want, dtype):
    """Kernel against plain relative to the values' scale: max |got -
    want| over max |want|, within REL_TOL. For the operands of a real
    step, whose gradients lie far below any fixed atol (the loss is a
    mean over 8192 tokens); a kernel that wrote zeros scores 1."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    top = want.abs().max().item()
    if not top > 0:
        raise AssertionError(f"{name}: the plain version is all zeros")
    err = (got - want).abs().max().item() / top
    if err > REL_TOL[dtype]:
        raise AssertionError(f"{name}: off by {err:.3e} of its largest "
                             f"value {top:.3e}, over {REL_TOL[dtype]}")
    return err


def sass_counts(source, ops):
    """How many SASS instructions of each of ``ops`` the built library of
    ``csrc/<source>.cu`` holds (``cuobjdump -sass``)."""
    from pathlib import Path

    from paddle_tpu_torch.ops import _build
    lib = _build.load(source)._name
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    counts = {op: sum(op in line for line in sass.splitlines())
              for op in ops}
    log(f"SASS of {Path(lib).name}: {json.dumps(counts)} instructions")
    return counts


def sass_check():
    """The proof that the tensor-core libraries run on the tensor cores
    and keep loads in flight: ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA tile
    load) in the flash library; ``HMMA`` (mma.sync) and ``LDGSTS``
    (cp.async) or ``UBLKCP`` (bulk copy) in the ragged attention library.
    Fails if a count is 0."""
    counts = sass_counts("flash_attention_sm90", ("HGMMA", "UTMALDG"))
    if not all(counts.values()):
        raise AssertionError(f"tensor-core flash library: {counts}")
    counts = sass_counts("ragged_paged_attention_sm90",
                         ("HMMA", "LDGSTS", "UBLKCP"))
    if not counts["HMMA"] or not counts["LDGSTS"] + counts["UBLKCP"]:
        raise AssertionError(f"tensor-core ragged attention library: "
                             f"{counts}")
    counts = sass_counts("adamw", ("LDG.E.128", "STG.E.128"))
    if not all(counts.values()):
        raise AssertionError(f"AdamW library without 16-byte accesses: "
                             f"{counts}")


# ---------------------------------------------------------------- bounds
def rpa_work(q, pool, meta, scales=None):
    """Bytes the attention call must move and operations it must do,
    counted from this call's data: every KV block each real sequence
    owns, read once per head (and its K and V scales for a quantized
    pool); q read and o written once."""
    blk_seq, _, _, tables, _, kv_len = (m.cpu().numpy() for m in meta)
    h, qp, dh = q.shape
    bs = pool.shape[4]
    e = q.element_size()
    seqs = sorted({int(s) for s in blk_seq if s >= 0})
    blocks = sum(-(-int(kv_len[s]) // bs) for s in seqs)
    kv_bytes = blocks * bs * h * dh * 2 * pool.element_size()
    if scales is not None:
        kv_bytes += blocks * h * 2 * scales.element_size()
    meta_bytes = sum(m.numel() * 4 for m in meta)
    nbytes = kv_bytes + 2 * qp * h * dh * e + meta_bytes
    ops = 0
    for s in seqs:
        rows = int((blk_seq == s).sum()) * 8
        cols = -(-int(kv_len[s]) // bs) * bs
        ops += 4 * rows * cols * dh * h          # q.k and p.v, 2 ops each
    return nbytes, ops


def bound(nbytes, ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phase 2
def random_ragged_batch(rng, dtype, device, L=12, H=12, Dh=64, bs=16,
                        S=8, max_ctx=1024, max_chunk=256):
    """Decode rows mixed with prompt chunks over random page tables."""
    from paddle_tpu_torch.ops.ragged_paged_attention import ragged_layout
    T = max_ctx // bs
    nb = S * T
    pool = torch.randn(L, 2, nb + 1, H, bs, Dh, device=device).to(dtype)
    tables = np.zeros((S, T), np.int32)
    free = rng.permutation(np.arange(1, nb + 1)).tolist()
    q_lens, pos0s, kv_lens = [], [], []
    for s in range(S):
        kv = int(rng.randint(1, max_ctx + 1))
        q = 1 if s % 2 == 0 else int(rng.randint(1, min(kv, max_chunk) + 1))
        nblk = -(-kv // bs)
        tables[s, :nblk] = [free.pop() for _ in range(nblk)]
        q_lens.append(q)
        pos0s.append(kv - q)
        kv_lens.append(kv)
    blk_seq, qstart, pos0, _, _ = ragged_layout(q_lens, pos0s)
    q = torch.randn(H, len(blk_seq) * 8, Dh, device=device).to(dtype)
    meta = [torch.from_numpy(np.asarray(a, np.int32)).to(device)
            for a in (blk_seq, qstart, pos0, tables, np.zeros(S, np.int32),
                      kv_lens)]
    return q, pool, int(rng.randint(0, L)), meta


def quantize_blocks(vals, storage):
    """Float blocks ``[..., bs, Dh]`` -> (codes of ``storage``, float32
    per-block max-abs scales ``[...]``), the pool's quantization rule."""
    qmax = QMAX[storage]
    sc = vals.float().abs().amax(dim=(-2, -1)) / qmax
    codes = (vals.float() / sc.clamp_min(1e-30)[..., None, None]).round() \
        .clamp(-qmax, qmax).to(storage)
    return codes, sc


def phase_quant_kernel(device, timer):
    """K1q on random ragged batches at GPT-2 widths, KV blocks of 32:
    int8 and fp8 pools, f32, bf16 and f16 q, against the plain version."""
    from paddle_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention, ragged_paged_attention_plain, rpa_route)
    rng = np.random.RandomState(SEED + 3)
    torch.manual_seed(SEED + 3)
    for storage in (torch.int8, torch.float8_e4m3fn):
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            q, vals, layer, meta = random_ragged_batch(
                rng, torch.float32, device, bs=32)
            q = q.to(dtype)
            pool, scales = quantize_blocks(vals, storage)
            del vals
            got = ragged_paged_attention(q, pool, layer, *meta,
                                         scales=scales)
            torch.cuda.synchronize()
            want = ragged_paged_attention_plain(q, pool, layer, *meta,
                                                scales=scales)
            name = f"ragged_paged_attention {QNAME[storage]} {dtype}"
            err = check_close(name, got, want, dtype)
            ms = timer.ms(lambda: ragged_paged_attention(
                q, pool, layer, *meta, scales=scales))
            plain = timer.ms(lambda: ragged_paged_attention_plain(
                q, pool, layer, *meta, scales=scales), reps=5, warmup=1)
            b_ms, b_by = bound(*rpa_work(q, pool, meta, scales), dtype)
            log(f"K1q ragged_paged_attention {QNAME[storage]} pool, "
                f"{str(dtype)[6:]} q{tuple(q.shape)} bs 32 "
                f"{rpa_route(q.dtype, pool.dtype, q.shape[2], 32)} route "
                f"max_abs_err "
                f"{err:.3e} kernel_ms {ms:.4f} plain_ms {plain:.4f} "
                f"bound_ms {b_ms:.6f} ({b_by})")
            del pool, scales


def phase_kernels(device, timer):
    from paddle_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention, ragged_paged_attention_plain, rpa_route)
    rng = np.random.RandomState(SEED)
    torch.manual_seed(SEED)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        q, pool, layer, meta = random_ragged_batch(rng, dtype, device)
        got = ragged_paged_attention(q, pool, layer, *meta)
        torch.cuda.synchronize()
        want = ragged_paged_attention_plain(q, pool, layer, *meta)
        err = check_close(f"ragged_paged_attention {dtype}", got, want, dtype)
        nbytes, ops = rpa_work(q, pool, meta)
        ms = timer.ms(lambda: ragged_paged_attention(q, pool, layer, *meta))
        plain = timer.ms(lambda: ragged_paged_attention_plain(
            q, pool, layer, *meta), reps=5, warmup=1)
        log(f"K1 ragged_paged_attention {str(dtype)[6:]} q{tuple(q.shape)} "
            f"{rpa_route(q.dtype, pool.dtype, q.shape[2], pool.shape[4])} "
            f"route "
            f"max_abs_err {err:.3e} kernel_ms {ms:.4f} plain_ms "
            f"{plain:.4f} bound_ms {bound(nbytes, ops, dtype)[0]:.4f}")
        del pool
        for rows in (8, 256, 4096):
            x = torch.randn(rows, 768, device=device).to(dtype)
            w = (1 + 0.1 * torch.randn(768, device=device)).to(dtype)
            b = (0.1 * torch.randn(768, device=device)).to(dtype)
            row = ln_fwd_case(timer, x, w, b)
            log(f"K2 fused_layer_norm {str(dtype)[6:]} [{rows}, 768] "
                f"{fmt(row)}")


# ---------------------------------------------------------------- phase 2: training kernels
def flash_work(q, causal, backward):
    """Bytes and operations one flash call on self-attention at q's shape
    must take: the forward reads q, k, v and writes o and the LSE; the
    backward reads q, k, v, o, dO and the LSE and writes dq, dk, dv. Per
    head-dim element of every (row, key) pair the mask keeps, the
    forward does 4 operations (q.k, p.v), the backward 10 (q.k again,
    dO.v, and the dV, dQ, dK products)."""
    b, s, h, d = q.shape
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    tensor, lse = q.numel() * q.element_size(), b * h * s * 4
    if backward:
        return 8 * tensor + lse, 10 * d * pairs
    return 4 * tensor + lse, 4 * d * pairs


def flash_counts():
    """(total, tensor-core, CUDA-core) launches of the flash wrappers."""
    from paddle_tpu_torch.ops import flash_attention as fa
    return [(w.launches, w.tc_launches, w.core_launches)
            for w in (fa.flash_attention_fwd, fa.flash_attention_bwd)]


def unaligned(t):
    """A contiguous copy of ``t`` whose base lies one element past a
    16-byte boundary: TMA cannot read it, so the wrappers send it to the
    CUDA-core kernels."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].view(t.shape).copy_(t)


def ln_call(fn, route, *args):
    """``fn(*args)`` for a LayerNorm wrapper, which must count the call
    once, in its total and on ``route``."""
    counts = ("launches", "warp_launches", "row_launches")
    before = [getattr(fn, c) for c in counts]
    out = fn(*args)
    torch.cuda.synchronize()
    moved = tuple(getattr(fn, c) - b for c, b in zip(counts, before))
    if moved != ((1, 1, 0) if route == "warp" else (1, 0, 1)):
        raise AssertionError(f"{fn.__name__}: counts moved {moved}, expected "
                             f"one launch on the {route} route")
    return out


def ln_fwd_case(timer, x, w, b):
    """The LayerNorm forward on the warp-row route against its plain
    version on [rows, D] operands, timed beside ``F.layer_norm``; the same
    operands at an unaligned base through the row route, checked and timed
    too (``row_ms``)."""
    from paddle_tpu_torch.ops import layer_norm as ln
    dtype = x.dtype
    rows, d = x.shape
    want = ln.layer_norm_plain(x, w, b)
    xu = unaligned(x)
    err = {route: check_close(
        f"fused_layer_norm {route} route {dtype} [{rows}, {d}]",
        ln_call(ln.fused_layer_norm, route, xr, w, b), want, dtype)
        for route, xr in (("warp", x), ("row", xu))}
    e = x.element_size()
    row = {"max_abs_err": err["warp"], "row_err": err["row"],
           "ms": timer.ms(lambda: ln.fused_layer_norm(x, w, b)),
           "row_ms": timer.ms(lambda: ln.fused_layer_norm(xu, w, b)),
           "plain_ms": timer.ms(lambda: ln.layer_norm_plain(x, w, b)),
           "library_ms": timer.ms(lambda: torch.nn.functional.layer_norm(
               x, (d,), w, b, 1e-5))}
    # x read and y written, w and b read
    row["bound_ms"], row["bound_by"] = bound(
        2 * rows * d * e + 2 * d * e, 7 * rows * d, dtype)
    return row


@contextlib.contextmanager
def ln_shapes(model, row):
    """Record under ``LN_SHAPES[row]`` the dtype and [rows, D] of every
    LayerNorm that ``model`` (on the card) runs inside the block, each one
    K2 launch, through forward pre-hooks on its LayerNorm modules."""
    from paddle_tpu_torch.nn.layer.norm import LayerNorm
    seen = LN_SHAPES[row]

    def hook(_module, args):
        x = args[0]
        with _LN_SHAPES_LOCK:      # two engines' threads share a model
            seen[(x.dtype, x.numel() // x.shape[-1], x.shape[-1])] += 1

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, LayerNorm)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def ln_shape_row(timer, name, launches, main):
    """The kernels line's LayerNorm-forward row ``name``: K2 against its
    plain version (both routes, timed) at every dtype and [rows, D] that
    the row's ``launches`` ran at (``LN_SHAPES[name]``, which must count
    them all); the row reports the largest warp-route error of any shape
    (the route every path launch took) and the times of ``main``, a
    (dtype, rows, D) key."""
    shapes = LN_SHAPES[name]
    if sum(shapes.values()) != launches or main not in shapes:
        raise AssertionError(f"{name}: {launches} launches, LayerNorm "
                             f"calls by shape {dict(shapes)}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)

    def randn(*shape, dtype, scale=1.0):
        return (scale * torch.randn(*shape, device="cuda", generator=gen)
                ).to(dtype)

    rows, err = {}, 0.0
    for dtype, n, d in sorted(shapes, key=lambda k: (str(k[0]), k[1])):
        row = ln_fwd_case(timer, randn(n, d, dtype=dtype),
                          1 + randn(d, dtype=dtype, scale=0.1),
                          randn(d, dtype=dtype, scale=0.1))
        rows[(dtype, n, d)] = row
        err = max(err, row["max_abs_err"])
        log(f"K2 {name}: {str(dtype)[6:]} [{n}, {d}], "
            f"{shapes[(dtype, n, d)]} launches {fmt(row)}")
    return dict(rows[main], max_abs_err=err)


@contextlib.contextmanager
def ln_launch_shapes():
    """The dtype and [rows, D] of every LayerNorm kernel call while the
    block runs, without module hooks (a replayed or exported program runs
    none): the forward's at the custom op ``paddle_tpu_torch::
    fused_layer_norm``, which every eager, replayed and exported forward
    reaches, through a dispatch mode; the backward's at the autograd
    function's ``backward``. Yields the two counters (forward,
    backward)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from paddle_tpu_torch.ops import layer_norm as ln
    fwd, bwd = collections.Counter(), collections.Counter()
    op = torch.ops.paddle_tpu_torch.fused_layer_norm.default

    def key(x):
        return (x.dtype, x.numel() // x.shape[-1], x.shape[-1])

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func == op:
                fwd[key(args[0])] += 1
            return func(*args, **(kwargs or {}))

    orig = ln._LayerNorm.backward

    def backward(ctx, grad):
        bwd[key(grad)] += 1
        return orig(ctx, grad)

    ln._LayerNorm.backward = staticmethod(backward)
    try:
        with Mode():
            yield fwd, bwd
    finally:
        ln._LayerNorm.backward = staticmethod(orig)


def ln_shape_checks(timer, what, fwd, bwd):
    """K2 and K3 against their plain versions (both routes, as
    :func:`ln_fwd_case` and :func:`ln_bwd_case` check them) at every
    dtype and [rows, D] of ``fwd`` and ``bwd`` (from
    :func:`ln_launch_shapes`): ``{"fused_layer_norm": {shape: max abs
    err}, "fused_layer_norm_bwd": {...}}``, shapes as "float32 [32,
    768]"."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 79)

    def randn(*shape, dtype, scale=1.0):
        return (scale * torch.randn(*shape, device="cuda", generator=gen)
                ).to(dtype)

    out = {}
    for name, shapes in (("fused_layer_norm", fwd),
                         ("fused_layer_norm_bwd", bwd)):
        out[name] = {}
        for dtype, n, d in sorted(shapes, key=lambda k: (str(k[0]), k[1])):
            x, w = randn(n, d, dtype=dtype), 1 + randn(d, dtype=dtype,
                                                       scale=0.1)
            if name == "fused_layer_norm":
                row = ln_fwd_case(timer, x, w, randn(d, dtype=dtype,
                                                     scale=0.1))
            else:
                row = ln_bwd_case(timer, x, w, randn(n, d, dtype=dtype))
            shape = f"{str(dtype)[6:]} [{n}, {d}]"
            out[name][shape] = row["max_abs_err"]
            log(f"{what}: {name} {shape} ({shapes[(dtype, n, d)]} "
                f"recorded) "
                f"{fmt(row)}")
    return out


def ln_bwd_check(x, w, g, route, want):
    """The LayerNorm backward on ``route`` against ``want`` (the plain
    version's dx, dw, db); a second call must give the same bits. dw and
    db sum over every row: they take rtol 1e-5 beside the atol."""
    from paddle_tpu_torch.ops import layer_norm as ln
    dtype = x.dtype
    got = ln_call(ln.fused_layer_norm_bwd, route, x, w, g)
    again = ln.fused_layer_norm_bwd(x, w, g)
    torch.cuda.synchronize()
    sums = (TOL[dtype][0], max(TOL[dtype][1], 1e-5))
    err = 0.0
    for n, a, a2, ref in zip(("dx", "dw", "db"), got, again, want):
        if not torch.equal(a, a2):
            raise AssertionError(f"LayerNorm backward {route} route {n}: "
                                 f"another call, other bits")
        err = max(err, check_close(
            f"LayerNorm backward {route} route {dtype} {tuple(x.shape)} {n}",
            a, ref, dtype, None if n == "dx" else sums))
    return err


def phase_ln_routes(device):
    """Both routes of both LayerNorm kernels against their plain versions
    at widths on both sides of the route boundary (1, GPT-2's 768, 1024
    and 1600, 2049, and the widest, 16384) and 1, 7, 300 and 8192 rows, in
    float32 and bfloat16: aligned operands take the warp-row route where
    it applies, unaligned ones the row route; dw/db repeat their bits."""
    from paddle_tpu_torch.ops import layer_norm as ln
    gen = torch.Generator(device=device).manual_seed(SEED + 5)

    def randn(*shape, dtype, scale=1.0):
        return (scale * torch.randn(*shape, device=device,
                                    generator=gen)).to(dtype)

    worst, cases = {}, 0
    for d in (1, 768, 1024, 1600, 2049, 16384):
        for rows in (1, 7, 300, 8192):
            for dtype in (torch.float32, torch.bfloat16):
                x, g = (randn(rows, d, dtype=dtype) for _ in range(2))
                w = (1 + randn(d, dtype=torch.float32, scale=0.1)).to(dtype)
                b = randn(d, dtype=dtype, scale=0.1)
                y_want = ln.layer_norm_plain(x, w, b)
                bwd_want = ln.layer_norm_bwd_plain(x, w, g)
                fits = d <= ln.WARP_MAX_D and d * x.element_size() % 16 == 0
                for xs, gs, route in (
                        (x, g, "warp" if fits else "row"),
                        (unaligned(x), unaligned(g), "row")):
                    if ln.ln_route(xs, w, b) != route:
                        raise AssertionError(f"LayerNorm {dtype} D={d}: "
                                             f"route {ln.ln_route(xs, w, b)}"
                                             f", expected {route}")
                    err = check_close(
                        f"fused_layer_norm {route} route {dtype} "
                        f"[{rows}, {d}]",
                        ln_call(ln.fused_layer_norm, route, xs, w, b),
                        y_want, dtype)
                    err = max(err, ln_bwd_check(xs, w, gs, route, bwd_want))
                    key = f"{route} {str(dtype)[6:]}"
                    worst[key] = max(worst.get(key, 0.0), err)
                    cases += 1
                del x, g, y_want, bwd_want
    log(f"LayerNorm routes vs plain: {cases} cases (forward and backward "
        f"each), D 1/768/1024/1600/2049/16384 x rows 1/7/300/8192 x "
        f"f32/bf16, aligned and unaligned; dw/db repeat their bits; max "
        f"abs err by route: " + json.dumps(worst))


def flash_check(q, k, v, do, causal, route):
    """Forward and backward kernels against their plain versions on (q, k,
    v, dO); each wrapper must count the call once, on ``route``. Returns
    the forward's and the backward's max |error| and the forward's (o,
    lse)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    dtype = q.dtype
    before = flash_counts()
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    moved = [tuple(a - b for a, b in zip(x, y))
             for x, y in zip(flash_counts(), before)]
    step = (1, 1, 0) if route == "tc" else (1, 0, 1)
    if moved != [step, step]:
        raise AssertionError(f"flash {dtype} {tuple(q.shape)}: counts moved "
                             f"{moved}, expected {step} on the {route} route")
    want_o, want_lse = fa.flash_attention_fwd_plain(q, k, v, causal)
    err_f = max(check_close(f"flash {route} forward o", o, want_o, dtype),
                check_close(f"flash {route} forward lse", lse, want_lse,
                            torch.float32))
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    err_b = max(check_close(f"flash {route} backward d{n}", g, w, dtype)
                for n, g, w in zip("qkv", grads, want))
    return err_f, err_b, o, lse, grads


def flash_case(timer, q, k, v, do, causal=True, route="tc", core=False):
    """Forward and backward kernels of ``route`` against their plain
    versions on (q, k, v, dO), timed beside the plain versions and beside
    ``scaled_dot_product_attention`` and its autograd backward (on the
    tensor-core route a second call must give the same bits); with
    ``core``, the same operands at an unaligned base through the CUDA-core
    kernels too, checked and timed (``core_ms``). Returns the forward's
    and the backward's measurements."""
    from paddle_tpu_torch.ops import flash_attention as fa
    dtype = q.dtype
    err_f, err_b, o, lse, grads = flash_check(q, k, v, do, causal, route)
    if route == "tc":      # no output is shared between CTAs
        again = (*fa.flash_attention_fwd(q, k, v, causal),
                 *fa.flash_attention_bwd(q, k, v, o, lse, do, causal))
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip((o, lse, *grads),
                                                     again)):
            raise AssertionError(f"flash tc {dtype} {tuple(q.shape)}: a "
                                 f"second call gave other bits")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    qg, kg, vg = (t.requires_grad_() for t in (qt, kt, vt))
    out = sdpa(qg, kg, vg, is_causal=causal)
    fwd = {"max_abs_err": err_f,
           "ms": timer.ms(lambda: fa.flash_attention_fwd(q, k, v, causal)),
           "plain_ms": timer.ms(lambda: fa.flash_attention_fwd_plain(
               q, k, v, causal), reps=5, warmup=1),
           "library_ms": timer.ms(lambda: sdpa(qt.detach(), kt.detach(),
                                               vt.detach(),
                                               is_causal=causal))}
    bwd = {"max_abs_err": err_b,
           "ms": timer.ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse,
                                                         do, causal)),
           "plain_ms": timer.ms(lambda: fa.flash_attention_bwd_plain(
               q, k, v, o, lse, do, causal), reps=5, warmup=1),
           "library_ms": timer.ms(lambda: torch.autograd.grad(
               out, (qg, kg, vg), dot, retain_graph=True))}
    del out, qt, kt, vt, dot, qg, kg, vg
    if core:
        qc, kc, vc, doc = (unaligned(t) for t in (q, k, v, do))
        fwd["core_err"], bwd["core_err"], oc, lc, _ = flash_check(
            qc, kc, vc, doc, causal, "cuda_core")
        fwd["core_ms"] = timer.ms(lambda: fa.flash_attention_fwd(
            qc, kc, vc, causal))
        bwd["core_ms"] = timer.ms(lambda: fa.flash_attention_bwd(
            qc, kc, vc, oc, lc, doc, causal))
    for row, backward in ((fwd, False), (bwd, True)):
        row["bound_ms"], row["bound_by"] = bound(
            *flash_work(q, causal, backward), dtype)
    return fwd, bwd


def ln_bwd_case(timer, x, w, g):
    """The LayerNorm backward kernel on the warp-row route against its
    plain version on [rows, D] operands, timed beside aten's
    ``native_layer_norm_backward``; the same operands at an unaligned base
    through the row route, checked and timed too (``row_ms``)."""
    from paddle_tpu_torch.ops import layer_norm as ln
    dtype = x.dtype
    rows, d = x.shape
    want = ln.layer_norm_bwd_plain(x, w, g)
    xu, gu = unaligned(x), unaligned(g)
    err = ln_bwd_check(x, w, g, "warp", want)
    row_err = ln_bwd_check(xu, w, gu, "row", want)
    b = torch.zeros_like(w)
    _, mean, rstd = torch.ops.aten.native_layer_norm(x, [d], w, b, 1e-5)
    e = x.element_size()
    row = {"max_abs_err": err, "row_err": row_err,
           "ms": timer.ms(lambda: ln.fused_layer_norm_bwd(x, w, g)),
           "row_ms": timer.ms(lambda: ln.fused_layer_norm_bwd(xu, w, gu)),
           "plain_ms": timer.ms(lambda: ln.layer_norm_bwd_plain(x, w, g)),
           "library_ms": timer.ms(
               lambda: torch.ops.aten.native_layer_norm_backward(
                   g, x, [d], mean, rstd, w, b, [True, True, True]))}
    # x and g read, dx written; w read, dw and db written
    row["bound_ms"], row["bound_by"] = bound(
        (3 * rows * d + 3 * d) * e, 15 * rows * d, dtype)
    return row


def adamw_case(timer, p, g, m, v, low, lr, beta1, beta2, eps, wd, step):
    """The AdamW kernel against its plain version on copies of one
    parameter's operands, timed beside ``torch.optim.AdamW(fused=True)``
    on a float32 copy. The same float32 arithmetic with fused
    multiply-adds: atol 1e-6 + rtol 1e-6."""
    from paddle_tpu_torch.ops.fused_adamw import adamw_plain_, fused_adamw_
    hyper = (lr, beta1, beta2, eps, wd, step)
    ops = [t.clone() for t in (p, m, v)]
    ref = [t.clone() for t in (p, m, v)]
    low_k = None if low is None else low.clone()
    low_r = None if low is None else low.clone()
    fused_adamw_(ops[0], g, ops[1], ops[2], *hyper, low=low_k)
    torch.cuda.synchronize()
    adamw_plain_(ref[0], g, ref[1], ref[2], *hyper, low=low_r)
    exact = (1e-6, 1e-6)
    err = max(check_close(f"AdamW {n}", a, b, a.dtype,
                          exact if a.dtype == torch.float32 else None)
              for n, a, b in zip(("p", "m", "v"), ops, ref))
    if low is not None:
        err = max(err, check_close(f"AdamW {low.dtype} copy", low_k, low_r,
                                   low.dtype))
    lib_p = torch.nn.Parameter(p.detach().float().clone())
    lib_p.grad = g.float()
    lib = torch.optim.AdamW([lib_p], lr=lr, betas=(beta1, beta2), eps=eps,
                            weight_decay=wd, fused=True)
    n = p.numel()
    row = {"max_abs_err": err,
           "ms": timer.ms(lambda: fused_adamw_(ops[0], g, ops[1], ops[2],
                                               *hyper, low=low_k)),
           "plain_ms": timer.ms(lambda: adamw_plain_(
               ref[0], g, ref[1], ref[2], *hyper, low=low_r)),
           "library_ms": timer.ms(lib.step)}
    # p, m, v read and written, g read, the 16-bit copy written
    nbytes = n * (2 * p.element_size() + g.element_size() + 16
                  + (2 if low is not None else 0))
    row["bound_ms"], row["bound_by"] = bound(nbytes, 16 * n, torch.float32)
    return row


# the five dtype combinations K8 takes: (p, g, copy)
ADAMW_KINDS = ((torch.float32, torch.float32, None),
               (torch.float32, torch.bfloat16, torch.bfloat16),
               (torch.float32, torch.float16, torch.float16),
               (torch.bfloat16, torch.bfloat16, None),
               (torch.float16, torch.float16, None))


def adamw_edge_case(device):
    """K8's group kernel against its plain version in one call over the
    edge list: each dtype combination at sizes 0, 1, 3, 5, 4097 and 3
    chunks + 7, and a 4097-element view at an offset of one element (no
    operand aligned: the scalar path); then 40 more 5-element float32
    tensors, past one launch's tensor limit; each tensor with its own
    lr, decay and step. Every element within tolerance, the launches and
    tensors counted equal to the plan's. Returns the largest error."""
    from paddle_tpu_torch.ops import fused_adamw as fad
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    lists = [[] for _ in range(8)]

    def add(n, p_dt, g_dt, low_dt, offset=0):
        def make(dt, scale, positive=False):
            x = scale * torch.randn(n + offset, device=device, generator=gen)
            return (x.abs() if positive else x).to(dt)[offset:]
        i = len(lists[0])
        for out, x in zip(lists, (
                make(p_dt, 1.0), make(g_dt, 1.0), make(torch.float32, 0.1),
                make(torch.float32, 0.1, positive=True),
                None if low_dt is None else make(low_dt, 1.0),
                1e-3 * (1 + i % 3), 0.01 * (i % 2), 1 + i % 4)):
            out.append(x)

    for kind in ADAMW_KINDS:
        for n in (0, 1, 3, 5, 4097, 3 * fad.ADAMW_CHUNK + 7):
            add(n, *kind)
        add(4097, *kind, offset=1)
    for _ in range(40):
        add(5, torch.float32, torch.float32, None)
    ps, gs, ms, vs, lows, lrs, wds, steps = lists
    ref = [[None if t is None else t.clone() for t in ts]
           for ts in (ps, ms, vs, lows)]
    plan = fad.adamw_plan([p.numel() for p in ps], [
        fad._check(*o) for o in zip(ps, gs, ms, vs, lows)])
    before = (fad.fused_adamw_.launches, fad.fused_adamw_.tensors)
    fad.fused_adamw_group_(ps, gs, ms, vs, lows, lrs, wds, steps, 0.9, 0.999,
                           1e-8)
    torch.cuda.synchronize()
    counted = (fad.fused_adamw_.launches - before[0],
               fad.fused_adamw_.tensors - before[1])
    if counted != (len(plan), len(ps)):
        raise AssertionError(f"AdamW edge list: {counted} launches and "
                             f"tensors counted, the plan has "
                             f"{(len(plan), len(ps))}")
    fad.adamw_group_plain_(ref[0], gs, ref[1], ref[2], ref[3], lrs, wds,
                           steps, 0.9, 0.999, 1e-8)
    exact = (1e-6, 1e-6)
    err = 0.0
    for i, p in enumerate(ps):
        what = f"AdamW edge tensor {i} ({p.numel()} {p.dtype})"
        for n, a, b in zip(("p", "m", "v"), (p, ms[i], vs[i]),
                           (ref[0][i], ref[1][i], ref[2][i])):
            err = max(err, check_close(
                f"{what} {n}", a, b, a.dtype,
                exact if a.dtype == torch.float32 else None))
        if lows[i] is not None:
            check_close(f"{what} copy", lows[i], p.to(lows[i].dtype),
                        lows[i].dtype, (0.0, 0.0))
    log(f"K8 group edge list: {len(ps)} tensors (sizes 0, 1, 3, 5, 4097, "
        f"{3 * fad.ADAMW_CHUNK + 7} and an offset-1 view of 4097 in each of "
        f"{len(ADAMW_KINDS)} dtype combinations, 40 x 5 float32) in "
        f"{len(plan)} launches, max_abs_err {err:.3e} against the plain "
        f"version; every copy the rounded parameter exactly")
    return err


def adamw_step_case(timer, device, shapes, half, lr, wd):
    """K8 over a whole parameter list as ``AdamW.step()`` hands it to the
    group wrapper: ``half`` parameters on float32 masters with ``half``
    gradients and copies (O2), or, ``half`` None, float32 parameters and
    gradients. The row: one grouped update's device ms, its launches
    (equal to the plan's), the host wall of ``opt.step()`` without a
    sync (median of 20), the plain version's ms and error,
    ``torch.optim.AdamW(fused=True)`` over float32 copies of the list,
    and the bound: the list's bytes over 3.35 TB/s."""
    import paddle_tpu_torch.optimizer.optimizer as opt_module
    from paddle_tpu_torch.ops import fused_adamw as fad
    from paddle_tpu_torch.optimizer import AdamW
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    dtype = half or torch.float32

    def randn(shape, scale):
        return (scale * torch.randn(shape, device=device,
                                    generator=gen)).to(dtype)

    params = [torch.nn.Parameter(randn(s, 0.02)) for s in shapes]
    for p in params:
        p.grad = randn(p.shape, 1e-3)
    opt = AdamW(lr, parameters=params, weight_decay=wd,
                multi_precision=half is not None)
    got = []
    orig = opt_module.fused_adamw_group_

    def spy(*a):
        got.append(a)
        return orig(*a)

    opt_module.fused_adamw_group_ = spy
    try:
        opt.step()                 # slots, masters and the plan
    finally:
        opt_module.fused_adamw_group_ = orig
    (ps, gs, ms, vs, lows, *hyper), = got
    plan = fad.adamw_plan([p.numel() for p in ps], [
        fad._check(*o) for o in zip(ps, gs, ms, vs, lows)])
    torch.cuda.synchronize()
    before = fad.fused_adamw_.launches
    walls = []
    for _ in range(20):
        t0 = time.perf_counter()
        opt.step()
        walls.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    per_step = (fad.fused_adamw_.launches - before) / 20
    if per_step != len(plan):
        raise AssertionError(f"AdamW step: {per_step} launches a step, the "
                             f"plan has {len(plan)}")
    kern = [[None if t is None else t.clone() for t in ts]
            for ts in (ps, ms, vs, lows)]
    ref = [[None if t is None else t.clone() for t in ts]
           for ts in (ps, ms, vs, lows)]

    def kernel():
        fad.fused_adamw_group_(kern[0], gs, kern[1], kern[2], kern[3],
                               *hyper)

    def plain():
        fad.adamw_group_plain_(ref[0], gs, ref[1], ref[2], ref[3], *hyper)

    kernel()
    torch.cuda.synchronize()
    plain()
    exact = (1e-6, 1e-6)
    err = max(check_close(f"AdamW step {n}", a, b, a.dtype,
                          exact if a.dtype == torch.float32 else None)
              for k, r, n in zip(kern, ref, ("p", "m", "v", "copy"))
              for a, b in zip(k, r) if a is not None)
    lib_params = [torch.nn.Parameter(p.detach().float().clone())
                  for p in ps]
    for lp, g in zip(lib_params, gs):
        lp.grad = g.float()
    lrs, wds, _, b1, b2, eps = hyper
    lib = torch.optim.AdamW(lib_params, lr=lrs[0], betas=(b1, b2), eps=eps,
                            weight_decay=wds[0], fused=True)
    # the wrapper's host work over a few hundred tensors (the signature
    # of every operand) takes about a millisecond: a 20 ms spin keeps it
    # and the library's out of the device time
    spin = 40_000_000
    row = {"max_abs_err": err, "ms": timer.ms(kernel, spin=spin),
           "plain_ms": timer.ms(plain, spin=spin),
           "library_ms": timer.ms(lib.step, spin=spin),
           "launches_per_step": len(plan), "tensors_per_step": len(ps),
           "host_us": statistics.median(walls) * 1e6}
    # p, m, v read and written, g read, the 16-bit copy written
    nbytes = sum(p.numel() * (2 * p.element_size() + g.element_size() + 16
                              + (0 if low is None else low.element_size()))
                 for p, g, low in zip(ps, gs, lows))
    numel = sum(p.numel() for p in ps)
    row["bound_ms"], row["bound_by"] = bound(nbytes, 16 * numel,
                                             torch.float32)
    return row


def gpt2_small_shapes():
    """GPT-2 small's parameter shapes in ``parameters()`` order, from a
    model built on the meta device (no memory, no initialisation)."""
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    with torch.device("meta"):
        net = GPTForPretraining(GPTConfig.gpt2_small(),
                                lm_loss_chunks=LM_CHUNKS)
    return [tuple(p.shape) for p in net.parameters()]


def fmt(row):
    line = (f"max_abs_err {row['max_abs_err']:.3e} kernel_ms "
            f"{row['ms']:.5f} plain_ms {row['plain_ms']:.4f} library_ms "
            f"{row['library_ms']:.5f} bound_ms {row['bound_ms']:.5f} "
            f"({row['bound_by']})")
    if "core_ms" in row:
        line += (f"; CUDA-core route on the same operands: max_abs_err "
                 f"{row['core_err']:.3e} kernel_ms {row['core_ms']:.5f}")
    if "row_ms" in row:
        line += (f"; row route (the CTA-per-row kernels) on the same "
                 f"operands: max_abs_err {row['row_err']:.3e} kernel_ms "
                 f"{row['row_ms']:.5f}")
    if "host_us" in row:
        line += (f"; {row['launches_per_step']} launches over "
                 f"{row['tensors_per_step']} tensors, opt.step() host "
                 f"{row['host_us']:.1f} us")
    return line


def phase_train_kernels(device, timer):
    gen = torch.Generator(device=device).manual_seed(SEED)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (scale * torch.randn(*shape, device=device,
                                    generator=gen)).to(dtype)

    main = {}          # the train path's shapes and dtypes, for the kernels line
    for dtype, seq, d, route in (
            (torch.float32, SEQ, 64, "cuda_core"),
            (torch.float32, 1000, 64, "cuda_core"),
            (torch.bfloat16, SEQ, 64, "tc"),
            (torch.bfloat16, 1000, 64, "tc"),
            (torch.bfloat16, SEQ, 128, "tc"),
            (torch.float16, SEQ, 64, "tc"),
            (torch.float16, 1000, 64, "tc")):
        q, k, v, do = (randn(BATCH, seq, 12, d, dtype=dtype)
                       for _ in range(4))
        fwd, bwd = flash_case(timer, q, k, v, do, route=route,
                              core=route == "tc" and d == 64)
        if seq == SEQ and d == 64:
            tail = DTYPE_TAIL[dtype]
            main["flash_attention_fwd" + tail] = fwd
            main["flash_attention_bwd" + tail] = bwd
        shape = f"{str(dtype)[6:]} [{BATCH}, {seq}, 12, {d}] causal"
        log(f"K4/K5 flash_attention_fwd {route} route {shape} {fmt(fwd)}")
        log(f"K6/K7 flash_attention_bwd {route} route {shape} {fmt(bwd)}")
        del q, k, v, do
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        name = str(dtype)[6:]
        x = randn(BATCH * SEQ, 768, dtype=dtype)
        w = (1 + randn(768, scale=0.1)).to(dtype)
        g = randn(BATCH * SEQ, 768, dtype=dtype)
        row = ln_bwd_case(timer, x, w, g)
        log(f"K3 fused_layer_norm_bwd {name} [{BATCH * SEQ}, 768] "
            f"{fmt(row)}")
        fwd = ln_fwd_case(timer, x, w, randn(768, dtype=dtype, scale=0.1))
        log(f"K2 fused_layer_norm {name} [{BATCH * SEQ}, 768] {fmt(fwd)}")
        if dtype == torch.float32:           # AMP runs LayerNorm in f32
            main["fused_layer_norm_bwd"] = row
            main["fused_layer_norm_train"] = fwd
        if dtype == torch.float16:
            main["fused_layer_norm_bwd_f16"] = row
            main["fused_layer_norm_f16"] = fwd
    n = (50304, 768)
    # (grad and copy dtype or None): the O2 bf16 master, the O1 / float32
    # parameter, the O2 float16 master
    for half in (torch.bfloat16, None, torch.float16):
        p = randn(*n, scale=0.02)
        g = randn(*n, dtype=half or torch.float32, scale=1e-3)
        m, v = randn(*n, scale=1e-4), randn(*n, scale=1e-4).square()
        low = None if half is None else torch.empty(n, dtype=half,
                                                    device=device)
        row = adamw_case(timer, p, g, m, v, low, LR, 0.9, 0.999, 1e-8, WD,
                         3)
        what = "f32" if half is None else \
            f"f32 master, {str(half)[6:]} grad and copy"
        log(f"K8 fused_adamw {what} [50304, 768] {fmt(row)}")
        main["fused_adamw" + DTYPE_TAIL[half or torch.float32]] = row
    adamw_edge_case(device)
    row = adamw_step_case(timer, device, gpt2_small_shapes(), torch.bfloat16,
                          LR, WD)
    log(f"K8 fused_adamw_step: GPT-2 small's parameter list, bf16 O2 (f32 "
        f"masters, bf16 grads and copies) {fmt(row)}")
    main["fused_adamw_step"] = row
    return main


# ---------------------------------------------------------------- phase 3
def reference_check(device):
    """Float32 engine greedy tokens == greedy decoding through the
    model's full forward, at GPT-2 width with the depth cut to 2."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.serving import GenerationEngine
    seed(SEED + 1)
    cfg = GPTConfig.gpt2_small()
    cfg.num_hidden_layers = 2
    model = GPTForPretraining(cfg).to(device)
    rng = np.random.RandomState(SEED + 1)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in (40, 7)]
    with GenerationEngine(model, kv_layout="paged", attention="fused",
                          num_slots=2, block_size=16, prefill_budget=32,
                          device=device) as eng:
        outs = [h.result(timeout=300) for h in
                [eng.submit(p, max_new_tokens=8) for p in prompts]]
    with torch.no_grad():
        for p, out in zip(prompts, outs):
            ids = torch.from_numpy(p).long().to(device)[None]
            for _ in range(8):
                nxt = model(ids)[0, -1].argmax()
                ids = torch.cat([ids, nxt.view(1, 1)], dim=1)
            if not np.array_equal(ids[0].cpu().numpy(), out):
                raise AssertionError(
                    f"engine tokens {out[len(p):]} != full-forward greedy "
                    f"{ids[0, len(p):].cpu().numpy()}")
    log("reference check: float32 engine greedy == full-forward greedy "
        "(2 requests x 8 tokens, GPT-2 width, 2 layers)")


def profile_engine(eng, rng, vocab):
    """Where the engine's device time goes: one more batch of 8
    requests (256-token prompts, 32 new tokens each) under the port's
    profiler; prints device time by kernel and the idle share."""
    prompts = [rng.randint(0, vocab, 256) for _ in range(8)]
    steps0 = eng.stats()["steps"]
    with device_profile() as prof:
        t0 = time.perf_counter()
        for h in [eng.submit(p, max_new_tokens=32) for p in prompts]:
            h.result(timeout=600)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_time_report("engine", prof, wall_ms, eng.stats()["steps"] - steps0)


@contextlib.contextmanager
def device_profile():
    """The port's ``Profiler`` with the CPU and GPU targets over the
    block, its Kineto trace written into a fresh directory under
    ``TRACE_ROOT`` (the port's ``device_trace`` reads it back)."""
    import tempfile
    from paddle_tpu_torch import profiler
    prof = profiler.Profiler(
        targets=[profiler.ProfilerTarget.CPU, profiler.ProfilerTarget.GPU],
        trace_dir=tempfile.mkdtemp(dir=TRACE_ROOT), use_native=False)
    with prof:
        yield prof


def device_time_report(what, prof, wall_ms, steps):
    """Device time by kernel over a profiled window (the 15 largest and
    every hand-written kernel), and the idle share, from the port's
    ``device_op_table`` of the window's trace. Returns (busy ms, idle
    share)."""
    kernels = [(r["total_us"] / 1e3, r["calls"], r["name"])
               for r in prof.device_op_table()]
    busy = sum(k[0] for k in kernels)
    log(f"profile {what}: {steps} steps in {wall_ms:.3f} ms wall, device "
        f"busy {busy:.3f} ms, idle share {1 - busy / wall_ms:.4f}, "
        f"{busy / steps:.4f} device ms per step")
    ranked = sorted(kernels, reverse=True)
    # the top 15, then the port's own kernels (csrc/*.cu keeps them in an
    # anonymous namespace at the top level) below them
    shown = ranked[:15] + [k for k in ranked[15:]
                           if k[2].startswith("void (anonymous namespace)::")]
    for ms, n, name in shown:
        log(f"  {ms:10.3f} ms {ms / busy:7.2%} {n:7d} calls "
            f"{ms / steps:8.4f} ms/step  {name[:90]}")
    return busy, 1 - busy / wall_ms


def serve_mix(model, prompts, max_new, profile=False, rng=None,
              ln_row=None, **kw):
    """Serve ``prompts`` at once through a fused paged engine built with
    ``kw``, after one short warm-up request, with every serving kernel's
    count set to 0 just before and read just after; every attention
    launch must take the tensor-core route. With ``ln_row``, the shape of
    every LayerNorm launch of the counted window is recorded under that
    kernels-line row (the draft model's too). Keeps the layer-0 attention
    operands of the widest step and of the last of the decode-only steps
    (one row a sequence) with the most sequences, and on a speculative
    engine (``spec_draft`` in ``kw``) those of the widest verify launch
    and of the last verify-only launch (every sequence speculating) with
    the most sequences.
    A speculative engine's draft calls are counted in the window (draft
    steps, draft prefills), and its draft and verify calls run under
    ``torch.cuda.set_sync_debug_mode("error")``: a host sync in them
    fails the cycle. Returns (outputs, stats, launches, steps, wall
    seconds, captured operands: ``{"wide": ..., "decode": ...,
    "verify": ..., "verify_only": ..., "draft": counts}``)."""
    import paddle_tpu_torch.models.generation as gen_mod
    from paddle_tpu_torch.ops.layer_norm import fused_layer_norm
    from paddle_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention)
    from paddle_tpu_torch.serving import GenerationEngine
    vocab = model.gpt.cfg.vocab_size
    eng = GenerationEngine(model, kv_layout="paged", attention="fused",
                           num_slots=8, prefill_budget=256, seed=SEED,
                           device=next(model.parameters()).device, **kw)
    warm = np.random.RandomState(SEED + 9)
    eng.submit(warm.randint(0, vocab, 24), max_new_tokens=4).result(
        timeout=300)
    settle(eng)
    captured = {"wide": {}, "decode": {}, "verify": {}, "verify_only": {}}
    # the step being run, from its host operands (no device sync):
    # decode-only when every present sequence feeds one row
    # (kv_len - pos0 == 1), and how many sequences it has; a verify
    # launch when it has speculating slots
    step = {}
    operands = eng._ragged_operands

    def spy(*a, **k):
        out = operands(*a, **k)
        blk_seq, _, pos0, _, _, kv_len = out[2][4:10]
        seqs = {int(x) for x in blk_seq if x >= 0}
        step.update(seqs=len(seqs), decode=all(
            int(kv_len[x]) - int(pos0[x]) == 1 for x in seqs),
            verify=bool(out[3].any()),
            verify_only=bool(seqs) and all(out[3][x] > 0 for x in seqs))
        return out

    def keep(slot, q, pool, meta, scales, **info):
        slot.update(q=q.clone(), pool=pool[:1].clone(),
                    scales=None if scales is None else scales[:1].clone(),
                    meta=[m.clone() for m in meta], **info)

    def capture(q, pool, layer, *meta, scales=None, **kw2):
        if layer == 0:
            if q.shape[1] > captured["wide"].get("qp", 0):
                keep(captured["wide"], q, pool, meta, scales, qp=q.shape[1])
            if step["decode"] and step["seqs"] >= captured["decode"].get(
                    "seqs", 0):
                keep(captured["decode"], q, pool, meta, scales,
                     seqs=step["seqs"])
            if step["verify"] and q.shape[1] > captured["verify"].get(
                    "qp", 0):
                keep(captured["verify"], q, pool, meta, scales,
                     qp=q.shape[1])
            if step["verify_only"] and step["seqs"] >= captured[
                    "verify_only"].get("seqs", 0):
                keep(captured["verify_only"], q, pool, meta, scales,
                     seqs=step["seqs"])
        return ragged_paged_attention(q, pool, layer, *meta, scales=scales,
                                      **kw2)

    gen_mod.ragged_paged_attention = capture
    eng._ragged_operands = spy
    if eng._spec:
        captured["draft"] = watch_spec(eng)
    s0 = eng.stats()
    steps0 = s0["steps"]
    cycle0 = eng.flight_recorder.cycles_recorded
    for attr in RPA_COUNTS:
        setattr(ragged_paged_attention, attr, 0)
    fused_layer_norm.launches = fused_layer_norm.warp_launches = 0
    fused_layer_norm.row_launches = 0
    try:
        with contextlib.ExitStack() as stack:
            if ln_row is not None:
                stack.enter_context(ln_shapes(model, ln_row))
                if eng._spec and eng._draft_model is not model:
                    stack.enter_context(ln_shapes(eng._draft_model, ln_row))
            t0 = time.perf_counter()
            handles = [eng.submit(p, max_new_tokens=max_new)
                       for p in prompts]
            outs = [h.result(timeout=600) for h in handles]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        gen_mod.ragged_paged_attention = ragged_paged_attention
        del eng._ragged_operands
    launches = {"ragged_paged_attention": ragged_paged_attention.launches,
                "ragged_paged_attention_quant":
                    ragged_paged_attention.quant_launches,
                "fused_layer_norm": fused_layer_norm.launches}
    check_ln_route("engine", (fused_layer_norm,))
    check_rpa_route("engine")
    launches["combine"] = ragged_paged_attention.combine_launches
    if not captured["verify_only" if eng._spec else "decode"]:
        raise AssertionError("no decode-only step (or, speculating, no "
                             "verify launch) in the engine run")
    stats = eng.stats()
    if eng._spec:
        settle(eng)
        spec_window(eng, s0, cycle0, captured["draft"])
        # the window's counts: a profiled batch below counts on
        captured["draft"] = dict(captured["draft"])
    if profile:
        profile_engine(eng, rng, vocab)
    eng.close()
    steps = stats["steps"] - steps0
    for p, h, out in zip(prompts, handles, outs):
        if len(h.tokens) != max_new or out.shape != (len(p) + max_new,):
            raise AssertionError(f"request {h.id}: {len(h.tokens)} tokens")
        if not ((out >= 0) & (out < vocab)).all():
            raise AssertionError(f"request {h.id}: token out of range")
    if stats["nonfinite_cycles"]:
        raise AssertionError(f"non-finite logits in "
                             f"{stats['nonfinite_cycles']} cycles")
    return outs, stats, launches, steps, wall, captured


def settle(eng):
    """Wait until the engine's scheduler is idle with its last cycle
    recorded: a request's result is out before its cycle's record and
    counters are."""
    t0 = time.perf_counter()
    while eng._sched._rec is not None or eng._sched.active:
        if time.perf_counter() - t0 > 60:
            raise AssertionError("the scheduler did not go idle")
        time.sleep(0.001)


def check_rpa_route(what):
    """Every attention launch since the counts were set to 0 took the
    tensor-core route."""
    from paddle_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention as fn)
    total = fn.launches + fn.quant_launches
    if not (total > 0 and fn.tc_launches == total and fn.core_launches == 0):
        raise AssertionError(
            f"{what}: {total} attention launches, {fn.tc_launches} on the "
            f"tensor-core route and {fn.core_launches} on the CUDA-core "
            f"route; all should be on the tensor-core route")


def check_serve_launches(what, launches, steps, n_layers, quantized):
    """The attention kernel of the pool's kind once per layer per step,
    the other one never; LayerNorm 2L + 1 times per step."""
    attn = "ragged_paged_attention_quant" if quantized \
        else "ragged_paged_attention"
    want = {"ragged_paged_attention": 0, "ragged_paged_attention_quant": 0,
            "fused_layer_norm": (2 * n_layers + 1) * steps}
    want[attn] = n_layers * steps
    launches = {k: v for k, v in launches.items() if k != "combine"}
    if launches != want:
        raise AssertionError(f"{what}: launches {launches} over {steps} "
                             f"steps, expected {want}")


def serve_line(what, prompts, max_new, stats, steps, wall):
    toks = max_new * len(prompts)
    log(f"{what}, {len(prompts)} requests x {max_new} tokens, prompts "
        f"{min(map(len, prompts))}-{max(map(len, prompts))}, {steps} steps "
        f"in {wall:.3f} s: {toks / wall:.1f} tokens/s, mean step "
        f"{wall / steps * 1e3:.3f} ms (wall / steps), TTFT p50 "
        f"{stats['ttft_ms']['p50']:.1f} ms p95 "
        f"{stats['ttft_ms']['p95']:.1f} ms, TPOT p50 "
        f"{stats['tpot_ms']['p50']:.2f} ms, prefix hits "
        f"{stats['prefix_hits']}, chunks {stats['prefill_chunks']}, "
        f"preempts {stats['preempts']}")


def phase_engine(device, profile=False):
    """Phase 3: GPT-2 small in bf16 through the fused engine over a bf16
    pool. Returns the model, the request mix, the outputs, the engine's
    stats, the launches and the captured operands."""
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    from paddle_tpu_torch import seed

    reference_check(device)
    seed(SEED)
    cfg = GPTConfig.gpt2_small()
    model = GPTForPretraining(cfg).to(device=device, dtype=torch.bfloat16)
    rng = np.random.RandomState(SEED)
    rng.randint(0, cfg.vocab_size, 24)        # the warm-up request's draw
    preamble = rng.randint(0, cfg.vocab_size, 64)
    prompts = []
    for i in range(16):
        n = 512 if i == 0 else int(rng.randint(32, 513))
        p = rng.randint(0, cfg.vocab_size, n)
        if i in (1, 12):                 # the second one admits later
            p = np.concatenate([preamble, p[:max(1, n - 64)]])
        prompts.append(p)
    outs, stats, launches, steps, wall, captured = serve_mix(
        model, prompts, 64, profile, rng, block_size=16)
    check_serve_launches("bf16 engine", launches, steps,
                         cfg.num_hidden_layers, quantized=False)
    if stats["prefix_hits"] < 1 or stats["prefill_chunks"] <= len(prompts):
        raise AssertionError(f"no prefix hit or no chunked prompt: {stats}")
    serve_line("engine: GPT-2 small bf16", prompts, 64, stats, steps, wall)
    log("engine launches: " + json.dumps(launches) + f" over {steps} steps")
    return model, prompts, outs, stats, launches, captured


def logit_drift(model, prompt):
    """One fused step feeding ``prompt`` whole into a bf16 pool and into
    an int8 pool: max |logit difference| and max |bf16 logit|."""
    from paddle_tpu_torch.serving import GenerationEngine
    gpt = model.gpt
    logits = {}
    for kv_dtype in (None, "int8"):
        seen = []

        def keep(h, _orig=type(gpt).logits):
            out = _orig(gpt, h)
            seen.append(out.float().clone())
            return out

        gpt.logits = keep
        try:
            with GenerationEngine(model, kv_layout="paged",
                                  attention="fused", num_slots=1,
                                  block_size=32, prefill_budget=len(prompt),
                                  kv_dtype=kv_dtype,
                                  device=next(model.parameters()).device) \
                    as eng:
                eng.submit(prompt, max_new_tokens=1).result(timeout=300)
        finally:
            del gpt.logits
        if len(seen) != 1:
            raise AssertionError(f"{len(seen)} steps for one prompt")
        logits[kv_dtype] = seen[0][0, 0]
    drift = (logits["int8"] - logits[None]).abs().max().item()
    return drift, logits[None].abs().max().item()


def phase_engine_quant(model, prompts, bf16_outs, bf16_stats,
                       profile=False):
    """Phase 3b: the phase-3 mix from an int8 pool, the logit drift, the
    fp8 pool and the capacity line. Returns launches, operands and the
    int8 engine's outputs."""
    from paddle_tpu_torch.serving.paging import PagedKVPool
    cfg = model.gpt.cfg
    L = cfg.num_hidden_layers
    rng = np.random.RandomState(SEED + 4)
    outs, stats, launches, steps, wall, cap_i8 = serve_mix(
        model, prompts, 64, profile, rng, kv_dtype="int8", block_size=32)
    check_serve_launches("int8 engine", launches, steps, L, quantized=True)
    if stats["prefix_hits"] < 1 or stats["prefill_chunks"] <= len(prompts):
        raise AssertionError(f"no prefix hit or no chunked prompt: {stats}")
    serve_line("engine: GPT-2 small bf16, int8 KV (block 32)", prompts, 64,
               stats, steps, wall)
    same = sum(int(a[len(p)] == b[len(p)])
               for p, a, b in zip(prompts, outs, bf16_outs))
    log(f"int8 engine: {same} of {len(prompts)} first tokens equal the bf16 "
        f"engine's (reported, not gated: random weights have thin "
        f"margins); kv_bytes {json.dumps(stats['kv_bytes'])}; launches "
        + json.dumps(launches) + f" over {steps} steps")
    drift, top = logit_drift(model, prompts[0])
    limit = 0.05 * max(top, 1.0)
    log(f"logit drift, one step over a {len(prompts[0])}-token prompt, int8 "
        f"pool vs bf16 pool: max |diff| {drift:.4f}, max |logit| "
        f"{top:.4f}, limit {limit:.4f}")
    if not drift < limit:
        raise AssertionError(f"int8 logit drift {drift} over {limit}")

    fp8_prompts = prompts[:4]
    outs8, stats8, launches8, steps8, wall8, cap_f8 = serve_mix(
        model, fp8_prompts, 32, kv_dtype="float8_e4m3fn", block_size=32)
    check_serve_launches("fp8 engine", launches8, steps8, L, quantized=True)
    serve_line("engine: GPT-2 small bf16, float8_e4m3fn KV (block 32)",
               fp8_prompts, 32, stats8, steps8, wall8)

    budget = bf16_stats["kv_pool_capacity_bytes"]
    n_i8 = PagedKVPool.blocks_within_budget(
        budget, num_layers=L, num_heads=cfg.num_attention_heads,
        block_size=32,
        head_dim=cfg.hidden_size // cfg.num_attention_heads, dtype="int8")
    bf16_tokens = bf16_stats["num_blocks"] * bf16_stats["block_size"]
    ratio = n_i8 * 32 / bf16_tokens
    log(f"capacity: phase 3's bf16 pool, {budget} bytes, holds "
        f"{bf16_tokens} tokens; int8 blocks of 32 in the same bytes: "
        f"{n_i8} ({n_i8 * 32} tokens), {ratio:.4f}x")
    if ratio < 1.9:
        raise AssertionError(f"int8 capacity only {ratio:.4f}x bf16")
    return ({"ragged_paged_attention_int8":
                 launches["ragged_paged_attention_quant"],
             "ragged_paged_attention_int8_combine": launches["combine"],
             "ragged_paged_attention_fp8":
                 launches8["ragged_paged_attention_quant"],
             "ragged_paged_attention_fp8_combine": launches8["combine"],
             "fused_layer_norm": launches["fused_layer_norm"]
                 + launches8["fused_layer_norm"]},
            {"int8": cap_i8, "fp8": cap_f8}, outs)


# ---------------------------------------------------------------- phase 3d
def gather_counters():
    """The launch-counting wrappers a gather engine's run is held to:
    K2 at every LayerNorm, and K4 and K1/K1q, which must not launch."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import layer_norm as ln
    from paddle_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention)
    return {"fused_layer_norm": ln.fused_layer_norm,
            "flash_attention_fwd": fa.flash_attention_fwd,
            "ragged_paged_attention": ragged_paged_attention}


def gather_launches(counters):
    rpa = counters["ragged_paged_attention"]
    return {"fused_layer_norm": counters["fused_layer_norm"].launches,
            "flash_attention_fwd": counters["flash_attention_fwd"].launches,
            "ragged_paged_attention": rpa.launches + rpa.quant_launches}


def gather_want(n_layers, programs):
    """K2 at ln_1, ln_2 of every block and ln_f in each prefill and each
    decode step; the prefills are masked (left- or right-padded in their
    bucket) and every decode attends through the masked plain
    composition, so K4 never launches, and the gather path never reaches
    K1/K1q."""
    return {"fused_layer_norm": (2 * n_layers + 1) * programs,
            "flash_attention_fwd": 0, "ragged_paged_attention": 0}


def serve_gather(what, model, prompts, max_new, profile=False, rng=None,
                 ln_row="fused_layer_norm_gather", **kw):
    """Serve ``prompts`` at once through a gather engine built with
    ``kw``, after one short warm-up request, with the counts set to 0 just
    before and read just after: they must equal :func:`gather_want` over
    the prefills and decode steps the engine ran, every K2 launch on the
    warp-row route. Returns (outputs, stats, launches, steps, prefills,
    wall seconds)."""
    from paddle_tpu_torch.serving import GenerationEngine
    vocab = model.gpt.cfg.vocab_size
    L = model.gpt.cfg.num_hidden_layers
    eng = GenerationEngine(model, num_slots=8, seed=SEED,
                           device=next(model.parameters()).device, **kw)
    warm = np.random.RandomState(SEED + 9)
    eng.submit(warm.randint(0, vocab, 24), max_new_tokens=4).result(
        timeout=300)
    counters = gather_counters()
    reset_counts(counters)
    for attr in RPA_COUNTS:
        setattr(counters["ragged_paged_attention"], attr, 0)
    s0 = eng.stats()
    with ln_shapes(model, ln_row):
        t0 = time.perf_counter()
        handles = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
        outs = [h.result(timeout=600) for h in handles]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    stats = eng.stats()
    launches = gather_launches(counters)
    steps = stats["steps"] - s0["steps"]
    prefills = stats["prefills"] - s0["prefills"]
    want = gather_want(L, steps + prefills)
    if launches != want:
        raise AssertionError(f"{what}: launches {launches} over {prefills} "
                             f"prefills and {steps} decode steps, expected "
                             f"{want}")
    check_ln_route(what, (counters["fused_layer_norm"],))
    if profile:
        profile_engine(eng, rng, vocab)
    eng.close()
    for p, h, out in zip(prompts, handles, outs):
        if len(h.tokens) != max_new or out.shape != (len(p) + max_new,):
            raise AssertionError(f"{what}: request {h.id}: "
                                 f"{len(h.tokens)} tokens")
        if not ((out >= 0) & (out < vocab)).all():
            raise AssertionError(f"{what}: request {h.id}: token out of "
                                 f"range")
    if stats["nonfinite_cycles"]:
        raise AssertionError(f"{what}: non-finite logits in "
                             f"{stats['nonfinite_cycles']} cycles")
    return outs, stats, launches, steps, prefills, wall


def phase_gather(model, prompts, fused_outs, profile=False):
    """Phase 3d: phase 3's 16 requests (64 new tokens, greedy) through
    the dense engine, the paged gather engine and the int8 paged gather
    engine on the bf16 model; then the float32 check. Returns the K2
    launches of the phase: the gather engines' and the float32 fused
    engines'."""
    L = model.gpt.cfg.num_hidden_layers
    rng = np.random.RandomState(SEED + 8)
    total = 0
    for what, kw in (
            ("dense engine", dict(kv_layout="dense", attention="gather",
                                  min_bucket=32)),
            ("paged gather engine", dict(kv_layout="paged",
                                         attention="gather",
                                         block_size=16)),
            ("int8 paged gather engine", dict(kv_layout="paged",
                                              attention="gather",
                                              kv_dtype="int8",
                                              block_size=32))):
        outs, stats, launches, steps, prefills, wall = serve_gather(
            what, model, prompts, 64, profile and "int8" not in what, rng,
            **kw)
        total += launches["fused_layer_norm"]
        toks = 64 * len(prompts)
        same = sum(int(a[len(p)] == b[len(p)])
                   for p, a, b in zip(prompts, outs, fused_outs))
        hits = stats.get("prefix_hits", 0)
        log(f"{what}: GPT-2 small bf16, {len(prompts)} requests x 64 "
            f"tokens, {prefills} prefills and {steps} decode steps in "
            f"{wall:.3f} s: {toks / wall:.1f} tokens/s, mean step "
            f"{wall / steps * 1e3:.3f} ms (wall / decode steps), TTFT p50 "
            f"{stats['ttft_ms']['p50']:.1f} ms p95 "
            f"{stats['ttft_ms']['p95']:.1f} ms, TPOT p50 "
            f"{stats['tpot_ms']['p50']:.2f} ms, prefix hits {hits}, "
            f"preempts {stats['preempts']}; launches {json.dumps(launches)} "
            f"(K1/K1q held at 0); {same} of {len(prompts)} first tokens "
            f"equal the fused engine's (reported, not gated: bf16 paths "
            f"round differently and random weights have thin margins)")
    f32 = phase_gather_f32(next(model.parameters()).device)
    return {"gather": total + f32["gather"], "fused": f32["fused"]}


def engine_run(net, prompts, new, spy, row=None, num_slots=4, alone=1,
               **kw):
    """``prompts[:alone]`` one after another, then the rest at once,
    through an engine built with ``kw``; ``spy`` stands in for the head
    (``gpt.logits``). With ``row``, the LayerNorm shapes are recorded
    under it. Returns the outputs and the K2 launches."""
    from paddle_tpu_torch.serving import GenerationEngine
    counters = gather_counters()
    reset_counts(counters)
    net.gpt.logits = spy
    try:
        with contextlib.ExitStack() as stack:
            if row is not None:
                stack.enter_context(ln_shapes(net, row))
            eng = stack.enter_context(GenerationEngine(
                net, num_slots=num_slots,
                device=next(net.parameters()).device, **kw))
            outs = [eng.submit(p, max_new_tokens=new).result(timeout=300)
                    for p in prompts[:alone]]
            outs += [h.result(timeout=300) for h in
                     [eng.submit(p, max_new_tokens=new)
                      for p in prompts[alone:]]]
    finally:
        del net.gpt.logits
    return outs, counters["fused_layer_norm"].launches


def first_near_tie(margins, tol):
    """Per request, the first step whose top-2 logit margin (``margins
    [R, steps]``) is below ``tol``; ``steps`` where none is."""
    low = margins < tol
    return [int(torch.nonzero(m)[0]) if bool(m.any()) else len(m)
            for m in low]


def hold_tokens(what, outs, ref, prompts, ties):
    """``outs`` equal to ``ref`` for every request before its near-tie
    step in ``ties``; returns how many are equal in full."""
    for i, (p, t) in enumerate(zip(prompts, ties)):
        got, want = outs[i][len(p):len(p) + t], ref[i][len(p):len(p) + t]
        if not np.array_equal(got, want):
            raise AssertionError(f"request {i}: {what} tokens {got} "
                                 f"!= {want} before its first near-tie at "
                                 f"step {t}")
    return sum(np.array_equal(a, b) for a, b in zip(outs, ref))


#: phase 3d's float32 int8 engines: pools of int8 codes in blocks of 32;
#: the fused engine takes each of its prompts in one chunk
INT8_GATHER_F32 = dict(kv_layout="paged", kv_dtype="int8", block_size=32)
INT8_FUSED_F32 = dict(INT8_GATHER_F32, attention="fused", prefill_budget=512)


def gather_f32_setup():
    """Phase 3d's float32 model (GPT-2 width at 2 layers, random weights
    from a seed, on the CPU, in eval mode), its 4 prompts and the tokens
    each generates."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    pt.seed(SEED + 5)
    cfg = GPTConfig.gpt2_small()
    cfg.num_hidden_layers = 2
    net = GPTForPretraining(cfg).eval()
    rng = np.random.RandomState(SEED + 5)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in (40, 7, 100, 300)]
    return net, prompts, 16


def phase_gather_f32(device):
    """Float32 at GPT-2 width cut to 2 layers, 4 requests of 16 tokens,
    the first alone and then three at once. Float pools: the dense and
    paged gather engines on the card and on a CPU copy of the same
    weights (plain versions), the first prefill's logits within
    ``GEN_TOL``, and the dense, paged gather and fused engines' greedy
    tokens on the card equal up to each request's first step whose top-2
    logit margin (a full forward over the fused engine's tokens) falls
    below ``GEN_TOL``. The int8 pool: the paged gather engine's first
    prefill logits card vs CPU within ``GEN_TOL``; then each int8 engine
    is held against itself on the CPU (:func:`int8_one_slot_check`): the
    gather engine, and the fused engine with K1q's plain version over the
    same pool there, each serving the requests one at a time (one slot)
    on the card and on the CPU, every step's logits within
    ``QUANT_GEN_TOL`` and the tokens equal up to each request's first
    CPU top-2 margin below ``QUANT_GEN_TOL``; to that step the concurrent
    run of the same engine on the card gives the same tokens. The two
    int8 engines are not held against each other: the gather prefill
    attends over the float K/V and quantizes them only at the block
    write, the fused prefill attends over the codes. Returns the card
    runs' K2 launches: the gather engines' and the fused engines'."""
    import copy
    cpu_net, prompts, new = gather_f32_setup()
    card_net = copy.deepcopy(cpu_net).to(device)
    int8 = INT8_GATHER_F32
    engines = {"dense": dict(kv_layout="dense", min_bucket=32),
               "paged gather": dict(kv_layout="paged", block_size=16),
               "int8 paged gather": int8,
               "fused": dict(kv_layout="paged", attention="fused",
                             block_size=16, prefill_budget=128),
               "int8 fused": INT8_FUSED_F32}
    card, errs = {}, {}
    launches = {"gather": 0, "fused": 0}
    for kind, kw in engines.items():
        fused = "fused" in kind
        first = {}
        for where, net in (("cpu", cpu_net), ("card", card_net)):
            if fused and where == "cpu":
                continue

            def spy(h, _gpt=net.gpt, _rec=first, _where=where):
                out = type(_gpt).logits(_gpt, h)
                _rec.setdefault(_where, out[:, -1].float().cpu())
                return out

            row = None if fused or where == "cpu" \
                else "fused_layer_norm_gather"
            outs, n = engine_run(net, prompts, new, spy, row, **kw)
            if where == "card":
                card[kind] = outs
                launches["fused" if fused else "gather"] += n
        if not fused:
            errs[kind] = (first["card"] - first["cpu"]).abs().max().item()
            if not errs[kind] <= GEN_TOL:
                raise AssertionError(
                    f"float32 {kind} engine: first-step logits card vs CPU "
                    f"off by {errs[kind]}, over {GEN_TOL}")
    with torch.no_grad():
        margins = []
        for i, p in enumerate(prompts):
            seq = torch.from_numpy(card["fused"][i]).long().to(device)
            top2 = card_net(seq[None])[0, len(p) - 1:-1].float().topk(
                2, dim=-1).values
            margins.append((top2[:, 0] - top2[:, 1]).cpu())
    ties = first_near_tie(torch.stack(margins), GEN_TOL)
    full = min(hold_tokens(f"{k} engine", card[k], card["fused"], prompts,
                           ties) for k in ("dense", "paged gather"))
    log(f"gather engines float32 check (GPT-2 width, 2 layers, "
        f"{len(prompts)} requests of {[len(p) for p in prompts]} tokens, "
        f"{new} new): first-step logits card vs CPU max |diff| dense "
        f"{errs['dense']:.3e}, paged gather {errs['paged gather']:.3e} "
        f"(limit {GEN_TOL}); on the card the dense, paged gather and fused "
        f"engines' tokens agree before each request's first top-2 margin "
        f"below {GEN_TOL} (step {ties}, {new} = none), all {new} equal in "
        f"{full} of {len(prompts)} requests")

    gather_check, n = int8_one_slot_check(
        "int8 gather engine", cpu_net, card_net, prompts, new, int8,
        card["int8 paged gather"], "fused_layer_norm_gather")
    launches["gather"] += n
    fused_check, n = int8_one_slot_check(
        "int8 fused engine", cpu_net, card_net, prompts, new,
        engines["int8 fused"], card["int8 fused"])
    launches["fused"] += n
    log(f"int8 engines float32 check (block 32, same requests): the gather "
        f"engine's first-step logits card vs CPU max |diff| "
        f"{errs['int8 paged gather']:.3e} (limit {GEN_TOL}); "
        f"{gather_check}; {fused_check}; K2 launches "
        f"{json.dumps(launches)}")
    return launches


def int8_one_slot_check(what, cpu_net, card_net, prompts, new, kw,
                        concurrent, row=None):
    """Phase 3d's int8 check of one engine against itself: ``prompts``
    one at a time through one slot of the engine built with ``kw``, on
    ``cpu_net`` (the kernels' plain versions) and on ``card_net`` (the
    kernels), with every step's logits recorded (each logits call is one
    step of one request, in order). Up to each request's first step
    whose top-2 margin on the CPU is below ``QUANT_GEN_TOL`` (that step
    included) the card's logits lie within ``QUANT_GEN_TOL`` of the CPU's;
    before it the card's tokens equal the CPU's and ``concurrent``'s (the
    same engine's outputs when the requests ran together on the card).
    Returns the log line's clause and the card run's K2 launches. Both
    nets may live on the CPU, which is how the CPU tests run it."""
    steps = {}
    n = 0
    for where, net in (("cpu", cpu_net), ("card", card_net)):
        rec = []

        def spy(h, _gpt=net.gpt, _rec=rec):
            out = type(_gpt).logits(_gpt, h)
            _rec.append(out[:, -1].float().cpu())
            return out

        outs, launches = engine_run(
            net, prompts, new, spy, None if where == "cpu" else row,
            num_slots=1, alone=len(prompts), **kw)
        if len(rec) != len(prompts) * new:
            raise AssertionError(f"{what}, one slot: {len(rec)} logits "
                                 f"calls for {len(prompts)} x {new} steps")
        steps[where] = (outs, torch.cat(rec).view(len(prompts), new, -1))
        if where == "card":
            n = launches
    (cpu_outs, cpu_l), (card_outs, card_l) = steps["cpu"], steps["card"]
    top2 = cpu_l.topk(2, dim=-1).values
    ties = first_near_tie(top2[..., 0] - top2[..., 1], QUANT_GEN_TOL)
    # the steps up to the near-tie feed the same tokens on both sides
    diff = (card_l - cpu_l).abs().amax(dim=-1)                  # [R, new]
    err = max(diff[i, :t + 1].max().item() for i, t in enumerate(ties))
    if not err <= QUANT_GEN_TOL:
        raise AssertionError(f"float32 {what}: step logits card vs CPU off "
                             f"by {err}, over {QUANT_GEN_TOL}")
    same = [hold_tokens(f"{what}{tail}", outs, card_outs, prompts, ties)
            for tail, outs in ((" one slot, CPU", cpu_outs),
                               (" concurrent", concurrent))]
    return (f"the {what} one slot, every step's logits card vs CPU up to "
            f"each request's first CPU top-2 margin below {QUANT_GEN_TOL} "
            f"(step {ties}, {new} = none) within {err:.3e} (limit "
            f"{QUANT_GEN_TOL}), before it the card's tokens equal the CPU's "
            f"and the concurrent run's, all {new} equal in {same} of "
            f"{len(prompts)} requests"), n


# ---------------------------------------------------------------- phase 3c
def gen_counters():
    """The launch-counting wrappers of the kernels ``generate`` runs."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import layer_norm as ln
    return {"fused_layer_norm": ln.fused_layer_norm,
            "flash_attention_fwd": fa.flash_attention_fwd}


def gen_want(n_layers, new_tokens, masked):
    """K2 and K4 launches of one greedy or sampled ``generate``: K2 at
    ln_1, ln_2 of every block and ln_f in the prefill and in each of the
    N - 1 decode steps; K4 once a layer in an unmasked prefill, never in
    a masked one (the decode steps attend over the cache through the
    plain masked composition, as in the JAX package)."""
    return {"fused_layer_norm": (2 * n_layers + 1) * new_tokens,
            "flash_attention_fwd": 0 if masked else n_layers}


def op_calls():
    """Every ``op_count/<name>`` counter of ``call_op``, summed."""
    from paddle_tpu_torch.framework import monitor
    return sum(v for k, v in monitor.all_stats().items()
               if k.startswith("op_count/"))


def gen_run(what, model, ids, want, flash_route,
            ln_row="fused_layer_norm_generate", **kw):
    """One ``model.generate(ids, **kw)`` with the counts set to 0 just
    before and read just after: they must equal ``want``, every
    LayerNorm launch on the warp-row route and every flash launch on
    ``flash_route``. Returns (tokens, wall seconds, launches, call_op
    calls)."""
    counters = gen_counters()
    reset_counts(counters)
    calls0 = op_calls()
    torch.cuda.synchronize()
    with ln_shapes(model, ln_row):
        t0 = time.perf_counter()
        out = model.generate(ids, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, expected {want}")
    check_ln_route(what, (counters["fused_layer_norm"],))
    fa_fn = counters["flash_attention_fwd"]
    on = fa_fn.tc_launches if flash_route == "tc" else fa_fn.core_launches
    if on != fa_fn.launches:
        raise AssertionError(f"{what}: {fa_fn.launches} flash launches, "
                             f"{on} on the {flash_route} route")
    n = kw["max_new_tokens"]
    vocab = model.gpt.cfg.vocab_size
    if not (out.is_cuda == ids.is_cuda and tuple(out.shape) == (
            ids.shape[0], ids.shape[1] + n)):
        raise AssertionError(f"{what}: tokens {tuple(out.shape)} on "
                             f"{out.device}")
    if not (torch.equal(out[:, :ids.shape[1]].long(), ids.long())
            and bool(((out >= 0) & (out < vocab)).all())):
        raise AssertionError(f"{what}: prompt changed or token out of range")
    return out, wall, launches, op_calls() - calls0


def beam_run(what, model, ids, flash_want, flash_route, **kw):
    """One beam-search ``model.generate(ids, **kw)`` with the counts set
    to 0 just before and read just after. Its steps (the prefill and
    each decode step, counted by a spy on ``decode_step``) give the want:
    K2 (2L + 1) x steps, K4 ``flash_want`` (L in an unmasked prefill at
    ``[B]``, 0 masked), every K2 launch on the warp-row route and every
    K4 launch on ``flash_route``. Returns (tokens, wall seconds,
    launches, steps)."""
    gpt = model.gpt
    L = gpt.cfg.num_hidden_layers
    counters = gen_counters()
    reset_counts(counters)
    calls = []
    decode = gpt.decode_step
    gpt.decode_step = lambda *a, **k: calls.append(1) or decode(*a, **k)
    try:
        torch.cuda.synchronize()
        with ln_shapes(model, "fused_layer_norm_beam"):
            t0 = time.perf_counter()
            out = model.generate(ids, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        del gpt.decode_step
    steps = len(calls) + 1
    launches = {name: fn.launches for name, fn in counters.items()}
    want = {"fused_layer_norm": (2 * L + 1) * steps,
            "flash_attention_fwd": flash_want}
    if launches != want:
        raise AssertionError(f"{what}: launches {launches} over {steps} "
                             f"steps, expected {want}")
    if kw.get("eos_token_id") is None and steps != kw["max_new_tokens"]:
        raise AssertionError(f"{what}: {steps} steps for "
                             f"{kw['max_new_tokens']} tokens")
    check_ln_route(what, (counters["fused_layer_norm"],))
    fa_fn = counters["flash_attention_fwd"]
    on = fa_fn.tc_launches if flash_route == "tc" else fa_fn.core_launches
    if on != fa_fn.launches:
        raise AssertionError(f"{what}: {fa_fn.launches} flash launches, "
                             f"{on} on the {flash_route} route")
    vocab = gpt.cfg.vocab_size
    if not (tuple(out.shape) == (ids.shape[0],
                                 ids.shape[1] + kw["max_new_tokens"])
            and torch.equal(out[:, :ids.shape[1]].long(), ids.long())
            and bool(((out >= 0) & (out < vocab)).all())):
        raise AssertionError(f"{what}: tokens {tuple(out.shape)}, prompt "
                             f"changed or token out of range")
    return out, wall, launches, steps


def profile_beam(model, ids):
    """Device time by kernel and the idle share over one more beam
    search, under the port's profiler."""
    with device_profile() as prof:
        t0 = time.perf_counter()
        model.generate(ids, max_new_tokens=BEAM_NEW, num_beams=BEAM_K)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_time_report("beam search", prof, wall_ms, BEAM_NEW)


def phase_beam(model, ids, mids, mask, eos, profile=False):
    """Beam search on the bf16 model: ``num_beams=4``, 32 new tokens, on
    phase 3c's 8 unmasked 512-token prompts (K4 in the prefill at [8],
    K2 at [32, 768] rows a decode step), then on its left-padded batch
    with ``length_penalty=0.6`` and an ``eos_token_id``. Returns the
    launches."""
    L = model.gpt.cfg.num_hidden_layers
    beam, wall, launches, steps = beam_run(
        "beam search", model, ids, L, "tc", max_new_tokens=BEAM_NEW,
        num_beams=BEAM_K)
    log(f"beam search: GPT-2 small bf16, {ids.shape[0]} prompts x "
        f"{ids.shape[1]} tokens, num_beams {BEAM_K}, {BEAM_NEW} new: "
        f"{wall:.4f} s, {ids.shape[0] * BEAM_NEW / wall:.1f} generated "
        f"tokens/s ({ids.shape[0] * BEAM_K * BEAM_NEW / wall:.1f} beam "
        f"rows/s), {wall / steps * 1e3:.3f} ms a step (wall / {steps} "
        f"steps, the prefill included); launches {json.dumps(launches)}")
    m_beam, m_wall, m_launches, m_steps = beam_run(
        "beam search left-padded", model, mids, 0, "tc",
        max_new_tokens=GEN_MASKED[2], num_beams=BEAM_K, length_penalty=0.6,
        eos_token_id=eos, attention_mask=mask)
    log(f"beam search left-padded: {mids.shape[0]} prompts in a "
        f"{mids.shape[1]}-wide batch, num_beams {BEAM_K}, length_penalty "
        f"0.6, eos {eos}, {GEN_MASKED[2]} new: {m_steps} steps in "
        f"{m_wall:.4f} s, {m_wall / m_steps * 1e3:.3f} ms a step; "
        f"launches {json.dumps(m_launches)}; rows ending in eos "
        f"{int((m_beam[:, mids.shape[1]:] == eos).any(dim=1).sum())}")
    if profile:
        profile_beam(model, ids)
    return {k: launches[k] + m_launches[k] for k in launches}


def phase_beam_f32(device):
    """Beam search in float32 at GPT-2 width cut to 2 layers, on the card
    (K2; K4 on the CUDA-core route) and on a CPU copy of the same weights
    (plain versions). A spy on ``_beam_topk`` records, each step, the
    smallest gap between neighbours among each row's K + 1 best
    candidates on the CPU: a row whose gaps all stay at or above
    ``GEN_TOL`` must give the same tokens on both (the final pick, with
    no length penalty and no eos, is the first of the last step's K).
    Returns the card run's launches."""
    import copy

    import paddle_tpu_torch as pt
    import paddle_tpu_torch.models.generation as gen_mod
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    pt.seed(SEED + 10)
    cfg = GPTConfig.gpt2_small()
    cfg.num_hidden_layers = 2
    cpu_net = GPTForPretraining(cfg).eval()
    card_net = copy.deepcopy(cpu_net).to(device)
    ids = torch.from_numpy(np.random.RandomState(SEED + 10).randint(
        0, cfg.vocab_size, (4, 128)))
    gaps = []
    topk = gen_mod._beam_topk

    def spy(cand, k):
        if not cand.is_cuda:
            best = cand.topk(k + 1, dim=-1).values
            gaps.append((best[:, :-1] - best[:, 1:]).min(dim=1).values)
        return topk(cand, k)

    gen_mod._beam_topk = spy
    try:
        card, _, launches, _ = beam_run(
            "beam search float32 on the card", card_net, ids.to(device), 2,
            "cuda_core", max_new_tokens=16, num_beams=BEAM_K)
        cpu = cpu_net.generate(ids, max_new_tokens=16, num_beams=BEAM_K)
    finally:
        gen_mod._beam_topk = topk
    near = (torch.stack(gaps) < GEN_TOL).any(dim=0)           # [B]
    same = (card.cpu() == cpu).all(dim=1)
    if bool((~near & ~same).any()):
        raise AssertionError(
            f"float32 beam search: rows {torch.nonzero(~near & ~same)} "
            f"differ between the card and the CPU with no near-tie")
    log(f"beam search float32 check (GPT-2 width, 2 layers, 4 x 128, "
        f"num_beams {BEAM_K}, 16 new, card vs CPU): rows with a gap below "
        f"{GEN_TOL} among the K + 1 best candidates: {int(near.sum())}; "
        f"tokens equal in {int(same.sum())} of 4 rows, every row without "
        f"a near-tie equal; launches {json.dumps(launches)}, flash on the "
        f"CUDA-core route")
    return launches


def call_op_cost(device):
    """Host µs that ``call_op`` adds to one op on the card: ``reshape``
    (a view, no launch) and the ``layer_norm`` op (predicate, override,
    K2 launch) against calling ``torch.reshape`` and the K2 wrapper
    directly, 500 calls a batch (under the launch queue's depth), median
    of 9 batches."""
    from paddle_tpu_torch.framework.dispatch import call_op
    from paddle_tpu_torch.ops.layer_norm import layer_norm
    x = torch.randn(8, 768, device=device, dtype=torch.bfloat16)
    w, b = torch.ones_like(x[0]), torch.zeros_like(x[0])
    pairs = {"reshape": (lambda: call_op("reshape", x, (2, 4, 768)),
                         lambda: torch.reshape(x, (2, 4, 768))),
             "layer_norm": (lambda: call_op("layer_norm", x, w, b,
                                            epsilon=1e-5),
                            lambda: layer_norm(x, w, b, 1e-5))}
    cost = {}
    for name, fns in pairs.items():
        per = []
        for fn in fns:
            runs = []
            for _ in range(9):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(500):
                    fn()
                runs.append((time.perf_counter() - t0) / 500 * 1e6)
                torch.cuda.synchronize()
            per.append(statistics.median(runs))
        cost[name] = {"call_op_us": per[0], "direct_us": per[1],
                      "added_us": per[0] - per[1]}
    return cost


def profile_generate(model, ids, new_tokens):
    """Device time by kernel and the idle share over one more greedy
    generate, under the port's profiler."""
    with device_profile() as prof:
        t0 = time.perf_counter()
        model.generate(ids, max_new_tokens=new_tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_time_report("generate", prof, wall_ms, new_tokens)


def phase_generate(model, device, profile=False):
    """Phase 3c: ``model.generate`` on GPT-2 small in bf16 (the engine's
    model): 8 unmasked prompts of 512 tokens, 64 new tokens, greedy, then
    sampled (top-k 50, top-p 0.9, seed 1); 4 left-padded prompts of
    96-256 real tokens in a 256-wide batch, 32 new tokens; beam search.
    Returns the K2 and K4 launches of the generate runs and of the beam
    searches."""
    cfg = model.gpt.cfg
    L, vocab = cfg.num_hidden_layers, cfg.vocab_size
    rng = np.random.RandomState(SEED + 6)
    ids = torch.from_numpy(rng.randint(0, vocab, (GEN_BATCH, GEN_PROMPT))
                           ).to(device)
    model.generate(ids, max_new_tokens=2)                   # warm-up
    first, prefill_s, pre_l, _ = gen_run(
        "generate prefill", model, ids, gen_want(L, 1, False), "tc",
        max_new_tokens=1)
    greedy, wall, launches, calls = gen_run(
        "generate greedy", model, ids, gen_want(L, GEN_NEW, False), "tc",
        max_new_tokens=GEN_NEW)
    if not torch.equal(first[:, GEN_PROMPT], greedy[:, GEN_PROMPT]):
        raise AssertionError("generate: the first greedy token differs "
                             "between two calls")
    toks = GEN_BATCH * GEN_NEW
    decode_ms = (wall - prefill_s) / (GEN_NEW - 1) * 1e3
    log(f"generate: GPT-2 small bf16, {GEN_BATCH} prompts x {GEN_PROMPT} "
        f"tokens, {GEN_NEW} new, greedy: {wall:.4f} s, {toks / wall:.1f} "
        f"generated tokens/s; prefill (max_new_tokens=1) "
        f"{prefill_s * 1e3:.3f} ms; decode {decode_ms:.4f} ms per token "
        f"step ((wall - prefill) / {GEN_NEW - 1}); launches "
        f"{json.dumps(launches)}; call_op calls {calls:.0f} "
        f"({calls / GEN_NEW:.1f} per token step)")
    sampled, s_wall, s_launches, _ = gen_run(
        "generate sampled", model, ids, gen_want(L, GEN_NEW, False), "tc",
        max_new_tokens=GEN_NEW, do_sample=True, top_k=50, top_p=0.9, seed=1)
    if torch.equal(sampled, greedy):
        raise AssertionError("sampled generate equals the greedy one")
    log(f"generate sampled (top_k 50, top_p 0.9, seed 1): {s_wall:.4f} s, "
        f"{toks / s_wall:.1f} tokens/s; launches {json.dumps(s_launches)}")
    rows, width, new = GEN_MASKED
    lens = [96, 256] + [int(n) for n in rng.randint(96, 257, rows - 2)]
    mids = torch.from_numpy(rng.randint(0, vocab, (rows, width))).to(device)
    mask = torch.zeros(rows, width, dtype=torch.int64, device=device)
    for i, n in enumerate(lens):
        mask[i, width - n:] = 1
    masked, m_wall, m_launches, _ = gen_run(
        "generate left-padded", model, mids * mask,
        gen_want(L, new, True), "tc", max_new_tokens=new,
        attention_mask=mask)
    log(f"generate left-padded: {rows} prompts of {lens} real tokens in a "
        f"{width}-wide batch, {new} new, greedy: {m_wall:.4f} s, "
        f"{rows * new / m_wall:.1f} tokens/s; launches "
        f"{json.dumps(m_launches)}")
    b_launches = phase_beam(model, ids, mids * mask, mask,
                            int(masked[0, width]), profile)
    cost = call_op_cost(device)
    log("call_op host cost on the card, µs per call (call_op, direct, "
        "added): " + json.dumps(cost))
    if profile:
        profile_generate(model, ids, GEN_NEW)
    return ({name: pre_l[name] + launches[name] + s_launches[name]
             + m_launches[name] for name in launches}, b_launches)


def phase_generate_f32(device):
    """The unmasked greedy case in float32, GPT-2 width at 2 layers: on the
    card (K2; K4 on the CUDA-core route) and on a CPU copy of the same
    weights (plain versions). The first step's logits agree within
    GEN_TOL; each row's tokens are equal up to the first step where the
    CPU's top-2 logit margin is below GEN_TOL (there rounding may pick
    either token). Returns the card run's launches."""
    import copy

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    pt.seed(SEED + 3)
    cfg = GPTConfig.gpt2_small()
    cfg.num_hidden_layers = 2
    cpu_net = GPTForPretraining(cfg).eval()
    card_net = copy.deepcopy(cpu_net).to(device)
    ids = torch.from_numpy(np.random.RandomState(SEED + 6).randint(
        0, cfg.vocab_size, (GEN_BATCH, GEN_PROMPT)))
    seen = {}
    for where, net in (("cpu", cpu_net), ("card", card_net)):
        gpt, rec = net.gpt, seen.setdefault(where, [])

        def keep(h, _gpt=gpt, _rec=rec):
            out = type(_gpt).logits(_gpt, h)
            top2 = out[:, 0].float().topk(2, dim=-1).values
            _rec.append((out[:, 0].float().cpu() if not _rec else None,
                         (top2[:, 0] - top2[:, 1]).cpu()))
            return out

        gpt.logits = keep
    try:
        card, _, launches, _ = gen_run(
            "generate float32 on the card", card_net, ids.to(device),
            gen_want(2, GEN_NEW, False), "cuda_core",
            max_new_tokens=GEN_NEW)
        cpu = cpu_net.generate(ids, max_new_tokens=GEN_NEW)
    finally:
        del cpu_net.gpt.logits, card_net.gpt.logits
    err = (seen["card"][0][0] - seen["cpu"][0][0]).abs().max().item()
    if not err <= GEN_TOL:
        raise AssertionError(f"float32 first-step logits: card vs CPU off by "
                             f"{err}, over {GEN_TOL}")
    margins = torch.stack([m for _, m in seen["cpu"]])      # [steps, B]
    card, cpu = card.cpu()[:, GEN_PROMPT:], cpu[:, GEN_PROMPT:]
    tie = [int(torch.nonzero(margins[:, b] < GEN_TOL)[0])
           if bool((margins[:, b] < GEN_TOL).any()) else GEN_NEW
           for b in range(GEN_BATCH)]
    for b, t in enumerate(tie):
        if not torch.equal(card[b, :t], cpu[b, :t]):
            raise AssertionError(
                f"float32 generate row {b}: card tokens {card[b, :t]} != CPU "
                f"{cpu[b, :t]} before its first near-tie at step {t}")
    same = int((card == cpu).all(dim=1).sum())
    log(f"generate float32 check (GPT-2 width, 2 layers, {GEN_BATCH} x "
        f"{GEN_PROMPT}, {GEN_NEW} new, card vs CPU): first-step logits max "
        f"|diff| {err:.3e} (limit {GEN_TOL}); first CPU top-2 margin below "
        f"{GEN_TOL} per row at step {tie} ({GEN_NEW} = none); tokens equal "
        f"before it in every row, all {GEN_NEW} equal in {same} of "
        f"{GEN_BATCH} rows; launches {json.dumps(launches)}, flash on the "
        f"CUDA-core route")
    return launches


def generate_rows(device, timer, launches):
    """The kernels line's rows of the generate path, each with its count
    in ``launches``: K2 for greedy and sampled generate (timed at a
    decode step's rows, bf16 [8, 768]), for beam search (at a beam decode
    step's [B*K, 768] rows, bf16 [32, 768]) and for the gather engines
    (at a decode step's slots, bf16 [8, 768]), each also held against
    its plain version at every other shape its launches ran at; and K4
    at the prefill's shape (bf16 [8, 512, 12, 64] causal, tensor-core
    route), which generate and beam search share."""
    bf16 = torch.bfloat16
    rows = [(name, LN_SRC, LN_TPU, ln_shape_row(
                timer, name, launches[name], (bf16, n, 768)),
             launches[name])
            for name, n in (("fused_layer_norm_generate", GEN_BATCH),
                            ("fused_layer_norm_beam", GEN_BATCH * BEAM_K),
                            ("fused_layer_norm_gather", 8))]
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    q, k, v, do = (
        torch.randn(GEN_BATCH, GEN_PROMPT, 12, 64, device=device,
                    generator=gen).to(bf16) for _ in range(4))
    fwd, _ = flash_case(timer, q, k, v, do, route="tc")
    log(f"K4/K5 flash_attention_fwd at the generate prefill's shape, bf16 "
        f"[{GEN_BATCH}, {GEN_PROMPT}, 12, 64] causal, tc route {fmt(fwd)}")
    rows.append(("flash_attention_fwd_generate", FA_TC_SRC, FA_FWD_TPU, fwd,
                 launches["flash_attention_fwd"]))
    return [{"name": name, "route": "cuda", "source": src, "replaces": tpu,
             "launches": count,
             **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms")}}
            for name, src, tpu, row, count in rows]


# ---------------------------------------------------------------- phase 3e
F16_KINDS = (("f16", dict(block_size=16)),
             ("int8_f16", dict(kv_dtype="int8", block_size=32)),
             ("fp8_f16", dict(kv_dtype="float8_e4m3fn", block_size=32)))
F16_LN_ROW = "fused_layer_norm_serve_f16"


def phase_serve_f16(device, prompts, profile=False):
    """Phase 3e: GPT-2 small in float16 (full width and depth, random
    weights from a seed) served through the fused engine over a float16
    pool (blocks of 16) and over int8 and fp8 pools (blocks of 32), phase
    3's 16 requests each, 64 new tokens: K1/K1q 12 launches a step, every
    one on the tensor-core route, K2 (2L + 1) a step. Then the card's
    oracle, the float16 dense gather engine (no K1) over the same
    requests: the fused float16 engine's tokens equal its tokens up to
    each request's first step whose top-2 logit margin (a float16 full
    forward over the fused tokens) falls below ``F16_GEN_TOL``; the int8
    pool's logit drift against a float16 pool on one step, within phase
    3b's bound; and ``generate`` (8 unmasked prompts of 512, 32 new,
    greedy: K4 float16 on the tensor-core route in the prefill). No plain
    version runs. Returns the launches and the captured attention
    operands."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    seed(SEED + 10)
    cfg = GPTConfig.gpt2_small()
    model = GPTForPretraining(cfg).to(device=device, dtype=torch.float16)
    model.eval()
    L, vocab = cfg.num_hidden_layers, cfg.vocab_size
    rng = np.random.RandomState(SEED + 10)
    out = {"captured": {}, "attn": {}, "combine": {}, "wide_rows": 0,
           "fused_layer_norm": 0}
    fused = {}
    with count_plain() as plain:
        for kind, kw in F16_KINDS:
            outs, stats, launches, steps, wall, cap = serve_mix(
                model, prompts, 64, profile and kind == "f16", rng,
                ln_row=F16_LN_ROW, **kw)
            quant = kind != "f16"
            check_serve_launches(f"float16 {kind} engine", launches, steps,
                                 L, quantized=quant)
            serve_line(f"engine: GPT-2 small float16, {kind} pool (block "
                       f"{kw['block_size']})", prompts, 64, stats, steps,
                       wall)
            log(f"float16 {kind} engine launches: {json.dumps(launches)} "
                f"over {steps} steps; kv_bytes "
                f"{json.dumps(stats['kv_bytes'])}")
            fused[kind] = outs
            out["captured"][kind] = cap
            out["attn"][kind] = launches["ragged_paged_attention_quant"
                                         if quant else
                                         "ragged_paged_attention"]
            out["combine"][kind] = launches["combine"]
            out["fused_layer_norm"] += launches["fused_layer_norm"]
        out["wide_rows"] = out["captured"]["f16"]["wide"]["qp"]

        # the card's oracle: the dense gather engine, plain attention
        g_outs, g_stats, g_launches, g_steps, g_prefills, g_wall = \
            serve_gather("float16 dense engine", model, prompts, 64,
                         ln_row=F16_LN_ROW, kv_layout="dense",
                         attention="gather", min_bucket=32)
        out["fused_layer_norm"] += g_launches["fused_layer_norm"]
        with torch.no_grad():
            margins = []
            for p, seq in zip(prompts, fused["f16"]):
                ids = torch.from_numpy(seq).long().to(device)[None]
                top2 = model(ids)[0, len(p) - 1:-1].float().topk(
                    2, dim=-1).values
                margins.append((top2[:, 0] - top2[:, 1]).cpu())
        ties = first_near_tie(torch.stack(margins), F16_GEN_TOL)
        full = hold_tokens("float16 dense gather engine", g_outs,
                           fused["f16"], prompts, ties)
        log(f"float16 dense engine (the oracle), {len(prompts)} requests x "
            f"64 tokens, {g_prefills} prefills and {g_steps} decode steps "
            f"in {g_wall:.3f} s: {64 * len(prompts) / g_wall:.1f} tokens/s, "
            f"mean step {g_wall / g_steps * 1e3:.3f} ms, TTFT p50 "
            f"{g_stats['ttft_ms']['p50']:.1f} ms p95 "
            f"{g_stats['ttft_ms']['p95']:.1f} ms; launches "
            f"{json.dumps(g_launches)} (K1/K1q held at 0); its tokens equal "
            f"the fused float16 engine's before each request's first top-2 "
            f"margin below {F16_GEN_TOL} (step {ties}, 64 = none), all 64 "
            f"in {full} of {len(prompts)} requests")
        drift, top = logit_drift(model, prompts[0])
        limit = 0.05 * max(top, 1.0)
        log(f"float16 logit drift, one step over a {len(prompts[0])}-token "
            f"prompt, int8 pool vs float16 pool: max |diff| {drift:.4f}, "
            f"max |logit| {top:.4f}, limit {limit:.4f}")
        if not drift < limit:
            raise AssertionError(f"float16 int8 logit drift {drift} over "
                                 f"{limit}")

        n, width, new = F16_GEN
        ids = torch.from_numpy(rng.randint(0, vocab, (n, width))).to(device)
        model.generate(ids[:, :32], max_new_tokens=2)            # warm-up
        toks, wall, launches, _ = gen_run(
            "generate float16", model, ids, gen_want(L, new, False), "tc",
            ln_row=F16_LN_ROW, max_new_tokens=new)
        out["fused_layer_norm"] += launches["fused_layer_norm"]
        out["generate_flash"] = launches["flash_attention_fwd"]
        log(f"generate float16: GPT-2 small, {n} prompts x {width} tokens, "
            f"{new} new, greedy: {wall:.4f} s, {n * new / wall:.1f} "
            f"generated tokens/s; launches {json.dumps(launches)} (K4 on "
            f"the tensor-core route)")
    if sum(plain.values()):
        raise AssertionError(f"float16 serving: plain versions ran on the "
                             f"card: {dict(plain)}")
    del model
    out["fused_layer_norm"] += phase_serve_f16_check(device)
    return out


def phase_serve_f16_check(device):
    """Phase 3e, then: the fused engine over a float16 pool at GPT-2 width
    cut to 2 layers, float16 weights, on the card and on a CPU copy
    (plain versions), 4 requests of 16 new tokens: the first step's
    logits within ``F16_GEN_TOL``. Returns the card run's K2 launches."""
    import copy

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    pt.seed(SEED + 11)
    cfg = GPTConfig.gpt2_small()
    cfg.num_hidden_layers = 2
    cpu_net = GPTForPretraining(cfg).to(torch.float16).eval()
    card_net = copy.deepcopy(cpu_net).to(device)
    rng = np.random.RandomState(SEED + 11)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in (40, 7, 100, 300)]
    first, outs, launches = {}, {}, 0
    for where, net in (("cpu", cpu_net), ("card", card_net)):
        def spy(h, _gpt=net.gpt, _where=where):
            logits = type(_gpt).logits(_gpt, h)
            first.setdefault(_where, logits[:, -1].float().cpu())
            return logits

        outs[where], n = engine_run(
            net, prompts, 16, spy, F16_LN_ROW if where == "card" else None,
            kv_layout="paged", attention="fused", block_size=16,
            prefill_budget=128)
        if where == "card":
            launches = n
    err = (first["card"] - first["cpu"]).abs().max().item()
    if not err <= F16_GEN_TOL:
        raise AssertionError(f"float16 fused engine: first-step logits card "
                             f"vs CPU off by {err}, over {F16_GEN_TOL}")
    same = sum(np.array_equal(a, b) for a, b in zip(outs["card"],
                                                     outs["cpu"]))
    log(f"float16 fused engine check (GPT-2 width, 2 layers, "
        f"{len(prompts)} requests of {[len(p) for p in prompts]} tokens, 16 "
        f"new, card vs CPU): first-step logits max |diff| {err:.3e} (limit "
        f"{F16_GEN_TOL}); all 16 tokens equal in {same} of {len(prompts)} "
        f"requests (reported)")
    return launches


def serve_f16_rows(device, timer, f16):
    """The kernels line's rows of phase 3e: K1 float16 and K1q int8/fp8
    with float16 q on the layer-0 operands of each engine's widest and
    decode-only steps (tensor-core route, the CUDA-core kernel beside it);
    K2 float16 at every shape its launches ran at, timed at the widest
    fused step's rows; K4 float16 at the generate prefill's shape."""
    rows = [rpa_row(f"ragged_paged_attention_{kind}", timer,
                    f16["captured"][kind],
                    {"attn": f16["attn"][kind],
                     "combine": f16["combine"][kind]})
            for kind, _ in F16_KINDS]
    ln = ln_shape_row(timer, F16_LN_ROW, f16["fused_layer_norm"],
                      (torch.float16, f16["wide_rows"], 768))
    rows.append({"name": F16_LN_ROW, "route": "cuda", "source": LN_SRC,
                 "replaces": LN_TPU, "launches": f16["fused_layer_norm"],
                 **{k: ln[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms")},
                 "core_route": "row", "core_ms": ln["row_ms"],
                 "core_err": ln["row_err"]})
    n, width, _ = F16_GEN
    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    q, k, v, do = (torch.randn(n, width, 12, 64, device=device,
                               generator=gen).half() for _ in range(4))
    fwd, _ = flash_case(timer, q, k, v, do, route="tc", core=True)
    log(f"K4/K5 flash_attention_fwd at the float16 generate prefill's "
        f"shape, float16 [{n}, {width}, 12, 64] causal, tc route {fmt(fwd)}")
    rows.append({"name": "flash_attention_fwd_generate_f16", "route": "cuda",
                 "source": FA_TC_SRC, "replaces": FA_FWD_TPU,
                 "launches": f16["generate_flash"],
                 **{k: fwd[k] for k in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms")},
                 "core_source": FA_SRC, "core_ms": fwd["core_ms"],
                 "core_err": fwd["core_err"]})
    return rows


# ---------------------------------------------------------------- phase 3f
SPEC_K = 4
# near-ties of two bf16 paths through GPT-2 small (random weights): the
# verify launch scores up to SPEC_K rows a slot where the plain fused step
# scores one, so their products round differently; tokens are held equal
# only before a step whose top-2 logit margin (a bf16 full forward over
# the reference tokens) is below this. An int8 pool adds its own rounding
# and the scales that rejected rows grew, so its bound is wider.
SPEC_TIE_TOL = 0.1
SPEC_QUANT_TIE_TOL = 0.25
SPEC_LN_ROW = "fused_layer_norm_spec"


def watch_spec(eng):
    """From now on, count a speculative engine's draft calls (proposal
    chains and the draft steps in them, draft prefills) and run every
    draft and verify call under ``torch.cuda.set_sync_debug_mode(
    "error")``: a host sync inside raises in the cycle, which fails its
    requests. The operands' host-to-device copy happens before these
    calls, and the scheduler's one fetch after them."""
    counts = {"steps": 0, "scans": 0, "prefills": 0}
    scan_fn, prefill_fn = eng._draft_scan_fn, eng._draft_prefill_fn
    verify_fn = eng._spec_step_fn

    def no_sync(fn):
        def run(*a, **k):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return run

    def scan(kmax):
        counts["steps"] += kmax
        counts["scans"] += 1
        return no_sync(scan_fn(kmax))

    def prefill(bucket):
        counts["prefills"] += 1
        return no_sync(prefill_fn(bucket))

    eng._draft_scan_fn, eng._draft_prefill_fn = scan, prefill
    eng._spec_step_fn = lambda q, t: no_sync(verify_fn(q, t))
    return counts


def spec_window(eng, s0, cycle0, counts):
    """The speculative figures of the counted window, from the engine's
    flight recorder (its cycles after ``cycle0``) and its stats against
    ``s0``: one draft dispatch on every speculative cycle, each cycle
    recording its proposed/accepted/emitted tokens, accept rate, tokens
    per slot-cycle, mean cycle ms; ``dump_flight_recorder`` writes JSON
    that parses. Adds them to ``counts``."""
    import tempfile
    s = eng.stats()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "flight.json")
        eng.dump_flight_recorder(path)
        with open(path) as f:
            doc = json.load(f)
    cycles = [c for c in doc["cycles"] if c["cycle"] > cycle0]
    if doc["cycles_recorded"] - cycle0 != len(cycles):
        raise AssertionError(f"the ring lost cycles of the window: "
                             f"{doc['cycles_recorded'] - cycle0} recorded, "
                             f"{len(cycles)} kept")
    spec = [c for c in cycles if "spec_proposed" in c]
    if len(spec) != s["spec_cycles"] - s0["spec_cycles"] or not spec:
        raise AssertionError(f"{len(spec)} speculative cycles in the ring, "
                             f"{s['spec_cycles'] - s0['spec_cycles']} counted")
    bad = [c for c in spec if c.get("spec_draft_dispatches") != 1
           or not {"spec_accepted", "spec_emitted"} <= set(c)]
    if bad or counts["scans"] != len(spec):
        raise AssertionError(f"draft dispatches: {counts['scans']} chains "
                             f"over {len(spec)} speculative cycles; "
                             f"{len(bad)} cycle records without exactly one")
    proposed = s["spec_proposed"] - s0["spec_proposed"]
    accepted = s["spec_accepted"] - s0["spec_accepted"]
    counts.update(
        verify=len(spec), cycles=len(cycles), proposed=proposed,
        accepted=accepted, accept_rate=accepted / max(1, proposed),
        tokens_per_slot_cycle=sum(c["spec_emitted"] for c in spec)
        / sum(c["spec_slots"] for c in spec),
        cycle_ms=statistics.mean(c["cycle_ms"] for c in cycles),
        draft_bytes=s["kv_bytes"]["draft"], draft_layers=s["draft_layers"])


def bf16_margins(model, prompts, seqs):
    """Each request's top-2 logit margin at each generated step of
    ``seqs``, from a full forward of the model in its dtype."""
    device = next(model.parameters()).device
    out = []
    with torch.no_grad():
        for p, seq in zip(prompts, seqs):
            ids = torch.from_numpy(seq).long().to(device)[None]
            top2 = model(ids)[0, len(p) - 1:-1].float().topk(
                2, dim=-1).values
            out.append((top2[:, 0] - top2[:, 1]).cpu())
    return torch.stack(out)


def phase_spec(model, prompts, fused_outs, int8_outs, profile=False):
    """Phase 3f: phase 3's 16 requests (64 new tokens, greedy) served
    speculatively (``spec_k=4``) by GPT-2 small bf16 through three fused
    engines: the default 2-layer draft over a bf16 pool (blocks of 16),
    the agreeing draft (the target itself) over the same pool, and the
    2-layer draft over an int8 pool (blocks of 32). Each: K1 (or K1q) 12
    launches a fused launch, every one on the tensor-core route; K2 (2L +
    1) a target launch plus (2 Ld + 1) a draft step or draft prefill,
    every one on the warp-row route and recorded by shape; one draft
    dispatch a speculative cycle (the flight recorder); no host sync in
    the draft and verify calls; no plain version; tokens/s, TTFT, mean
    cycle ms, accept rate, tokens per slot-cycle. The tokens equal phase
    3's (phase 3b's for the int8 pool) before each request's first
    near-tie. Then the 2-layer float32 check, card against CPU. With
    ``profile``, the 2-layer bf16 engine serves one more batch under
    torch.profiler. Returns the launches and the verify launches'
    operands."""
    L = model.gpt.cfg.num_hidden_layers
    kinds = (("2-layer draft, bf16 pool (block 16)", "auto",
              dict(spec_draft="auto", block_size=16), "bf16",
              SPEC_TIE_TOL),
             ("agreeing draft (the target), bf16 pool (block 16)", "agree",
              dict(spec_draft=model, block_size=16), "bf16", SPEC_TIE_TOL),
             ("2-layer draft, int8 pool (block 32)", "int8",
              dict(spec_draft="auto", kv_dtype="int8", block_size=32),
              "int8", SPEC_QUANT_TIE_TOL))
    refs = {"bf16": fused_outs, "int8": int8_outs}
    margins = {k: bf16_margins(model, prompts, v) for k, v in refs.items()}
    out = {"attn": 0, "quant": 0, "combine": 0, "quant_combine": 0,
           "fused_layer_norm": 0, "captured": {}}
    rng = np.random.RandomState(SEED + 14)
    with count_plain() as plain:
        for what, kind, kw, ref, tol in kinds:
            outs, stats, launches, steps, wall, cap = serve_mix(
                model, prompts, 64, profile and kind == "auto", rng,
                ln_row=SPEC_LN_ROW, spec_k=SPEC_K, **kw)
            quant = "kv_dtype" in kw
            d = cap["draft"]
            ld = d["draft_layers"]
            want = {"ragged_paged_attention": 0,
                    "ragged_paged_attention_quant": 0,
                    "fused_layer_norm": (2 * L + 1) * steps
                    + (2 * ld + 1) * (d["steps"] + d["prefills"])}
            attn = "ragged_paged_attention_quant" if quant \
                else "ragged_paged_attention"
            want[attn] = L * steps
            got = {k: v for k, v in launches.items() if k != "combine"}
            if got != want:
                raise AssertionError(
                    f"speculative {what}: launches {got} over {steps} "
                    f"launches ({d['verify']} verify), {d['steps']} draft "
                    f"steps and {d['prefills']} draft prefills, expected "
                    f"{want}")
            ties = first_near_tie(margins[ref], tol)
            full = hold_tokens(f"speculative {what}", outs, refs[ref],
                               prompts, ties)
            toks = 64 * len(prompts)
            log(f"speculative engine, {what}, spec_k {SPEC_K}, "
                f"{len(prompts)} requests x 64 tokens: {steps} fused "
                f"launches ({d['verify']} verify) in {wall:.3f} s: "
                f"{toks / wall:.1f} tokens/s, mean cycle {d['cycle_ms']:.3f} "
                f"ms (recorder), wall / launches {wall / steps * 1e3:.3f} ms, "
                f"TTFT p50 {stats['ttft_ms']['p50']:.1f} ms p95 "
                f"{stats['ttft_ms']['p95']:.1f} ms, TPOT p50 "
                f"{stats['tpot_ms']['p50']:.2f} ms; accept rate "
                f"{d['accept_rate']:.4f} ({d['accepted']} of "
                f"{d['proposed']}), {d['tokens_per_slot_cycle']:.4f} tokens "
                f"per slot-cycle, 1 draft dispatch on each of {d['verify']} "
                f"speculative cycles, {d['steps']} draft steps, "
                f"{d['prefills']} draft prefills; draft {ld} layers, "
                f"{d['draft_bytes']} bytes; launches {json.dumps(launches)}; "
                f"tokens equal the {ref} fused engine's before each "
                f"request's first top-2 margin below {tol} (steps {ties}, "
                f"64 = none), all 64 in {full} of {len(prompts)}")
            if quant:
                out["quant"] += launches[attn]
                out["quant_combine"] += launches["combine"]
            else:
                out["attn"] += launches[attn]
                out["combine"] += launches["combine"]
            out["fused_layer_norm"] += launches["fused_layer_norm"]
            out["captured"].setdefault("int8" if quant else "bf16", cap)
    if sum(plain.values()):
        raise AssertionError(f"speculative serving: plain versions ran on "
                             f"the card: {dict(plain)}")
    out["fused_layer_norm"] += phase_spec_f32(next(model.parameters()).device)
    return out


def phase_spec_f32(device):
    """Phase 3f, then: a speculative fused engine at GPT-2 width cut to 2
    layers, float32, its draft ``make_draft_model(net, 1)``, on the card
    and on a CPU copy (plain versions), 4 requests of 16 new tokens: the
    first verify launch's logits within ``GEN_TOL``, and the tokens equal
    before each request's first CPU top-2 margin below it. Returns the
    card run's K2 launches (target and draft)."""
    import copy

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.models.generation import make_draft_model
    pt.seed(SEED + 13)
    cfg = GPTConfig.gpt2_small()
    cfg.num_hidden_layers = 2
    cpu_net = GPTForPretraining(cfg).eval()
    card_net = copy.deepcopy(cpu_net).to(device)
    rng = np.random.RandomState(SEED + 13)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in (40, 7, 100, 300)]
    verify_rows = 4 * SPEC_K + 4          # 4 slots: S * K + S head rows
    first, outs, launches = {}, {}, 0
    for where, net in (("cpu", cpu_net), ("card", card_net)):
        def spy(h, _gpt=net.gpt, _where=where):
            logits = type(_gpt).logits(_gpt, h)
            if h.shape[0] == verify_rows:
                first.setdefault(_where, logits[:, 0].float().cpu())
            return logits

        draft = make_draft_model(net, 1)
        with contextlib.ExitStack() as stack:
            if where == "card":
                stack.enter_context(ln_shapes(draft, SPEC_LN_ROW))
            outs[where], n = engine_run(
                net, prompts, 16, spy,
                SPEC_LN_ROW if where == "card" else None,
                kv_layout="paged", attention="fused", block_size=16,
                prefill_budget=128, spec_draft=draft, spec_k=SPEC_K)
        if where == "card":
            launches = n
    err = (first["card"] - first["cpu"]).abs().max().item()
    if not err <= GEN_TOL:
        raise AssertionError(f"float32 speculative engine: first verify "
                             f"launch's logits card vs CPU off by {err}, "
                             f"over {GEN_TOL}")
    with torch.no_grad():
        margins = []
        for p, seq in zip(prompts, outs["cpu"]):
            ids = torch.from_numpy(seq).long()[None]
            top2 = cpu_net(ids)[0, len(p) - 1:-1].topk(2, dim=-1).values
            margins.append(top2[:, 0] - top2[:, 1])
    ties = first_near_tie(torch.stack(margins), GEN_TOL)
    full = hold_tokens("float32 speculative engine, card vs CPU",
                       outs["card"], outs["cpu"], prompts, ties)
    log(f"float32 speculative engine check (GPT-2 width, 2 layers, a "
        f"1-layer draft, spec_k {SPEC_K}, {len(prompts)} requests of "
        f"{[len(p) for p in prompts]} tokens, 16 new, card vs CPU): first "
        f"verify launch's logits max |diff| {err:.3e} (limit {GEN_TOL}); "
        f"tokens equal before each request's first CPU top-2 margin below "
        f"{GEN_TOL} (steps {ties}, 16 = none), all 16 in {full} of "
        f"{len(prompts)}")
    return launches


def spec_rows(timer, spec):
    """The kernels line's rows of phase 3f: K1 (bf16 pool) and K1q (int8
    pool) on the layer-0 operands of the widest verify launch of the
    2-layer-draft engines, and of their last verify-only launch with the
    most sequences (``verify_only_*`` keys), through the tensor-core
    route and the CUDA-core kernel, against the plain version; K2 at
    every shape its launches ran at in phase 3f, timed at the widest
    verify launch's rows."""
    rows = []
    for name, kind, attn, combine in (
            ("ragged_paged_attention_spec", "bf16", spec["attn"],
             spec["combine"]),
            ("ragged_paged_attention_int8_spec", "int8", spec["quant"],
             spec["quant_combine"])):
        cap = spec["captured"][kind]
        for k, what in (("verify", "widest verify launch"),
                        ("verify_only", "verify-only launch")):
            work_shape(f"{name} {what}", cap[k]["q"], cap[k]["pool"],
                       cap[k]["meta"])
        r = rpa_case(f"{name}, widest verify launch layer 0", timer,
                     cap["verify"])
        v = rpa_case(f"{name}, verify-only launch layer 0", timer,
                     cap["verify_only"])
        rows.append({"name": name, "route": "cuda", "source": RPA_TC_SRC,
                     "replaces": RPA_TPU, "launches": attn,
                     **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by")},
                     "library_ms": None, "combine_launches": combine,
                     "core_source": RPA_SRC, "core_ms": r["core_ms"],
                     "core_err": r["core_err"],
                     **{f"verify_only_{k}": v[k] for k in (
                         "max_abs_err", "ms", "core_ms", "core_err",
                         "plain_ms", "bound_ms", "bound_by")}})
    q = spec["captured"]["bf16"]["verify"]["q"]
    ln = ln_shape_row(timer, SPEC_LN_ROW, spec["fused_layer_norm"],
                      (q.dtype, q.shape[1], q.shape[0] * q.shape[2]))
    rows.append({"name": SPEC_LN_ROW, "route": "cuda", "source": LN_SRC,
                 "replaces": LN_TPU, "launches": spec["fused_layer_norm"],
                 **{k: ln[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms")},
                 "core_route": "row", "core_ms": ln["row_ms"],
                 "core_err": ln["row_err"]})
    return rows


# ---------------------------------------------------------------- phase 3g
TIER_BS = 32
TIER_PREAMBLE = 448          # 14 blocks of 32 tokens
TIER_SLO_MS = 400.0
TIER_HOST_BYTES = 256 << 20
TIER_LN_ROW = "fused_layer_norm_fleet"
# the tiered load: bench.py --serve-load --tiered's traffic at GPT-2 small
# width; six rotating 14-block preambles (84 blocks) over a 64-block pool
TIER_LOAD = dict(requests=24, rate=8.0, systems=6, num_blocks=64)
TIER_KINDS = {"bf16": {}, "int8": {"kv_dtype": "int8"}}
TIER_TIE_TOL = {"bf16": SPEC_TIE_TOL, "int8": SPEC_QUANT_TIE_TOL}


def tier_engine(model, **kw):
    """A fused paged engine of phase 3g: blocks of 32, 4 slots, max_len
    512 (``kw`` adds the pool, the tier and the rest)."""
    from paddle_tpu_torch.serving import GenerationEngine
    return GenerationEngine(model, kv_layout="paged", attention="fused",
                            block_size=TIER_BS, num_slots=4, max_len=512,
                            seed=SEED, device=next(model.parameters()).device,
                            **kw)


def tier_reset():
    """Every serving kernel's count set to 0."""
    from paddle_tpu_torch.ops.layer_norm import fused_layer_norm
    from paddle_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention)
    for attr in RPA_COUNTS:
        setattr(ragged_paged_attention, attr, 0)
    fused_layer_norm.launches = fused_layer_norm.warp_launches = 0
    fused_layer_norm.row_launches = 0


def tier_read(what, steps, n_layers, quantized):
    """The counts since ``tier_reset``: K1 (or K1q) once per layer per
    fused launch and K2 (2L + 1) times, every launch on the tensor-core
    and warp-row routes."""
    from paddle_tpu_torch.ops.layer_norm import fused_layer_norm
    from paddle_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention as rpa)
    launches = {"ragged_paged_attention": rpa.launches,
                "ragged_paged_attention_quant": rpa.quant_launches,
                "fused_layer_norm": fused_layer_norm.launches}
    check_ln_route(what, (fused_layer_norm,))
    check_rpa_route(what)
    check_serve_launches(what, launches, steps, n_layers, quantized)
    launches["combine"] = rpa.combine_launches
    return launches


def tier_capture(slot):
    """Wrap the engines' attention call: while ``slot["armed"]``, keep
    the layer-0 operands of the next launch in ``slot`` and disarm.
    Returns the undo."""
    import paddle_tpu_torch.models.generation as gen_mod
    from paddle_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention)

    def capture(q, pool, layer, *meta, scales=None, **kw):
        if layer == 0 and slot.get("armed"):
            slot.update(armed=False, q=q.clone(), pool=pool[:1].clone(),
                        scales=None if scales is None
                        else scales[:1].clone(),
                        meta=[m.clone() for m in meta])
        return ragged_paged_attention(q, pool, layer, *meta, scales=scales,
                                      **kw)

    gen_mod.ragged_paged_attention = capture

    def undo():
        gen_mod.ragged_paged_attention = ragged_paged_attention
    return undo


def tier_churn(model, kind, rng, out):
    """Phase 3g (i): one request at a time, a preamble of 14 blocks with
    a tail, three churn requests that push its blocks out of a 32-block
    pool, ``tier_tick`` + ``drain``, then the preamble with its tail
    again; through a tiered engine (32 blocks, 256 MiB of host) and a
    roomy untiered one (80 blocks: nothing is evicted). Tokens exactly
    equal; a host hit; at least 14 blocks demoted and promoted; one
    demoted block read back from the tier equal to the device block bit
    for bit (with its scales on int8); the layer-0 attention operands of
    the launch that reads the promoted blocks kept in ``out``."""
    vocab = model.gpt.cfg.vocab_size
    L = model.gpt.cfg.num_hidden_layers
    quantized = kind == "int8"
    pre = rng.randint(0, vocab, TIER_PREAMBLE)
    first = np.concatenate([pre, rng.randint(0, vocab, 1)])
    churn = [rng.randint(0, vocab, TIER_PREAMBLE + 1) for _ in range(3)]
    nblk = TIER_PREAMBLE // TIER_BS
    outs, cap = {}, {}
    for name, extra in (("tiered", dict(num_blocks=32,
                                        host_tier_bytes=TIER_HOST_BYTES)),
                        ("roomy", dict(num_blocks=80))):
        eng = tier_engine(model, **TIER_KINDS[kind], **extra)
        tier = eng._pool.host_tier
        undo = tier_capture(cap)
        tier_reset()
        try:
            got = [eng.submit(first, max_new_tokens=8).result(timeout=300)]
            settle(eng)
            if tier is not None:
                eng._pool.tier_tick()
                tier.drain()
                key = tuple(int(t) for t in pre[:TIER_BS])
                b = eng._pool._trie[key].block
                host, scale = tier.get(key)
                same = torch.equal(host, eng._pool.data[:, :, b].cpu())
                if quantized:
                    same = same and torch.equal(
                        scale, eng._pool.scales[:, :, b].cpu())
                if not same:
                    raise AssertionError(f"tier churn {kind}: the demoted "
                                         f"block differs from the device's")
            for p in churn:
                got.append(eng.submit(p, max_new_tokens=8).result(
                    timeout=300))
            settle(eng)
            if tier is not None:
                eng._pool.tier_tick()
                tier.drain()
            cap["armed"] = name == "tiered"
            got.append(eng.submit(first, max_new_tokens=8).result(
                timeout=300))
            settle(eng)
            s = eng.stats()
            launches = tier_read(f"tier churn {kind} {name}", s["steps"], L,
                                 quantized)
        finally:
            undo()
            eng.close()
        outs[name] = got
        out["launches"][kind].append(launches)
        if name == "tiered":
            ht = s["host_tier"]
            if s["tier_hits"]["host"] < 1 or ht["demoted_blocks"] < nblk \
                    or ht["promoted_blocks"] < nblk or "q" not in cap:
                raise AssertionError(f"tier churn {kind}: {s['tier_hits']} "
                                     f"{ht}")
            tiered = s
        else:
            if s["tier_hits"]["hbm"] < 1:
                raise AssertionError(f"roomy engine {kind}: no HBM hit: "
                                     f"{s['tier_hits']}")
    for i, (a, b) in enumerate(zip(outs["tiered"], outs["roomy"])):
        if not np.array_equal(a, b):
            raise AssertionError(f"tier churn {kind}: request {i} tiered "
                                 f"{a[-8:]} != roomy {b[-8:]}")
    out["captured"][kind] = cap
    ht = tiered["host_tier"]
    log(f"tier churn, {kind} pool, GPT-2 small, {len(outs['tiered'])} "
        f"requests one at a time (a {TIER_PREAMBLE}-token preamble + 1, "
        f"3 churn, the preamble again): tokens equal the roomy engine's "
        f"exactly; tier hits {tiered['tier_hits']}, demoted "
        f"{ht['demoted_blocks']} promoted {ht['promoted_blocks']} blocks, "
        f"promotion {ht['promotion_ms']}, copy "
        f"{ht['promotion_copy_ms']} at {ht['promotion_copy_gb_per_s']} "
        f"GB/s; a demoted block equals the device block bit for bit"
        + (" with its scales" if quantized else ""))


def tier_schedule(vocab):
    """``bench.py``'s ``_tiered_schedule`` at GPT-2 small width: six
    rotating 448-token preambles (a seeded draw), one fresh tail token,
    4-8 new tokens, exponential gaps at 8 requests/s, seed 0."""
    systems = [np.random.RandomState(SEED + 31 + j).randint(
        0, vocab, TIER_PREAMBLE) for j in range(TIER_LOAD["systems"])]
    rng = np.random.RandomState(0)
    offsets = np.cumsum(rng.exponential(1.0 / TIER_LOAD["rate"],
                                        TIER_LOAD["requests"]))
    return [(float(offsets[i]),
             np.concatenate([systems[i % len(systems)],
                             rng.randint(1, vocab, 1)]).astype(np.int32),
             int(rng.randint(4, 9))) for i in range(TIER_LOAD["requests"])]


def tier_load_run(model, kind, name, schedule, out, profile=False,
                  **extra):
    """One engine through the schedule, open loop. Returns the outputs
    and the figures. ``profile``: under the port's profiler, with device
    time by kernel, the idle share and device ms a cycle printed."""
    L = model.gpt.cfg.num_hidden_layers
    vocab = model.gpt.cfg.vocab_size
    eng = tier_engine(model, num_blocks=TIER_LOAD["num_blocks"],
                      **TIER_KINDS[kind], **extra)
    try:
        eng.submit(np.random.RandomState(SEED + 33).randint(0, vocab, 40),
                   max_new_tokens=2).result(timeout=300)
        settle(eng)
        s0 = eng.stats()
        cycles0 = eng.flight_recorder.cycles_recorded
        tier_reset()
        with device_profile() if profile else \
                contextlib.nullcontext() as prof:
            t0 = time.perf_counter()
            handles = []
            for off, ids, new in schedule:
                delay = t0 + off - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                handles.append(eng.submit(ids, max_new_tokens=new))
            outs = [h.result(timeout=600) for h in handles]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            settle(eng)
        s = eng.stats()
        if profile:
            cycles = eng.flight_recorder.cycles_recorded - cycles0
            busy, idle = device_time_report(
                f"tiered load {kind} {name}", prof, wall * 1e3,
                s["steps"] - s0["steps"])
            log(f"profile tiered load {kind} {name}: {cycles} cycles, "
                f"device busy {busy / cycles:.4f} ms a cycle, idle share "
                f"{idle:.4f}")
        launches = tier_read(f"tiered load {kind} {name}",
                             s["steps"] - s0["steps"], L, kind == "int8")
    finally:
        eng.close()
    out["launches"][kind].append(launches)
    ttft = np.array([h.trace.ttft_ms for h in handles])
    toks = sum(len(h.tokens) for h in handles)
    hits = {k: s["tier_hits"][k] - s0["tier_hits"][k]
            for k in ("hbm", "host", "miss")}
    split = {f"prefix_{'miss' if k == 'miss' else 'hit_' + k}":
             round(v / max(1, sum(hits.values())), 4)
             for k, v in hits.items()}
    fig = {"ttft_p50_ms": float(np.percentile(ttft, 50)),
           "ttft_p95_ms": float(np.percentile(ttft, 95)),
           "goodput_rps": float((ttft <= TIER_SLO_MS).sum() / wall),
           "tokens_per_s": toks / wall, "wall_s": wall,
           "tier_hits": hits, "steps": s["steps"] - s0["steps"]}
    line = (f"tiered load, {kind} pool, {name}: {len(handles)} requests at "
            f"{TIER_LOAD['rate']:g}/s over {wall:.3f} s: TTFT p50 "
            f"{fig['ttft_p50_ms']:.1f} ms p95 {fig['ttft_p95_ms']:.1f} ms, "
            f"goodput {fig['goodput_rps']:.3f} rps at TTFT <= "
            f"{TIER_SLO_MS:g} ms, {fig['tokens_per_s']:.1f} tokens/s, "
            f"{fig['steps']} fused launches; hits {hits} {split}")
    ht = s.get("host_tier")
    if ht is not None:
        fig["host_tier"] = ht
        nbytes = TIER_PREAMBLE // TIER_BS * (
            eng._pool.host_block_nbytes + eng._pool.host_scale_nbytes)
        copy = ht["promotion_copy_ms"]
        line += (f"; demoted {ht['demoted_blocks']} promoted "
                 f"{ht['promoted_blocks']} blocks; promotion (ticket to "
                 f"adoption) {ht['promotion_ms']}; its copy {copy} ms, "
                 f"{nbytes} bytes a 14-block chain: "
                 f"{nbytes / copy['p50'] / 1e6:.2f} GB/s at the p50 copy, "
                 f"{ht['promotion_copy_gb_per_s']} GB/s over every "
                 f"promotion's bytes and ms; demotion copy "
                 f"{ht['demotion_copy_gb_per_s']} GB/s")
    log(line)
    return outs, fig


def tier_load(model, kind, out):
    """Phase 3g (ii): the schedule through an HBM-only engine and a tiered
    one (256 MiB of host) over the same 64-block pool; tokens equal
    before each request's first near-tie; the tiered engine takes host
    hits."""
    schedule = tier_schedule(model.gpt.cfg.vocab_size)
    runs = {name: tier_load_run(model, kind, name, schedule, out, **extra)
            for name, extra in (("HBM-only", {}), ("tiered", dict(
                host_tier_bytes=TIER_HOST_BYTES)))}
    prompts = [ids for _, ids, _ in schedule]
    ref = runs["HBM-only"][0]
    # each request's top-2 margins at its own steps, +inf past its end
    width = max(len(o) - len(p) for o, p in zip(ref, prompts))
    margins = torch.full((len(ref), width), math.inf)
    for i, (p, o) in enumerate(zip(prompts, ref)):
        m = bf16_margins(model, [p], [o])[0]
        margins[i, :len(m)] = m
    ties = first_near_tie(margins, TIER_TIE_TOL[kind])
    full = hold_tokens(f"tiered load {kind}", runs["tiered"][0], ref,
                       prompts, ties)
    fig = runs["tiered"][1]
    if fig["tier_hits"]["host"] < 1:
        raise AssertionError(f"tiered load {kind}: no host hit: {fig}")
    log(f"tiered load, {kind}: tiered tokens equal the HBM-only engine's "
        f"before each request's first top-2 margin below "
        f"{TIER_TIE_TOL[kind]} (steps {ties}), in full in {full} of "
        f"{len(prompts)}")
    out["load"][kind] = {k: v[1] for k, v in runs.items()}


def http(url, doc=None, headers=None):
    """(status, body bytes) of a GET (``doc`` None) or a JSON POST."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        url, data=None if doc is None else json.dumps(doc).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def tier_front_door(model, out):
    """Phase 3g (iii): an ``EngineFleet`` of two tiered bf16 fused
    replicas sharing the model on the one card, an ``SLOTracker`` (TTFT
    <= 400 ms at 0.99, TPOT <= 40 ms at 0.95) on the fleet, and a
    ``FrontDoor`` with two tenants mounted on an ``OpsServer`` at
    127.0.0.1, driven by real HTTP clients: an SSE stream equal to the
    unary answer; the 429s the bucket arithmetic predicts; both lanes;
    /healthz, /readyz, /metrics, /statusz, /tracez. K1 and K2 counted
    across both replicas' scheduler threads, exactly."""
    from paddle_tpu_torch.framework import metrics
    from paddle_tpu_torch.serving import (EngineFleet, FrontDoor, OpsServer,
                                          SLOTracker)
    L = model.gpt.cfg.num_hidden_layers
    vocab = model.gpt.cfg.vocab_size
    rng = np.random.RandomState(SEED + 35)
    engines = [tier_engine(model, num_blocks=TIER_LOAD["num_blocks"],
                           host_tier_bytes=TIER_HOST_BYTES)
               for _ in range(2)]
    fleet = EngineFleet(engines, name="chip-fleet")
    slo = SLOTracker(name="chip-slo")
    slo.add_objective("ttft", "ttft_ms", TIER_SLO_MS, 0.99)
    slo.add_objective("tpot", "tpot_ms", 40.0, 0.95)
    fleet.attach_slo(slo)
    cost = 32 + 8                                # prompt + max_tokens
    limits = {"free": (0.01, 2.5 * cost)}
    door = FrontDoor(fleet, tenant_limits=limits,
                     api_keys={"key-pro": "pro", "key-free": "free"})
    ops = OpsServer(target=fleet, slo=slo)
    door.mount(ops)
    pro = {"Authorization": "Bearer key-pro"}
    try:
        url = ops.start().url
        if not url.startswith("http://127.0.0.1:"):
            raise AssertionError(f"the ops server is at {url}")
        tier_reset()
        t0 = time.perf_counter()
        with ln_shapes(model, TIER_LN_ROW):
            prompt = [int(t) for t in rng.randint(0, vocab, 64)]
            st, body = http(url + "/v1/completions",
                            {"prompt": prompt, "max_tokens": 16}, pro)
            unary = json.loads(body)["choices"][0]["token_ids"]
            st2, body = http(url + "/v1/completions",
                             {"prompt": prompt, "max_tokens": 16,
                              "stream": True}, pro)
            frames = body.decode().strip().split("\n\n")
            if st != 200 or st2 != 200 or frames[-1] != "data: [DONE]":
                raise AssertionError(f"front door: {st} {st2} {frames[-1]}")
            sse = [json.loads(f[6:])["choices"][0]["token_id"]
                   for f in frames[:-2]]
            if sse != unary or len(sse) != 16:
                raise AssertionError(f"SSE {sse} != unary {unary}")
            # the free tenant: burst 2.5 requests at 0.01 tokens/s, so
            # over this run's seconds exactly floor(2.5) admit
            shed = [http(url + "/v1/completions",
                         {"prompt": [int(t) for t in rng.randint(
                             0, vocab, 32)], "max_tokens": 8},
                         {"Authorization": "Bearer key-free"})[0]
                    for _ in range(5)]
            rate, burst = limits["free"]
            elapsed = time.perf_counter() - t0
            admits = int((burst + rate * elapsed) // cost)
            if shed.count(429) != 5 - admits or shed.count(200) != admits:
                raise AssertionError(f"free tenant: {shed}, the bucket "
                                     f"admits {admits} of 5")
            # both lanes at once, default weights 4:1
            lanes = ["batch"] * 8 + ["interactive"] * 4
            ids = [None] * len(lanes)

            def client(i):
                st, body = http(url + "/v1/completions", {
                    "prompt": [int(t) for t in np.random.RandomState(
                        SEED + 40 + i).randint(0, vocab, 32)],
                    "max_tokens": 8}, dict(pro, **{"X-Lane": lanes[i]}))
                if st == 200:
                    ids[i] = json.loads(body)["id"]

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(lanes))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            if any(t.is_alive() for t in threads) or None in ids:
                raise AssertionError(f"lane clients: {ids}")
            for e in engines:
                settle(e)
        wall = time.perf_counter() - t0
        steps = sum(e.stats()["steps"] for e in engines)
        launches = tier_read("fleet", steps, L, False)
        out["launches"]["bf16"].append(launches)
        out["fleet_ln"] = launches["fused_layer_norm"]
        codes = {p: http(url + p)[0] for p in ("/healthz", "/readyz")}
        if set(codes.values()) != {200}:
            raise AssertionError(f"health: {codes}")
        parsed = metrics.parse_prometheus(http(url + "/metrics")[1].decode())
        need = {"serving_tier_hit_host", "serving_tier_hit",
                "serving_tenant_goodput_rps", "serving_replica_healthy",
                "slo_events_total", "slo_burn_rate"}
        if not need <= set(parsed["types"]):
            raise AssertionError(f"/metrics lacks "
                                 f"{need - set(parsed['types'])}")
        statusz = http(url + "/statusz")[1].decode()
        if "serving fleets" not in statusz:
            raise AssertionError("/statusz has no serving fleets section")
        tracez = json.loads(http(url + "/tracez")[1])
        recent = [t for e in tracez["engines"].values()
                  for t in e["recent"]]
        if set(tracez["engines"]) != {"0", "1"} or not recent \
                or "slo" not in tracez:
            raise AssertionError(f"/tracez: {sorted(tracez)}")
        by_id = {f"cmpl-{t['request']}": t for t in recent}
        waits = collections.defaultdict(list)
        for i, rid in enumerate(ids):
            t = by_id.get(rid)
            if t is not None:
                adm = next(e for e in t["timeline"]
                           if e["event"] == "admitted")
                waits[t["lane"]].append(adm["t_ms"])
        if set(waits) != {"batch", "interactive"}:
            raise AssertionError(f"lane traces: {dict(waits)}")
        s = fleet.stats()
        slo_rep = s["slo"]["objectives"]
    finally:
        ops.close()
        fleet.close()
        slo.close()
    log(f"front door: fleet of 2 tiered bf16 fused replicas on one card, "
        f"{s['requests_retired']} requests in {wall:.3f} s over HTTP at "
        f"127.0.0.1; SSE == unary ({len(unary)} tokens); free tenant "
        f"{shed} (the bucket admits {admits}); lane wait p50 "
        + ", ".join(f"{lane} {statistics.median(v):.1f} ms (n={len(v)})"
                    for lane, v in sorted(waits.items()))
        + f"; TTFT p50 {s['ttft_ms']['p50']:.1f} ms; SLO "
        + ", ".join(f"{k} {o['good']}/{o['total']}"
                    for k, o in sorted(slo_rep.items()))
        + f"; tier hits {s.get('tier_hits')}; launches "
        f"{json.dumps(launches)} over {steps} fused launches of both "
        f"replicas; /healthz /readyz 200, /metrics {len(parsed['types'])} "
        f"families, /statusz serving fleets, /tracez {len(recent)} traces")


def phase_tier(model, profile=False):
    """Phase 3g: the serving periphery on GPT-2 small bf16 (full width
    and depth), fused engines over pools of 32-token blocks: (i) the
    serial churn, tiered against roomy, bf16 and int8; (ii) the tiered
    load, HBM-only against tiered, bf16 and int8; (iii) the front door
    over a fleet of two tiered replicas. No plain version runs. Returns
    the launches by pool kind and the operands of the launches that read
    promoted blocks."""
    t0 = time.perf_counter()
    out = {"launches": {"bf16": [], "int8": []}, "captured": {},
           "load": {}}
    rng = np.random.RandomState(SEED + 30)
    with count_plain() as plain:
        for kind in TIER_KINDS:
            tier_churn(model, kind, rng, out)
        for kind in TIER_KINDS:
            tier_load(model, kind, out)
        tier_front_door(model, out)
        if profile:
            # one more tiered bf16 load run under the profiler (its
            # launches are not counted in the rows)
            tier_load_run(model, "bf16", "tiered, profiled",
                          tier_schedule(model.gpt.cfg.vocab_size),
                          {"launches": {"bf16": []}}, profile=True,
                          host_tier_bytes=TIER_HOST_BYTES)
    if sum(plain.values()):
        raise AssertionError(f"phase 3g: plain versions ran on the card: "
                             f"{dict(plain)}")
    log(f"phase 3g took {time.perf_counter() - t0:.1f} s")
    return out


def tier_rows(timer, tier):
    """The kernels line's rows of phase 3g: K1 (bf16 pools) and K1q (int8
    pools) on the layer-0 operands of the churn's launch that reads the
    promoted preamble, through the tensor-core route and the CUDA-core
    kernel, against the plain version, with the launches of every phase
    3g engine of the pool's kind; K2 at every shape the fleet's two
    replicas launched it at, timed at the most frequent one."""
    rows = []
    for name, kind, attn in (
            ("ragged_paged_attention_tiered", "bf16",
             "ragged_paged_attention"),
            ("ragged_paged_attention_int8_tiered", "int8",
             "ragged_paged_attention_quant")):
        cap = tier["captured"][kind]
        work_shape(f"{name} promoted-read launch", cap["q"], cap["pool"],
                   cap["meta"])
        r = rpa_case(f"{name}, the launch reading promoted blocks, layer 0",
                     timer, cap)
        runs = tier["launches"][kind]
        rows.append({"name": name, "route": "cuda", "source": RPA_TC_SRC,
                     "replaces": RPA_TPU,
                     "launches": sum(x[attn] for x in runs),
                     **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by")},
                     "library_ms": None,
                     "combine_launches": sum(x["combine"] for x in runs),
                     "core_source": RPA_SRC, "core_ms": r["core_ms"],
                     "core_err": r["core_err"]})
    shapes = LN_SHAPES[TIER_LN_ROW]
    main = max(shapes, key=shapes.get)
    ln = ln_shape_row(timer, TIER_LN_ROW, tier["fleet_ln"], main)
    rows.append({"name": TIER_LN_ROW, "route": "cuda", "source": LN_SRC,
                 "replaces": LN_TPU, "launches": tier["fleet_ln"],
                 **{k: ln[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms")},
                 "core_route": "row", "core_ms": ln["row_ms"],
                 "core_err": ln["row_err"]})
    return rows


# ---------------------------------------------------------------- phase 6
def rpa_core(q, pool, meta, scales=None):
    """The CUDA-core kernel (``csrc/ragged_paged_attention.cu``) on layer 0
    of the operands, through its C entry: the wrapper sends bf16 operands
    at these widths to the tensor-core kernel, so this is how the old
    kernel is held and timed on the same operands. Counts nothing."""
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    out = torch.empty_like(q)
    h, qp, dh = q.shape
    args = (*(m.data_ptr() for m in meta), h, qp, dh, pool.shape[2],
            pool.shape[4], meta[3].shape[1], 0, 1.0 / math.sqrt(dh),
            torch.cuda.current_stream().cuda_stream)
    if scales is None:
        rc = _build.function("ragged_paged_attention", "rpa_launch",
                             rpa._ARGS)(
            _build.DTYPE_CODE[q.dtype], q.data_ptr(), pool.data_ptr(),
            out.data_ptr(), *args)
    else:
        rc = _build.function("ragged_paged_attention", "rpa_quant_launch",
                             rpa._QUANT_ARGS)(
            rpa._QUANT_CODE[pool.dtype], _build.DTYPE_CODE[q.dtype],
            q.data_ptr(), pool.data_ptr(), scales.data_ptr(),
            out.data_ptr(), *args)
    if rc != 0:
        raise RuntimeError(f"CUDA-core attention kernel: CUDA error {rc}")
    return out


def work_shape(what, q, pool, meta):
    """What each route launches on these operands: real q blocks, tiles,
    splits, CTAs, the longest page walk of any CTA; and the CUDA-core
    kernel's grid and longest walk."""
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    blk_seq, qstart, pos0, tables, lo, kv_len = (m.cpu().numpy()
                                                 for m in meta)
    h, qp, _ = q.shape
    bs = pool.shape[4]
    z = rpa.split_count(tables.shape[1], bs)
    tiles = rpa.tc_plan(blk_seq, qstart, pos0, lo, kv_len, bs)
    per_split = rpa.SPLIT_COLS // bs
    walks = [min(t["p_end"], (zz + 1) * per_split)
             - max(t["p_begin"], zz * per_split)
             for t in tiles for zz in range(t["z_first"], t["z_last"] + 1)]
    real = [int(s) for s in blk_seq if s >= 0]
    slots = rpa.tile_slots(qp, len(qstart))
    shape = {"q_rows": qp, "real_q_blocks": len(real), "tiles": len(tiles),
             "tile_splits": len(walks),
             "multi_split_tiles": sum(t["z_last"] > t["z_first"]
                                      for t in tiles),
             "grid": [slots, h, z],
             "ctas_launched": slots * h * z + (qp // 8 * h if z > 1 else 0),
             "ctas_with_work": len(walks) * h,
             "longest_walk_pages": max(walks, default=0),
             "old_grid": [qp // 8, h], "old_ctas_with_work": len(real) * h,
             "old_longest_walk_pages": max(
                 (-(-int(kv_len[s]) // bs) for s in real), default=0)}
    log(f"work shape, {what}: " + json.dumps(shape))


def rpa_case(name, timer, cap):
    """The attention kernel through the wrapper (the tensor-core route)
    and the CUDA-core kernel on the same operands, each against the plain
    version and timed; the bound from these operands."""
    from paddle_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention, ragged_paged_attention_plain)
    q, pool, meta, scales = cap["q"], cap["pool"], cap["meta"], cap["scales"]
    want = ragged_paged_attention_plain(q, pool, 0, *meta, scales=scales)
    got = ragged_paged_attention(q, pool, 0, *meta, scales=scales)
    old = rpa_core(q, pool, meta, scales)
    torch.cuda.synchronize()
    err = check_close(f"{name} on an engine step", got, want, q.dtype)
    core_err = check_close(f"{name}, CUDA-core kernel, on an engine step",
                           old, want, q.dtype)
    again = ragged_paged_attention(q, pool, 0, *meta, scales=scales)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: another call, other bits")
    nbytes, ops = rpa_work(q, pool, meta, scales)
    b_ms, b_by = bound(nbytes, ops, q.dtype)
    row = {"max_abs_err": err, "core_err": core_err,
           "ms": timer.ms(lambda: ragged_paged_attention(
               q, pool, 0, *meta, scales=scales)),
           "core_ms": timer.ms(lambda: rpa_core(q, pool, meta, scales)),
           "plain_ms": timer.ms(lambda: ragged_paged_attention_plain(
               q, pool, 0, *meta, scales=scales), reps=5, warmup=1),
           "bound_ms": b_ms, "bound_by": b_by}
    log(f"{name}: q{tuple(q.shape)} {q.dtype}, pool {pool.dtype}, {nbytes} "
        f"bytes, {ops} ops; tensor-core route max_abs_err {err:.3e} "
        f"kernel_ms {row['ms']:.5f}; CUDA-core kernel max_abs_err "
        f"{core_err:.3e} kernel_ms {row['core_ms']:.5f}; plain_ms "
        f"{row['plain_ms']:.4f} bound_ms {b_ms:.6f} ({b_by})")
    return row


def rpa_row(name, timer, captured, launches):
    """One row of the kernels line for the attention kernel (K1, or K1q
    for a quantized pool) on the layer-0 operands of an engine's widest
    step; its decode-only step's numbers and the CUDA-core kernel's on
    the same operands as extra keys (``decode_*``, ``core_*``)."""
    for k in ("wide", "decode"):
        work_shape(f"{name} {k} step", captured[k]["q"], captured[k]["pool"],
                   captured[k]["meta"])
    wide = rpa_case(f"{name}, widest step layer 0", timer, captured["wide"])
    dec = rpa_case(f"{name}, decode-only step layer 0", timer,
                   captured["decode"])
    row = {"name": name, "route": "cuda", "source": RPA_TC_SRC,
           "replaces": RPA_TPU, "launches": launches["attn"],
           "max_abs_err": wide["max_abs_err"], "ms": wide["ms"],
           "plain_ms": wide["plain_ms"], "bound_ms": wide["bound_ms"],
           "bound_by": wide["bound_by"], "library_ms": None,
           "combine_launches": launches["combine"],
           "core_source": RPA_SRC, "core_ms": wide["core_ms"],
           "core_err": wide["core_err"]}
    row.update({f"decode_{k}": dec[k] for k in (
        "max_abs_err", "ms", "core_ms", "core_err", "plain_ms", "bound_ms",
        "bound_by")})
    return row


def report_engine(device, timer, launches, captured, quant_launches,
                  quant_captured):
    rows_out = [rpa_row("ragged_paged_attention", timer, captured,
                        {"attn": launches["ragged_paged_attention"],
                         "combine": launches["combine"]})]
    for kind in ("int8", "fp8"):
        name = f"ragged_paged_attention_{kind}"
        counts = {"attn": quant_launches[name],
                  "combine": quant_launches[name + "_combine"]}
        rows_out.append(rpa_row(name, timer, quant_captured[kind], counts))
    q = captured["wide"]["q"]
    dtype = q.dtype
    rows, d = q.shape[1], q.shape[0] * q.shape[2]
    torch.manual_seed(SEED)
    x = torch.randn(rows, d, device=device).to(dtype)
    w = (1 + 0.1 * torch.randn(d, device=device)).to(dtype)
    b = (0.1 * torch.randn(d, device=device)).to(dtype)
    row = ln_fwd_case(timer, x, w, b)
    log(f"K2 fused_layer_norm at the engine step's rows, {str(dtype)[6:]} "
        f"[{rows}, {d}] {fmt(row)}")
    ln = {"name": "fused_layer_norm", "route": "cuda", "source": LN_SRC,
          "replaces": LN_TPU, "launches": launches["fused_layer_norm"]}
    ln.update({k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")})
    return rows_out + [ln]


# ---------------------------------------------------------------- phase 4
def train_counters():
    """The launch-counting wrappers of the training path's kernels."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_adamw as fad
    from paddle_tpu_torch.ops import layer_norm as ln
    return {"flash_attention_fwd": fa.flash_attention_fwd,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "fused_layer_norm": ln.fused_layer_norm,
            "fused_layer_norm_bwd": ln.fused_layer_norm_bwd,
            "fused_adamw": fad.fused_adamw_}


def adamw_launches(numels):
    """K8's launches for one step over parameter tensors of ``numels``
    elements and one dtype combination: the count of ``adamw_plan``."""
    from paddle_tpu_torch.ops.fused_adamw import adamw_plan
    return len(adamw_plan(numels, [0] * len(numels)))


def expected_launches(n_layers, numels):
    """Launches of one train step: one flash forward and backward per
    block, a LayerNorm forward and backward at ln_1, ln_2 of every block
    and ln_f (the checkpointed loss recomputes only the LM head), and
    K8's plan over the parameter tensors of ``numels`` elements, which
    updates each tensor once (``fused_adamw_tensors``)."""
    return {"flash_attention_fwd": n_layers, "flash_attention_bwd": n_layers,
            "fused_layer_norm": 2 * n_layers + 1,
            "fused_layer_norm_bwd": 2 * n_layers + 1,
            "fused_adamw": adamw_launches(numels),
            "fused_adamw_tensors": len(numels)}


def read_counts(counters):
    """The wrappers' launch counts, with K8's count of updated tensors
    beside its launches (``fused_adamw_tensors``) when K8 is counted."""
    out = {name: fn.launches for name, fn in counters.items()}
    if "fused_adamw" in counters:
        out["fused_adamw_tensors"] = counters["fused_adamw"].tensors
    return out


def reset_counts(counters):
    """Every launch count of the wrappers to 0 (the flash and LayerNorm
    wrappers' per-route counts and K8's tensors too)."""
    for fn in counters.values():
        for attr in ("launches", "tc_launches", "core_launches",
                     "warp_launches", "row_launches", "tensors"):
            if hasattr(fn, attr):
                setattr(fn, attr, 0)


def check_flash_route(what, counters, route):
    """Every flash launch since the counts were set to 0 took ``route``."""
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        fn = counters[name]
        on = fn.tc_launches if route == "tc" else fn.core_launches
        if not (fn.launches > 0 and on == fn.launches
                and fn.tc_launches + fn.core_launches == fn.launches):
            raise AssertionError(
                f"{what}: {name} launched {fn.launches} times, "
                f"{fn.tc_launches} on the tensor-core route and "
                f"{fn.core_launches} on the CUDA-core route; all should "
                f"be {route}")


def check_ln_route(what, wrappers):
    """Every LayerNorm launch since the counts were set to 0 took the
    warp-row route (the path's rows are 768 wide and freshly allocated)."""
    for fn in wrappers:
        if not (fn.launches > 0 and fn.warp_launches == fn.launches
                and fn.row_launches == 0):
            raise AssertionError(
                f"{what}: {fn.__name__} launched {fn.launches} times, "
                f"{fn.warp_launches} on the warp-row route and "
                f"{fn.row_launches} on the row route; all should be warp")


def check_launches(what, launches, per_step, steps):
    want = {k: v * steps for k, v in per_step.items()}
    if launches != want:
        raise AssertionError(f"{what}: launches {launches} over {steps} "
                             f"steps, expected {want}")


def capture_train_operands(model, opt_module, ids, labels):
    """Run one train step with spies on the callers of the kernels and
    keep layer 0's operands: q, k, v and dO of its attention, x, weight
    and the output gradient of its first LayerNorm, and the first tensor
    of the step's AdamW group (the token embedding's) p, g, m, v, copy
    and scalars."""
    import paddle_tpu_torch.nn.functional as nnf
    import paddle_tpu_torch.nn.layer.norm as norm_mod
    cap = {}
    fa_orig, ln_orig = nnf.flash_attention, norm_mod.layer_norm
    ad_orig = opt_module.fused_adamw_group_

    def fa_spy(q, k, v, is_causal=False, scale=None):
        out = fa_orig(q, k, v, is_causal=is_causal, scale=scale)
        if "qkv" not in cap:
            cap["qkv"] = [t.detach().clone() for t in (q, k, v)]
            out.register_hook(lambda g: cap.update(do=g.detach().clone()))
        return out

    def ln_spy(x, w, b, epsilon=1e-5):
        out = ln_orig(x, w, b, epsilon)
        if "ln" not in cap:
            cap["ln"] = [t.detach().clone() for t in (x, w)]
            out.register_hook(lambda g: cap.update(ln_g=g.detach().clone()))
        return out

    def adamw_spy(ps, gs, ms, vs, lows, lrs, wds, steps, b1, b2, eps):
        if "adamw" not in cap:
            low = lows[0]
            cap["adamw"] = ([t.clone() for t in (ps[0], gs[0], ms[0],
                                                 vs[0])],
                            None if low is None else low.clone(),
                            (lrs[0], b1, b2, eps, wds[0], steps[0]))
        return ad_orig(ps, gs, ms, vs, lows, lrs, wds, steps, b1, b2, eps)

    nnf.flash_attention, norm_mod.layer_norm = fa_spy, ln_spy
    opt_module.fused_adamw_group_ = adamw_spy
    try:
        loss = model.train_batch([ids, labels])
    finally:
        nnf.flash_attention, norm_mod.layer_norm = fa_orig, ln_orig
        opt_module.fused_adamw_group_ = ad_orig
    if not math.isfinite(loss) or len(cap) != 5:
        raise AssertionError(f"capture step: loss {loss}, kept {sorted(cap)}")
    return cap


def profile_train(model, ids, labels, steps=2):
    with device_profile() as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            model.train_batch([ids, labels])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_time_report("train", prof, wall_ms, steps)


def phase_train(device, profile=False):
    """GPT-2 small, bf16 O2, through Model.fit at the bench_gpt2
    configuration; returns the timed run's launches and the operands of
    one more real step."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.optimizer.optimizer as opt_module
    from paddle_tpu_torch.hapi import Callback, Model
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.optimizer import AdamW

    class Record(Callback):
        """Each step's loss (log_freq=1 reads it back every step) and the
        host clock at the end of the step."""

        def __init__(self):
            super().__init__()
            self.losses, self.stamps = [], []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])
            self.stamps.append(time.perf_counter())

    pt.seed(SEED)
    cfg = GPTConfig.gpt2_small()
    cfg.hidden_dropout_prob = cfg.attention_dropout_prob = 0.0
    net = GPTForPretraining(cfg, lm_loss_chunks=LM_CHUNKS).to(device)
    n_params = sum(p.numel() for p in net.parameters())
    numels = [p.numel() for p in net.parameters()]
    n_tensors = len(numels)
    model = Model(net, inputs=["ids", "labels"])
    model.prepare(AdamW(LR, parameters=net.parameters(), weight_decay=WD,
                        multi_precision=True),
                  loss=lambda loss, logits: loss,
                  amp_configs={"level": "O2", "dtype": "bfloat16"})
    rng = np.random.RandomState(SEED)
    tokens = rng.randint(0, cfg.vocab_size,
                         (BATCH * (WARM_STEPS + TIMED_STEPS), SEQ + 1))
    ids, labels = tokens[:, :-1], tokens[:, 1:]       # next-token labels
    split = BATCH * WARM_STEPS

    def fit(i, l, callbacks=None):
        model.fit(pt.io.TensorDataset([i, l]), batch_size=BATCH,
                  shuffle=False, log_freq=1, verbose=0, callbacks=callbacks)

    fit(ids[:split], labels[:split])                  # warm-up
    torch.cuda.synchronize()
    # the peak counts what the steps hold, not what earlier phases left
    # for the garbage collector (an engine's pool in a reference cycle)
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    counters = train_counters()
    reset_counts(counters)
    rec = Record()
    t0 = time.perf_counter()
    fit(ids[split:], labels[split:], [rec])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(counters)
    peak = torch.cuda.max_memory_allocated()
    if len(rec.losses) != TIMED_STEPS or not all(
            math.isfinite(x) for x in rec.losses):
        raise AssertionError(f"train losses {rec.losses}")
    check_launches("train", launches,
                   expected_launches(cfg.num_hidden_layers, numels),
                   TIMED_STEPS)
    check_flash_route("train", counters, "tc")
    check_ln_route("train", (counters["fused_layer_norm"],
                             counters["fused_layer_norm_bwd"]))
    step_ms = np.diff([t0] + rec.stamps) * 1e3
    log(f"train: GPT-2 small ({n_params} parameters in {n_tensors} "
        f"tensors), bf16 O2, AdamW multi_precision, batch {BATCH} x {SEQ}, "
        f"{LM_CHUNKS} loss chunks, Model.fit: {TIMED_STEPS} steps in "
        f"{wall:.3f} s: {BATCH * SEQ * TIMED_STEPS / wall:.1f} tokens/s, "
        f"{wall / TIMED_STEPS * 1e3:.3f} ms per step (wall / steps), "
        f"median step {float(np.median(step_ms)):.3f} ms, max memory "
        f"allocated {peak} bytes ({peak / 2 ** 30:.3f} GiB)")
    log("train losses: " + json.dumps(rec.losses))
    log("train launches: " + json.dumps(launches) + f" over {TIMED_STEPS} "
        f"steps; LayerNorm on the warp-row route: "
        f"{counters['fused_layer_norm'].warp_launches} forward, "
        f"{counters['fused_layer_norm_bwd'].warp_launches} backward")

    rec = Record()                                    # convergence
    fit(np.repeat(ids[:BATCH][None], 4, 0).reshape(-1, SEQ),
        np.repeat(labels[:BATCH][None], 4, 0).reshape(-1, SEQ), [rec])
    if not rec.losses[-1] < rec.losses[0]:
        raise AssertionError(f"a repeated batch did not lower the loss: "
                             f"{rec.losses}")
    log("convergence: one batch repeated, losses " + json.dumps(rec.losses))
    if profile:
        profile_train(model, ids[:BATCH], labels[:BATCH])
    cap = capture_train_operands(model, opt_module, ids[:BATCH],
                                 labels[:BATCH])
    return launches, cap


def phase_f32_check(device):
    """One float32 train step of GPT-2 width at 2 layers, sequence 512,
    batch 2, eager (loss.backward(); opt.step()), on the card (kernels)
    and on a CPU copy of the same weights (plain versions). The loss
    agrees within rtol 1e-5; every gradient within 1e-3 of its tensor's
    largest, but the attention key biases', whose true value is zero (a
    constant per softmax row): there both sides are rounding noise below
    1e-4 of the largest gradient. Every updated parameter agrees within
    2 * lr: Adam's first step is lr * g / (|g| + eps), so an element whose
    gradient's sign is rounding noise may land on the other side, and no
    more than 1e-4 of the elements may differ by more than 1e-6."""
    import copy

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.optimizer import AdamW
    pt.seed(SEED + 2)
    cfg = GPTConfig.gpt2_small()
    cfg.num_hidden_layers = 2
    cfg.hidden_dropout_prob = cfg.attention_dropout_prob = 0.0
    cpu_net = GPTForPretraining(cfg, lm_loss_chunks=LM_CHUNKS)
    nets = {"cpu": (cpu_net, torch.device("cpu")),
            "card": (copy.deepcopy(cpu_net).to(device), device)}
    tokens = np.random.RandomState(SEED + 2).randint(0, cfg.vocab_size,
                                                     (2, 513))
    counters = train_counters()
    out = {}
    for where, (net, dev) in nets.items():      # the card's run last
        reset_counts(counters)
        opt = AdamW(LR, parameters=net.named_parameters(), weight_decay=WD)
        ids, labels = (torch.from_numpy(a).to(dev)
                       for a in (tokens[:, :-1], tokens[:, 1:]))
        loss, _ = net(ids, labels)
        loss.backward()
        grads = {n: p.grad.detach().cpu().clone()
                 for n, p in net.named_parameters()}
        opt.step()
        opt.clear_grad()
        out[where] = (loss.item(), grads,
                    {n: p.detach().cpu().clone()
                     for n, p in net.named_parameters()})
        launches = read_counts(counters)
    check_launches("float32 step on the card", launches, expected_launches(
        2, [g.numel() for g in out["cpu"][1].values()]), 1)
    check_flash_route("float32 step on the card", counters, "cuda_core")
    check_ln_route("float32 step on the card",
                   (counters["fused_layer_norm"],
                    counters["fused_layer_norm_bwd"]))
    (l_cpu, g_cpu, p_cpu), (l_gpu, g_gpu, p_gpu) = out["cpu"], out["card"]
    if not abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu):
        raise AssertionError(f"float32 loss {l_gpu} on the card, {l_cpu} "
                             f"on the CPU")
    top = max(g.abs().max().item() for g in g_cpu.values())
    worst_g, off, total, worst_p = 0.0, 0, 0, 0.0
    for name, ref in g_cpu.items():
        diff = (g_gpu[name] - ref).abs().max().item()
        if name.endswith("k_proj.bias"):
            if max(ref.abs().max().item(),
                   g_gpu[name].abs().max().item()) > 1e-4 * top:
                raise AssertionError(f"{name}: gradient not at the "
                                     f"rounding floor")
            continue
        rel = diff / max(ref.abs().max().item(), 1e-30)
        worst_g = max(worst_g, rel)
        if rel > 1e-3:
            raise AssertionError(f"{name}: gradient off by {rel:.3e} of "
                                 f"its largest")
        d = (p_gpu[name] - p_cpu[name]).abs()
        off += int((d > 1e-6).sum())
        total += d.numel()
        worst_p = max(worst_p, d.max().item())
    if worst_p > 2 * LR * (1 + 1e-3) + 1e-6 or off > 1e-4 * total:
        raise AssertionError(f"updated parameters: max diff {worst_p}, "
                             f"{off} of {total} elements off by > 1e-6")
    log(f"float32 check (GPT-2 width, 2 layers, batch 2 x 512, one AdamW "
        f"step, card vs CPU): loss {l_gpu:.6f} vs {l_cpu:.6f}, worst "
        f"gradient error {worst_g:.3e} of its tensor's largest, updated "
        f"parameters max diff {worst_p:.3e}, {off} of {total} elements "
        f"off by > 1e-6; launches {json.dumps(launches)}, flash on the "
        f"CUDA-core route")
    return launches


# ------------------------------------------------------- phases 4b to 4d
# the recipe: 8 batches of BATCH x SEQ tokens for 2 epochs, 2 held-out
# batches evaluated after each epoch
RECIPE_BATCHES, RECIPE_EVAL, RECIPE_EPOCHS = 8, 2, 2
RECIPE_LR, RECIPE_WARMUP, RECIPE_WD = 6e-4, 4, 0.1
# a fresh Model loaded from the recipe's final checkpoint evaluates and
# trains as the live one: the same kernels on the same bits
RESUME_TOL = 1e-6
# the clipped gradients' global norm against the clip norm, relative
CLIP_TOL = 1e-4
FP16_STEPS = 8
# float16 O2 at GPT-2 width cut to 2 layers, card vs CPU: activations in
# float16 (11 bits) rounded at other places by cuBLAS and the CPU's
# products, a loss of ~10.9 whose f16-level noise is ~1e-3 of it
FP16_LOSS_TOL = 2e-2
O1_STEPS = 8
PLAIN = (("ops.ragged_paged_attention", "ragged_paged_attention_plain"),
         ("ops.fused_adamw", "adamw_plain_"),
         ("ops.fused_adamw", "adamw_group_plain_"),
         ("ops.layer_norm", "layer_norm_plain"),
         ("ops.layer_norm", "layer_norm_bwd_plain"),
         ("ops.flash_attention", "flash_attention_fwd_plain"),
         ("ops.flash_attention", "flash_attention_bwd_plain"))


@contextlib.contextmanager
def count_plain():
    """Count the calls of every kernel's plain version while the block
    runs (the wrappers call them by their module's name); yields the
    counts, which must stay 0 on the card."""
    import importlib
    counts = collections.Counter()
    saved = []
    for mod_name, fn_name in PLAIN:
        mod = importlib.import_module(f"paddle_tpu_torch.{mod_name}")
        orig = getattr(mod, fn_name)

        def spy(*a, _orig=orig, _name=fn_name, **kw):
            counts[_name] += 1
            return _orig(*a, **kw)

        saved.append((mod, fn_name, orig))
        setattr(mod, fn_name, spy)
    try:
        yield counts
    finally:
        for mod, fn_name, orig in saved:
            setattr(mod, fn_name, orig)


@contextlib.contextmanager
def adamw_dtypes(opt_module):
    """The (p, g, copy) dtypes of every tensor the optimizers hand K8's
    group wrapper while the block runs, counted by tensor."""
    seen = collections.Counter()
    orig = opt_module.fused_adamw_group_

    def spy(ps, gs, ms, vs, lows, *hyper):
        for p, g, low in zip(ps, gs, lows):
            seen[(str(p.dtype)[6:], str(g.dtype)[6:],
                  None if low is None else str(low.dtype)[6:])] += 1
        return orig(ps, gs, ms, vs, lows, *hyper)

    opt_module.fused_adamw_group_ = spy
    try:
        yield seen
    finally:
        opt_module.fused_adamw_group_ = orig


def gpt2_small(seed, device, layers=None, dtype=None):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    pt.seed(seed)
    cfg = GPTConfig.gpt2_small()
    cfg.hidden_dropout_prob = cfg.attention_dropout_prob = 0.0
    if layers is not None:
        cfg.num_hidden_layers = layers
    return GPTForPretraining(cfg, lm_loss_chunks=LM_CHUNKS).to(device), cfg


def next_token_batches(seed, vocab, rows, seq=None):
    """``rows`` random sequences of ``seq`` (default SEQ) tokens and their
    next-token labels."""
    seq = seq or SEQ
    tokens = np.random.RandomState(seed).randint(0, vocab, (rows, seq + 1))
    return tokens[:, :-1], tokens[:, 1:]


def no_decay(name):
    """The recipe's decay filter: biases and LayerNorm take no decay."""
    return not (name.endswith(".bias") or ".ln_" in name
                or name.startswith("gpt.ln_f"))


def recipe_lr(t):
    """The lr of train step t (0-based) in closed form: linear warmup from
    0 over RECIPE_WARMUP steps, then cosine decay over T_max = all the
    steps, as LinearWarmup(CosineAnnealingDecay) computes it."""
    if t < RECIPE_WARMUP:
        return (RECIPE_LR - 0.0) * t / RECIPE_WARMUP + 0.0
    t_max = RECIPE_BATCHES * RECIPE_EPOCHS
    return 0 + (RECIPE_LR - 0) * (
        1 + math.cos(math.pi * (t - RECIPE_WARMUP) / t_max)) / 2


def predicted_loss(model, data):
    """The mean over ``data``'s batches of the network's own loss, the
    first of ``Model.predict``'s outputs (GPT fed ``(ids, labels)``)."""
    losses = model.predict(data, batch_size=BATCH)[0]
    return float(np.mean([float(x) for x in losses]))


def recipe_model(net, device):
    """``Model`` over ``net`` with the recipe's optimizer, bf16 O2."""
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.lr import (CosineAnnealingDecay,
                                               LinearWarmup)
    sched = LinearWarmup(
        CosineAnnealingDecay(RECIPE_LR,
                             T_max=RECIPE_BATCHES * RECIPE_EPOCHS),
        warmup_steps=RECIPE_WARMUP, start_lr=0.0, end_lr=RECIPE_LR)
    model = Model(net, inputs=["ids", "labels"], device=device)
    model.prepare(AdamW(sched, parameters=net.named_parameters(),
                        weight_decay=RECIPE_WD,
                        apply_decay_param_fun=no_decay,
                        grad_clip=ClipGradByGlobalNorm(1.0),
                        multi_precision=True),
                  loss=lambda loss, logits: loss,
                  amp_configs={"level": "O2", "dtype": "bfloat16"})
    return model


def step_times(what, card, steps, wall, durations, peak):
    """The phase's line: tokens/s and ms a step over the train steps
    (wall / steps, and the median step), peak memory, the card."""
    log(f"{what}: {steps} steps in {wall:.3f} s: "
        f"{BATCH * SEQ * steps / wall:.1f} tokens/s, "
        f"{wall / steps * 1e3:.3f} ms per step (wall / steps), median step "
        f"{float(np.median(durations)) * 1e3:.3f} ms, max memory allocated "
        f"{peak} bytes ({peak / 2 ** 30:.3f} GiB) on {card}")


def phase_recipe(device, card):
    """4b: GPT-2 small trained through Model.fit the way it is trained:
    warmup then cosine decay, a global-norm clip at 1.0, no decay on
    biases and LayerNorm, AdamW with f32 masters, bf16 O2, a held-out
    evaluation after each epoch, checkpoints, then a resume from the
    final one. Returns the fit's launches."""
    import tempfile

    import paddle_tpu_torch as pt
    import paddle_tpu_torch.optimizer.optimizer as opt_module
    from paddle_tpu_torch.callbacks import Callback, History

    class Steps(Callback):
        """Each step's lr (before the scheduler steps), loss and time, and
        each evaluation's loss."""

        def __init__(self):
            super().__init__()
            self.lr, self.loss, self.spans, self.evals = [], [], [], []

        def on_eval_end(self, logs=None):
            self.evals.append(logs["loss"])

        def on_train_batch_begin(self, step, logs=None):
            self._t0 = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            self.spans.append(time.perf_counter() - self._t0)
            self.lr.append(self.model._optimizer.get_lr())
            self.loss.append(logs["loss"])

    gc.collect()
    net, cfg = gpt2_small(SEED + 4, device)
    numels = [p.numel() for p in net.parameters()]
    model = recipe_model(net, device)
    norms = []
    clip = model._optimizer._grad_clip
    clip_with_norm = clip.clip_with_norm

    def watched(pairs):
        out, norm = clip_with_norm(pairs)
        norms.append(norm.detach())
        return out, norm

    clip.clip_with_norm = watched
    rows = BATCH * (RECIPE_BATCHES + RECIPE_EVAL)
    ids, labels = next_token_batches(SEED + 4, cfg.vocab_size, rows)
    split = BATCH * RECIPE_BATCHES
    train = pt.io.TensorDataset([ids[:split], labels[:split]])
    held = pt.io.TensorDataset([ids[split:], labels[split:]])
    steps = RECIPE_BATCHES * RECIPE_EPOCHS
    evals = RECIPE_EPOCHS * RECIPE_EVAL
    rec, hist = Steps(), History()
    counters = train_counters()
    with tempfile.TemporaryDirectory() as save_dir:
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(counters)
        with count_plain() as plain, adamw_dtypes(opt_module) as kinds:
            t0 = time.perf_counter()
            model.fit(train, eval_data=held, batch_size=BATCH,
                      epochs=RECIPE_EPOCHS, eval_freq=1, log_freq=1,
                      save_dir=save_dir, save_freq=2, shuffle=False,
                      verbose=0, callbacks=[rec, hist])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = read_counts(counters)
        peak = torch.cuda.max_memory_allocated()
        per_step = expected_launches(cfg.num_hidden_layers, numels)
        want = {k: v * steps for k, v in per_step.items()}
        # each evaluated batch runs the forward kernels once more
        want["flash_attention_fwd"] += cfg.num_hidden_layers * evals
        want["fused_layer_norm"] += (2 * cfg.num_hidden_layers + 1) * evals
        if launches != want or sum(plain.values()):
            raise AssertionError(f"recipe: launches {launches}, plain "
                                 f"versions {dict(plain)}; expected {want} "
                                 f"and no plain call")
        if set(kinds) != {("float32", "bfloat16", "bfloat16")}:
            raise AssertionError(f"recipe: AdamW launches {dict(kinds)}")
        check_flash_route("recipe", counters, "tc")
        check_ln_route("recipe", (counters["fused_layer_norm"],
                                  counters["fused_layer_norm_bwd"]))
        files = sorted(os.listdir(save_dir))
        if files != ["0.pdopt", "0.pdparams", "final.pdopt",
                     "final.pdparams"]:
            raise AssertionError(f"recipe checkpoints: {files}")
        want_lr = [recipe_lr(t) for t in range(steps)]
        if len(rec.lr) != steps or not all(
                math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0)
                for a, b in zip(rec.lr, want_lr)):
            raise AssertionError(f"recipe lr {rec.lr}, closed form "
                                 f"{want_lr}")
        pre_clip = [float(n) for n in norms]
        if len(pre_clip) != steps or not all(
                math.isfinite(x) for x in rec.loss + pre_clip):
            raise AssertionError(f"recipe: pre-clip norms {pre_clip}, "
                                 f"losses {rec.loss}")
        # GPT takes its labels among its inputs (an inputs-only spec):
        # fit's evaluations, evaluate and eval_batch give 0.0, as in the
        # JAX package; the held-out loss is predict's first output, the
        # network's own loss
        per = [model.eval_batch([ids[i:i + BATCH], labels[i:i + BATCH]])
               for i in range(split, rows, BATCH)]
        if len(hist.history.get("loss", ())) != RECIPE_EPOCHS \
                or rec.evals != [0.0] * RECIPE_EPOCHS \
                or model.evaluate(held, batch_size=BATCH,
                                  verbose=0) != {"loss": 0.0} \
                or per != [0.0] * RECIPE_EVAL or model.stop_training:
            raise AssertionError(f"recipe: history {hist.history}, "
                                 f"evaluations {rec.evals}, eval_batch "
                                 f"{per}")
        held_loss = predicted_loss(model, held)
        if not math.isfinite(held_loss):
            raise AssertionError(f"recipe: held-out loss {held_loss}")
        # a fresh Model from the final checkpoint
        fresh_net, _ = gpt2_small(SEED + 5, device)
        fresh = recipe_model(fresh_net, device)
        fresh.load(os.path.join(save_dir, "final"))
    diffs = {}
    got = predicted_loss(fresh, held)
    diffs["held-out loss"] = abs(got - held_loss) / abs(held_loss)
    for i in range(2):
        b = [ids[i * BATCH:(i + 1) * BATCH], labels[i * BATCH:(i + 1) * BATCH]]
        live_loss, fresh_loss = model.train_batch(b), fresh.train_batch(b)
        diffs[f"train step {i + 1}"] = abs(fresh_loss - live_loss) / abs(
            live_loss)
    if fresh._optimizer._step_count != model._optimizer._step_count or \
            max(diffs.values()) > RESUME_TOL:
        raise AssertionError(f"resume from the final checkpoint: relative "
                             f"differences {diffs}, limit {RESUME_TOL}")
    del fresh, fresh_net
    bite = clip_bites(model, clip, clip_with_norm, pre_clip,
                      [ids[:BATCH], labels[:BATCH]])
    step_times(f"recipe: GPT-2 small, bf16 O2, Model.fit with warmup + "
               f"cosine lr, clip 1.0, batch {BATCH} x {SEQ}, "
               f"{RECIPE_EPOCHS} epochs x {RECIPE_BATCHES} batches",
               card, steps, sum(rec.spans), rec.spans, peak)
    log(f"recipe: fit {wall:.3f} s in all (with {evals} evaluated batches "
        f"and 2 checkpoints); losses {json.dumps(rec.loss)}; evaluate's "
        f"loss after each epoch {json.dumps(rec.evals)} (no label batch: "
        f"0.0, as in the JAX package); held-out loss from predict "
        f"{held_loss:.6f}; lr "
        f"{json.dumps(rec.lr)}; pre-clip "
        f"global norms {json.dumps(pre_clip)} (clipped at 1.0 in "
        f"{sum(x > 1.0 for x in pre_clip)} of {steps} steps)")
    log(f"recipe launches: {json.dumps(launches)} over {steps} steps and "
        f"{evals} evaluated batches, plain versions {dict(plain)}; resume "
        f"from the final checkpoint, relative differences "
        f"{json.dumps(diffs)} (limit {RESUME_TOL}); {bite}")
    del model, net
    return launches


def clip_bites(model, clip, clip_with_norm, pre_clip, batch):
    """One more step of the recipe's model with the clip norm set to half
    the smallest pre-clip norm the fit saw: the gradients the optimizer
    receives have that global norm within CLIP_TOL. The scale multiplies
    in float32 and each bf16 element rounds once, independently, so the
    norm moves by far less than a bf16 ulp (2**-8); a scale rounded to
    bf16 first would move it by up to 2**-9. Returns the line's text."""
    target = 0.5 * min(pre_clip)
    seen = []

    def watched(pairs):
        out, norm = clip_with_norm(pairs)
        post = torch._foreach_norm([g for _, g in out], 2,
                                   dtype=torch.float32)
        seen.append((float(norm), float(torch.linalg.vector_norm(
            torch.stack(post)))))
        return out, norm

    clip.clip_with_norm, clip.clip_norm = watched, target
    try:
        model.train_batch(batch)
    finally:
        clip.clip_with_norm, clip.clip_norm = clip_with_norm, 1.0
    (pre, post), = seen
    if not (pre > target and abs(post - target) <= CLIP_TOL * target):
        raise AssertionError(f"clip at {target}: norm {pre} before, {post} "
                             f"after")
    return (f"a step clipped at {target:.6f}: global norm {pre:.6f} before, "
            f"{post:.6f} after")


def fp16_step(net, opt, scaler, ids, labels, device):
    """One step of the float16 eager loop; returns the loss (a device
    scalar) and whether the scaler found a non-finite gradient."""
    from paddle_tpu_torch import amp
    ids, labels = (torch.from_numpy(a).to(device) for a in (ids, labels))
    with amp.auto_cast(level="O2", dtype="float16"):
        loss, _ = net(ids, labels)
    scaler.scale(loss).backward()
    scaler.step(opt)
    found = scaler.state()["found_inf"]
    scaler.update()
    opt.clear_grad()
    return loss.detach(), found


def fp16_loop(net, device, rows_ids, rows_labels, batch):
    """The eager float16 O2 loop of phase 4c over ``batch``-row batches;
    returns the optimizer, the scaler, and per step the loss, the scale
    after it and whether it was skipped."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.optimizer import AdamW
    amp.decorate(net, level="O2", dtype="float16")
    opt = AdamW(LR, parameters=net.named_parameters(), weight_decay=WD,
                multi_precision=True)
    scaler = amp.GradScaler(init_loss_scaling=2. ** 15,
                            decr_every_n_nan_or_inf=1)
    trace, stamps = [], [time.perf_counter()]
    for i in range(0, len(rows_ids), batch):
        loss, found = fp16_step(net, opt, scaler, rows_ids[i:i + batch],
                                rows_labels[i:i + batch], device)
        trace.append((loss, scaler.get_loss_scaling(), found))
        stamps.append(time.perf_counter())   # the scaler read its flag
    return opt, scaler, [(float(l), s, f) for l, s, f in trace], \
        np.diff(stamps)


def phase_fp16(device, card):
    """4c: GPT-2 small in float16 O2 through the eager loop with dynamic
    loss scaling, then one step whose gradient is made non-finite (a hook
    on one parameter's gradient), then the loop goes on. Returns the
    loop's launches."""
    import paddle_tpu_torch.optimizer.optimizer as opt_module
    gc.collect()
    net, cfg = gpt2_small(SEED + 6, device)
    numels = [p.numel() for p in net.parameters()]
    n_tensors = len(numels)
    ids, labels = next_token_batches(SEED + 6, cfg.vocab_size,
                                     BATCH * (FP16_STEPS + 2))
    loop = BATCH * FP16_STEPS
    counters = train_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    with count_plain() as plain, adamw_dtypes(opt_module) as kinds:
        t0 = time.perf_counter()
        opt, scaler, trace, spans = fp16_loop(net, device, ids[:loop],
                                              labels[:loop], BATCH)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_counts(counters)
    peak = torch.cuda.max_memory_allocated()
    applied = sum(not found for _, _, found in trace)
    per_step = expected_launches(cfg.num_hidden_layers, numels)
    want = {k: v * (applied if k.startswith("fused_adamw") else FP16_STEPS)
            for k, v in per_step.items()}
    if launches != want or sum(plain.values()) or not applied:
        raise AssertionError(f"float16 loop: launches {launches}, plain "
                             f"versions {dict(plain)}, {applied} steps "
                             f"applied; expected {want}")
    if set(kinds) != {("float32", "float16", "float16")}:
        raise AssertionError(f"float16 loop: AdamW launches {dict(kinds)}")
    check_flash_route("float16 loop", counters, "tc")
    check_ln_route("float16 loop", (counters["fused_layer_norm"],
                                    counters["fused_layer_norm_bwd"]))
    if not all(math.isfinite(l) for l, _, _ in trace):
        raise AssertionError(f"float16 loop losses {trace}")

    # one step with a non-finite gradient: nothing moves, the scale halves
    state = [t.clone() for t in net.parameters()] + [
        t.clone() for slots in opt._slots.values() for t in slots.values()]
    steps_before, scale_before = opt._step_count, scaler.get_loss_scaling()
    victim = net.gpt.blocks[0].attn.q_proj.weight
    hook = victim.register_hook(lambda g: g * float("inf"))
    reset_counts(counters)
    _, found = fp16_step(net, opt, scaler, ids[loop:loop + BATCH],
                         labels[loop:loop + BATCH], device)
    hook.remove()
    after = [t for t in net.parameters()] + [
        t for slots in opt._slots.values() for t in slots.values()]
    same = all(torch.equal(a, b) for a, b in zip(state, after))
    if not (found and same and len(after) == len(state)
            and counters["fused_adamw"].launches == 0
            and counters["fused_adamw"].tensors == 0
            and opt._step_count == steps_before
            and scaler.get_loss_scaling() == max(scale_before * 0.5, 1.0)):
        raise AssertionError(
            f"non-finite step: found {found}, state unchanged {same}, "
            f"AdamW launches {counters['fused_adamw'].launches}, step "
            f"{opt._step_count} (was {steps_before}), scale "
            f"{scaler.get_loss_scaling()} (was {scale_before})")
    del state, after
    held = victim.detach().clone()
    reset_counts(counters)
    loss, found = fp16_step(net, opt, scaler, ids[loop + BATCH:],
                            labels[loop + BATCH:], device)
    moved = opt._step_count == steps_before + 1 and \
        not torch.equal(victim, held)
    if found or not moved or not math.isfinite(float(loss)) or (
            counters["fused_adamw"].launches,
            counters["fused_adamw"].tensors) != (per_step["fused_adamw"],
                                                 n_tensors):
        raise AssertionError(f"after the non-finite step: found {found}, "
                             f"step {opt._step_count}, AdamW launches "
                             f"{counters['fused_adamw'].launches} over "
                             f"{counters['fused_adamw'].tensors} tensors")
    step_times(f"float16 O2 eager loop: GPT-2 small, AdamW multi_precision,"
               f" GradScaler(2**15), batch {BATCH} x {SEQ}", card,
               FP16_STEPS, wall, spans, peak)
    log(f"float16 loop: (loss, scale after, skipped) per step "
        f"{json.dumps(trace)}; launches {json.dumps(launches)}, plain "
        f"versions {dict(plain)}, AdamW (p, g, copy) dtypes {dict(kinds)}; "
        f"the injected non-finite step: nothing moved, no AdamW launch, "
        f"scale {scale_before} -> {scale_before * 0.5}; the next step "
        f"applied (loss {float(loss):.6f})")
    del net, opt
    return launches


def phase_fp16_check(device):
    """4c, then: the float16 loop at GPT-2 width cut to 2 layers, batch 2
    x 128, on the card and on a CPU copy of the same weights (plain
    versions): the losses within FP16_LOSS_TOL and the same loss-scale
    trajectory."""
    import copy
    cpu_net, cfg = gpt2_small(SEED + 7, torch.device("cpu"), layers=2)
    ids, labels = next_token_batches(SEED + 7, cfg.vocab_size,
                                     2 * FP16_STEPS, seq=128)
    out = {}
    for where, net, dev in (("card", copy.deepcopy(cpu_net).to(device),
                             device),
                            ("cpu", cpu_net, torch.device("cpu"))):
        out[where] = fp16_loop(net, dev, ids, labels, 2)[2]
    diff = max(abs(a[0] - b[0]) for a, b in zip(out["card"], out["cpu"]))
    scales = [[s for _, s, _ in out[w]] for w in ("card", "cpu")]
    if diff > FP16_LOSS_TOL or scales[0] != scales[1]:
        raise AssertionError(f"float16 2-layer loop, card vs CPU: "
                             f"{out}; largest loss difference {diff}")
    log(f"float16 check (GPT-2 width, 2 layers, batch 2 x 128, "
        f"{FP16_STEPS} steps of the loop, card vs CPU): largest loss "
        f"difference {diff:.3e} (limit {FP16_LOSS_TOL}), loss scales "
        f"{scales[0]} on both; card {json.dumps(out['card'])}")


def phase_o1(device, card):
    """4d: GPT-2 small at bf16 O1 through Model.fit: float32 parameters
    and no master (K8 on f32 p and f32 g), attention in bf16 on the
    tensor-core route, 8 steps over one repeated batch."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.optimizer.optimizer as opt_module
    from paddle_tpu_torch.callbacks import Callback
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.optimizer import AdamW

    class Steps(Callback):
        def __init__(self):
            super().__init__()
            self.loss, self.spans = [], []

        def on_train_batch_begin(self, step, logs=None):
            self._t0 = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            self.spans.append(time.perf_counter() - self._t0)
            self.loss.append(logs["loss"])

    gc.collect()
    net, cfg = gpt2_small(SEED + 8, device)
    numels = [p.numel() for p in net.parameters()]
    model = Model(net, inputs=["ids", "labels"], device=device)
    model.prepare(AdamW(LR, parameters=net.named_parameters(),
                        weight_decay=WD, multi_precision=True),
                  loss=lambda loss, logits: loss,
                  amp_configs={"level": "O1", "dtype": "bfloat16"})
    ids, labels = next_token_batches(SEED + 8, cfg.vocab_size, BATCH)
    data = pt.io.TensorDataset([np.tile(ids, (O1_STEPS, 1)),
                                np.tile(labels, (O1_STEPS, 1))])
    counters = train_counters()
    rec = Steps()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    with count_plain() as plain, adamw_dtypes(opt_module) as kinds:
        t0 = time.perf_counter()
        model.fit(data, batch_size=BATCH, shuffle=False, log_freq=1,
                  verbose=0, callbacks=[rec])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_counts(counters)
    peak = torch.cuda.max_memory_allocated()
    if any(p.dtype != torch.float32 for p in net.parameters()) or any(
            "master_weight" in s for s in model._optimizer._slots.values()):
        raise AssertionError("O1: parameters must stay float32 without "
                             "masters")
    check_launches("O1", launches,
                   expected_launches(cfg.num_hidden_layers, numels),
                   O1_STEPS)
    if sum(plain.values()) or set(kinds) != {("float32", "float32", None)}:
        raise AssertionError(f"O1: plain versions {dict(plain)}, AdamW "
                             f"launches {dict(kinds)}")
    check_flash_route("O1", counters, "tc")
    check_ln_route("O1", (counters["fused_layer_norm"],
                          counters["fused_layer_norm_bwd"]))
    if len(rec.loss) != O1_STEPS or not all(
            math.isfinite(x) for x in rec.loss) \
            or not rec.loss[-1] < rec.loss[0]:
        raise AssertionError(f"O1 losses on a repeated batch: {rec.loss}")
    step_times(f"bf16 O1: GPT-2 small, float32 parameters, Model.fit, batch "
               f"{BATCH} x {SEQ}, one batch repeated", card, O1_STEPS,
               wall, rec.spans, peak)
    log(f"O1 losses {json.dumps(rec.loss)}; launches {json.dumps(launches)}"
        f", plain versions {dict(plain)}, AdamW (p, g, copy) dtypes "
        f"{dict(kinds)}")
    del model, net
    return launches


def check_train_operands(cap):
    """The training kernels against their plain versions on the operands
    of one real step (layer 0's attention and first LayerNorm, the token
    embedding's AdamW), each output relative to its scale
    (``check_scaled``); returns the worst relative error per kernel."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import layer_norm as ln
    from paddle_tpu_torch.ops.fused_adamw import adamw_plain_, fused_adamw_
    q, k, v = cap["qkv"]
    do = cap["do"]
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, True)
    torch.cuda.synchronize()
    want_o, want_lse = fa.flash_attention_fwd_plain(q, k, v, True)
    err = {"flash_attention_fwd": max(
        check_scaled("flash forward o", o, want_o, q.dtype),
        check_scaled("flash forward lse", lse, want_lse, torch.float32))}
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, True)
    err["flash_attention_bwd"] = max(
        check_scaled(f"flash backward d{n}", g, w, q.dtype)
        for n, g, w in zip("qkv", grads, want))
    del o, lse, grads, want_o, want_lse, want
    x, w = cap["ln"]
    d = x.shape[-1]
    x, g = x.reshape(-1, d), cap["ln_g"].reshape(-1, d)
    got = ln.fused_layer_norm_bwd(x, w, g)
    torch.cuda.synchronize()
    err["fused_layer_norm_bwd"] = max(
        check_scaled(f"LayerNorm backward {n}", a, b, x.dtype)
        for n, a, b in zip(("dx", "dw", "db"), got,
                           ln.layer_norm_bwd_plain(x, w, g)))
    (p, g, m, v_), low, hyper = cap["adamw"]
    ops = [t.clone() for t in (p, m, v_, low)]
    ref = [t.clone() for t in (p, m, v_, low)]
    fused_adamw_(ops[0], g, ops[1], ops[2], *hyper, low=ops[3])
    torch.cuda.synchronize()
    adamw_plain_(ref[0], g, ref[1], ref[2], *hyper, low=ref[3])
    err["fused_adamw"] = max(
        check_scaled(f"AdamW {n}", a, b, a.dtype)
        for n, a, b in zip(("p", "m", "v", "bf16 copy"), ops, ref))
    log(f"train step layer 0: q/k/v/dO {tuple(q.shape)} {q.dtype}, "
        f"LayerNorm x {tuple(x.shape)} {x.dtype}, AdamW p "
        f"{tuple(p.shape)} {p.dtype} grad {g.dtype}; kernel vs plain, max "
        f"|error| over max |plain| (limits {REL_TOL[torch.float32]} f32, "
        f"{REL_TOL[torch.bfloat16]} bf16): " + json.dumps(err))
    return err


TRAIN_ROWS = (
    ("flash_attention_fwd", FA_TC_SRC, FA_FWD_TPU),
    ("flash_attention_bwd", FA_TC_SRC, FA_BWD_TPU),
    ("flash_attention_fwd_f32", FA_SRC, FA_FWD_TPU),
    ("flash_attention_bwd_f32", FA_SRC, FA_BWD_TPU),
    ("fused_layer_norm_train", LN_SRC, LN_TPU),
    ("fused_layer_norm_bwd", LN_SRC, LN_BWD_TPU),
    ("fused_adamw", ADAMW_SRC, ADAMW_TPU),
    ("flash_attention_fwd_f16", FA_TC_SRC, FA_FWD_TPU),
    ("flash_attention_bwd_f16", FA_TC_SRC, FA_BWD_TPU),
    ("fused_layer_norm_f16", LN_SRC, LN_TPU),
    ("fused_layer_norm_bwd_f16", LN_SRC, LN_BWD_TPU),
    ("fused_adamw_f16", ADAMW_SRC, ADAMW_TPU),
    ("fused_adamw_f32", ADAMW_SRC, ADAMW_TPU),
    ("fused_adamw_step", ADAMW_SRC, ADAMW_TPU))
# a whole-list K8 row's extra keys (adamw_step_case)
STEP_KEYS = ("launches_per_step", "tensors_per_step", "host_us")
# why a step row's launches are also in a dtype row
STEP_NOTE = ("the launches of the path whose parameter list the row "
             "times (phase 4's timed steps; phase 6's fit); the dtype "
             "rows of K8 count them too")

# why a float16 row counts no launch on the main path
F16_LN_NOTE = ("LayerNorm is on the AMP black list: the float16 paths run "
               "it in float32 (fused_layer_norm_train, fused_layer_norm_bwd)")


def train_rows(counts, main):
    """The kernels line's rows of the training kernels: phase 2's
    measurements at the train path's shapes, one row per dtype (the
    LayerNorm forward's f32 one as ``fused_layer_norm_train``), each with
    the launches ``counts`` gives it from the paths that ran it."""
    rows = []
    for name, src, tpu in TRAIN_ROWS:
        row = main[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": tpu, "launches": counts[name],
                     "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                     "plain_ms": row["plain_ms"],
                     "bound_ms": row["bound_ms"],
                     "bound_by": row["bound_by"],
                     "library_ms": row["library_ms"]})
        if "core_ms" in row:   # the CUDA-core kernels on the same operands
            rows[-1].update(core_source=FA_SRC, core_ms=row["core_ms"],
                            core_err=row["core_err"])
        if name in ("fused_layer_norm_f16", "fused_layer_norm_bwd_f16"):
            rows[-1]["launches_note"] = F16_LN_NOTE
        if "host_us" in row:
            rows[-1].update({k: row[k] for k in STEP_KEYS},
                            launches_note=STEP_NOTE)
    return rows


# ---------------------------------------------------------------------------
# phase 5: observability on the card
# ---------------------------------------------------------------------------

#: where the phases' traces go (a fresh temporary directory, removed at
#: the end of the run)
TRACE_ROOT = None
OBS_STEPS = 6                 # phase 5 (ii): steps of the audited fit
OBS_WINDOW = (1, 4)           # its profiled steps [start, stop)
OBS_SYNC_FREE = (2, 4)        # its steps run under sync debug "error"
OBS_INJECT_AT = 6             # the global step whose loss becomes inf
OBS_OOM_BATCH = 512           # a batch of 512 x 1024 cannot fit
#: the kernels of each path, by their names in the device trace
K_SERVE = {"rpa_tc_kernel": "launches", "rpa_tc_combine_kernel":
           "combine_launches", "ln_fwd_warp_kernel": "warp_launches"}


def kernel_calls(table, name):
    """Launches of the kernel ``name`` in a ``device_op_table``: rows
    whose name holds it, demangled (``(anonymous namespace)::name<...>``)
    or mangled (``...18ln_fwd_warp_kernelI...``, as a record whose name
    was not demangled carries it). No kernel name of the port holds
    another's."""
    return sum(r["calls"] for r in table if name in r["name"])


def trace_ends(prof, table, names, n=6):
    """The first and last ``n`` device events of a profiler's trace, at
    microseconds from its anchor annotation, and the table's rows of the
    kernels ``names`` (for a failure message)."""
    from paddle_tpu_torch.profiler import device_trace
    evs = device_trace.device_events(prof.trace_dir)
    anchor = device_trace.trace_anchor_us(prof.trace_dir) or 0.0
    fmt = [f"{e['name'][:40]}@{e['t_us'] - anchor:.1f}"
           for e in evs[:n] + evs[-n:]]
    odd = sorted({e["name"][:80] for e in evs
                  if e["name"].startswith("_Z") or "nknown" in e["name"]})
    rows = {r["name"][:100]: r["calls"] for r in table
            if any(k in r["name"] for k in names)}
    return (f"{len(evs)} device events; first and last: {fmt}; names not "
            f"demangled: {odd}; rows {rows}")


def gated_serve(eng, prompts, max_new):
    """Submit every prompt, then let the scheduler admit them together:
    one schedule, whatever the submitting thread's speed, so two runs
    give the same tokens. Returns (outputs, handles, wall seconds)."""
    gate = threading.Event()
    admit = eng._sched._admit

    def gated():
        gate.wait(60)
        admit()

    eng._sched._admit = gated
    t0 = time.perf_counter()
    handles = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    gate.set()
    outs = [h.result(timeout=600) for h in handles]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    settle(eng)
    eng._sched._admit = admit
    return outs, handles, wall


def observe_serve_run(model, prompts, armed):
    """Phase 3's 16 requests (64 new tokens) through a fresh fused bf16
    engine, gated to one schedule, with the serving kernels' counts set
    to 0 just before and read just after; ``armed``: under the port's
    ``Profiler`` (CPU and GPU targets) and a span session whose spans
    also enter the device trace."""
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.ops.layer_norm import fused_layer_norm
    from paddle_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention)
    from paddle_tpu_torch.profiler import memory
    from paddle_tpu_torch.serving import GenerationEngine
    vocab = model.gpt.cfg.vocab_size
    eng = GenerationEngine(model, kv_layout="paged", attention="fused",
                           num_slots=8, prefill_budget=256, seed=SEED,
                           block_size=16,
                           device=next(model.parameters()).device)
    eng.submit(np.random.RandomState(SEED + 9).randint(0, vocab, 24),
               max_new_tokens=4).result(timeout=300)
    settle(eng)
    s0 = eng.stats()
    cycles0 = eng.flight_recorder.cycles_recorded
    for attr in RPA_COUNTS:
        setattr(ragged_paged_attention, attr, 0)
    fused_layer_norm.launches = fused_layer_norm.warp_launches = 0
    fused_layer_norm.row_launches = 0
    prof = None
    with contextlib.ExitStack() as stack:
        if armed:
            prof = stack.enter_context(device_profile())
            stack.enter_context(profiler.profile(jax_bridge=True))
        outs, handles, wall = gated_serve(eng, prompts, 64)
    counts = {"launches": ragged_paged_attention.launches,
              "tc_launches": ragged_paged_attention.tc_launches,
              "combine_launches": ragged_paged_attention.combine_launches,
              "quant_launches": ragged_paged_attention.quant_launches,
              "warp_launches": fused_layer_norm.warp_launches,
              "fused_layer_norm": fused_layer_norm.launches}
    memory.sample("phase 5")
    cross = memory.crosscheck()
    stats = eng.stats()
    run = {"outs": outs, "wall": wall, "counts": counts, "prof": prof,
           "stats": stats, "cross": cross,
           "steps": stats["steps"] - s0["steps"],
           "cycles": eng.flight_recorder.cycles_recorded - cycles0,
           "events": profiler.events() if armed else None,
           "tokens": sum(len(h.tokens) for h in handles)}
    eng.close()
    return run


def phase_observe_serve(model, prompts, phase3_outs):
    """Phase 5 (i): the fused engine serves phase 3's requests with the
    profiler armed and unarmed: equal tokens (and phase 3's before each
    request's first near-tie), the device-op table's K1 and K2 launches
    equal to the wrappers' counters, every cycle's span with its
    children, the unified trace's four kinds of events, stats()'s FLOPs
    and MFU, the ledger's gap, and tokens/s both ways. Returns the armed
    run's launches."""
    from paddle_tpu_torch.profiler import memory
    L = model.gpt.cfg.num_hidden_layers
    memory.start_sampler(0.05)
    try:
        plain = observe_serve_run(model, prompts, armed=False)
        run = observe_serve_run(model, prompts, armed=True)
    finally:
        memory.stop_sampler()
    for i, (a, b) in enumerate(zip(run["outs"], plain["outs"])):
        if not np.array_equal(a, b):
            raise AssertionError(f"phase 5: request {i}'s tokens changed "
                                 f"with the profiler armed")
    margins = bf16_margins(model, prompts, phase3_outs)
    ties = first_near_tie(margins, SPEC_TIE_TOL)
    full = hold_tokens("phase 5", run["outs"], phase3_outs, prompts, ties)
    check_serve_launches("phase 5 engine", {
        "ragged_paged_attention": run["counts"]["launches"],
        "ragged_paged_attention_quant": run["counts"]["quant_launches"],
        "fused_layer_norm": run["counts"]["fused_layer_norm"]},
        run["steps"], L, quantized=False)
    table = run["prof"].device_op_table()
    seen = {k: kernel_calls(table, k) for k in K_SERVE}
    want = {k: run["counts"][v] for k, v in K_SERVE.items()}
    if seen != want or not all(want.values()):
        raise AssertionError(f"phase 5: device-op table {seen}, the "
                             f"wrappers' counters {want}; "
                             f"{trace_ends(run['prof'], table, K_SERVE)}")
    names = collections.Counter(e["name"] for e in run["events"]
                                if e["cat"] == "serving")
    kids = collections.Counter(e["name"] for e in run["events"]
                               if e["parent"] == "serving/cycle")
    lanes = {e["tid"] for e in run["events"]
             if e["cat"] == "serving/request"}
    if not (names["serving/cycle"] == run["cycles"]
            == kids["serving/sweep"] == kids["serving/admit"]
            and kids["serving/decode_dispatch"] == run["steps"]
            == kids["serving/host_fetch"] and len(lanes) == len(prompts)):
        raise AssertionError(f"phase 5: spans {dict(names)}, children "
                             f"{dict(kids)}, {len(lanes)} lanes, over "
                             f"{run['cycles']} cycles and {run['steps']} "
                             f"steps")
    path = run["prof"].export_unified(
        os.path.join(run["prof"].trace_dir, "unified.json"))
    with open(path) as f:
        doc = json.load(f)["traceEvents"]
    kinds = {"host spans": sum(e.get("cat") == "serving" for e in doc),
             "request lanes": sum(e.get("cat") == "serving/request"
                                  for e in doc),
             "memory counters": sum(e.get("ph") == "C" for e in doc),
             "device events": sum(e.get("cat") == "device" for e in doc)}
    if not all(kinds.values()):
        raise AssertionError(f"phase 5: the unified trace lacks a kind: "
                             f"{kinds}")
    clock = {e["args"]["clock"] for e in doc if e.get("cat") == "device"}
    from paddle_tpu_torch.profiler import device_trace
    d = run["prof"].trace_dir
    ends = (device_trace.trace_anchor_us(d, device=True),
            device_trace.trace_anchor_us(d))
    skew = None if None in ends else round(ends[0] - ends[1], 1)
    st = run["stats"]
    for k in ("model_flops_per_token", "serving_mfu",
              "serving_flops_per_sec", "decode_tokens_per_sec"):
        if not (st.get(k) or 0) > 0:
            raise AssertionError(f"phase 5: stats() has no {k}: {st}")
    cross = run["cross"]
    busy = sum(r["total_us"] for r in table) / 1e3
    log(f"phase 5 (i) observe serve: {len(prompts)} requests x 64 tokens, "
        f"{run['steps']} fused launches in {run['cycles']} cycles; tokens "
        f"armed = unarmed, = phase 3's before each first near-tie "
        f"(equal in full in {full} of {len(prompts)}); tokens/s unarmed "
        f"{plain['tokens'] / plain['wall']:.1f}, armed "
        f"{run['tokens'] / run['wall']:.1f} "
        f"({run['wall'] / plain['wall']:.3f}x the wall)")
    log(f"phase 5 (i) device-op table = counters: {json.dumps(seen)}; "
        f"spans: {dict(names)}; {len(lanes)} request lanes; device busy "
        f"{busy:.3f} ms of {run['wall'] * 1e3:.3f} ms wall (idle share "
        f"{1 - busy / (run['wall'] * 1e3):.4f})")
    log(f"phase 5 (i) unified trace {os.path.getsize(path)} bytes: "
        f"{json.dumps(kinds)}, device clock {sorted(clock)}; the anchor's "
        f"device-side start {skew} us after its host-side start")
    log(f"phase 5 (i) stats: model_flops_per_token "
        f"{st['model_flops_per_token']:.1f}, decode_bytes_per_token "
        f"{st.get('decode_bytes_per_token', 0):.1f}, decode_tokens_per_sec "
        f"{st['decode_tokens_per_sec']:.1f}, serving_flops_per_sec "
        f"{st['serving_flops_per_sec']:.4e}, serving_mfu "
        f"{st['serving_mfu']:.6f} (unarmed run: "
        f"{plain['stats']['serving_mfu']:.6f})")
    log(f"phase 5 (i) ledger crosscheck: ledger {cross['ledger_bytes']} "
        f"bytes, device in use {cross['device_bytes_in_use']}, gap "
        f"(unexplained) {cross['unexplained_bytes']} bytes, explained "
        f"ratio {cross['explained_ratio']:.4f}")
    return run["counts"]


def phase_observe_train(device, card):
    """Phase 5 (ii): GPT-2 small, bf16 O2, batch 8 x 1024 through
    ``Model.fit`` for 6 steps with ``numerics="warn"``, an inf injected
    into the 6th step's loss and a ``ProfilerCallback`` over steps
    [1, 4): exactly one anomaly, with its postmortem; the device-op
    table's K2-K8 launches over the profiled steps equal the wrappers'
    counters; steps 2-4 run under sync debug "error"; ``hapi/mfu``.
    Returns the window's launches."""
    import warnings
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.framework import monitor
    from paddle_tpu_torch.hapi import Callback, Model
    from paddle_tpu_torch.hapi.callbacks import ProfilerCallback
    from paddle_tpu_torch.optimizer import AdamW
    net, cfg = gpt2_small(SEED + 50, device)
    model = Model(net, inputs=["ids", "labels"])
    model.prepare(AdamW(LR, parameters=net.parameters(), weight_decay=WD,
                        multi_precision=True),
                  loss=lambda loss, logits: loss,
                  amp_configs={"level": "O2", "dtype": "bfloat16"})
    ids, labels = next_token_batches(SEED + 51, cfg.vocab_size,
                                     BATCH * OBS_STEPS)
    data = pt.io.TensorDataset([torch.from_numpy(ids).to(device),
                                torch.from_numpy(labels).to(device)])
    counters = train_counters()
    window = {}

    class SyncFree(Callback):
        def on_train_batch_begin(self, step, logs=None):
            if OBS_SYNC_FREE[0] <= step <= OBS_SYNC_FREE[1]:
                torch.cuda.set_sync_debug_mode("error")

        def on_train_batch_end(self, step, logs=None):
            torch.cuda.set_sync_debug_mode(0)

        def on_train_abort(self):
            torch.cuda.set_sync_debug_mode(0)

    class DeviceWindow(Callback):
        def on_train_batch_begin(self, step, logs=None):
            if step == OBS_WINDOW[0]:
                reset_counts(counters)
                window["stack"] = contextlib.ExitStack()
                window["prof"] = window["stack"].enter_context(
                    device_profile())

        def on_train_batch_end(self, step, logs=None):
            if step == OBS_WINDOW[1] - 1:
                window["stack"].close()
                window["counts"] = read_counts(counters)
                window["routes"] = {
                    n: {a: getattr(fn, a) for a in (
                        "tc_launches", "core_launches", "warp_launches",
                        "row_launches") if hasattr(fn, a)}
                    for n, fn in counters.items()}

    trace = os.path.join(TRACE_ROOT, "fit_spans.json")
    prom = os.path.join(TRACE_ROOT, "fit.prom")
    model._numerics_inject_inf_at = OBS_INJECT_AT
    mfu0 = (monitor.stat_histogram("hapi/mfu") or {"count": 0})["count"]
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        model.fit(data, batch_size=BATCH, shuffle=False, verbose=0,
                  numerics="warn", callbacks=[
                      SyncFree(), DeviceWindow(), ProfilerCallback(
                          *OBS_WINDOW, chrome_trace_path=trace,
                          prometheus_path=prom, summary=False, verbose=0)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rec = model._numerics_recorder.snapshot()
    anomalies = rec["anomalies"]
    warned = [w for w in caught if "numerics anomaly" in str(w.message)]
    if [(a["kind"], a["step"]) for a in anomalies] != \
            [("nonfinite", OBS_INJECT_AT)] or len(warned) != 1:
        raise AssertionError(f"phase 5 (ii): anomalies {anomalies}, "
                             f"{len(warned)} warnings")
    dump = model._numerics_recorder.last_dump_path
    with open(dump) as f:
        post = json.load(f)
    if post["anomaly"]["step"] != OBS_INJECT_AT or not os.path.exists(
            post["memory_postmortem"]):
        raise AssertionError(f"phase 5 (ii): postmortem {dump}: "
                             f"{post['anomaly']}")
    steps = OBS_WINDOW[1] - OBS_WINDOW[0]
    counts = window["counts"]
    check_launches("phase 5 (ii) window", counts, expected_launches(
        cfg.num_hidden_layers, [p.numel() for p in net.parameters()]), steps)
    table = window["prof"].device_op_table()
    seen = {"fa_fwd_tc_kernel": kernel_calls(table, "fa_fwd_tc_kernel"),
            "fa_dq_tc_kernel": kernel_calls(table, "fa_dq_tc_kernel"),
            "fa_dkv_tc_kernel": kernel_calls(table, "fa_dkv_tc_kernel"),
            "ln_fwd_warp_kernel": kernel_calls(table, "ln_fwd_warp_kernel"),
            "ln_bwd_warp_kernel": kernel_calls(table, "ln_bwd_warp_kernel"),
            "adamw_kernel": kernel_calls(table, "adamw_kernel")}
    want = {"fa_fwd_tc_kernel": counts["flash_attention_fwd"],
            "fa_dq_tc_kernel": counts["flash_attention_bwd"],
            "fa_dkv_tc_kernel": counts["flash_attention_bwd"],
            "ln_fwd_warp_kernel": counts["fused_layer_norm"],
            "ln_bwd_warp_kernel": counts["fused_layer_norm_bwd"],
            "adamw_kernel": counts["fused_adamw"]}
    routes = window["routes"]
    if seen != want or routes["flash_attention_fwd"]["tc_launches"] != \
            counts["flash_attention_fwd"] or \
            routes["fused_layer_norm"]["warp_launches"] != \
            counts["fused_layer_norm"]:
        raise AssertionError(f"phase 5 (ii): device-op table {seen}, the "
                             f"wrappers' counters {want}, routes {routes}; "
                             f"{trace_ends(window['prof'], table, seen)}")
    with open(trace) as f:
        spans = [e for e in json.load(f)["traceEvents"]
                 if e.get("name") == "hapi/step"]
    if sorted(e["args"]["global_step"] for e in spans) != \
            list(range(*OBS_WINDOW)) or not os.path.getsize(prom):
        raise AssertionError(f"phase 5 (ii): ProfilerCallback wrote "
                             f"{len(spans)} step spans")
    mfu = monitor.stat_histogram("hapi/mfu")
    if mfu is None or mfu["count"] - mfu0 < 2:
        raise AssertionError("phase 5 (ii): no hapi/mfu observed")
    fit_mfu = monitor.histogram_samples("hapi/mfu")[mfu0 - mfu["count"]:]
    fit_fps = monitor.histogram_samples("hapi/flops_per_sec")[
        mfu0 - mfu["count"]:]
    busy = sum(r["total_us"] for r in table) / 1e3
    last = rec["records"][OBS_INJECT_AT - 2]
    log(f"phase 5 (ii) observe train: {OBS_STEPS} steps bf16 O2 {BATCH} x "
        f"{SEQ} in {wall:.3f} s with numerics='warn': 1 anomaly at step "
        f"{OBS_INJECT_AT} ({post['anomaly']['kind']}, "
        f"{len(post['anomaly']['blamed_groups'])} groups blamed), "
        f"postmortem {os.path.getsize(dump)} bytes + memory postmortem; "
        f"step {OBS_INJECT_AT - 1}: grad norm {last['grad_norm']:.4f}, "
        f"update ratio {last['update_ratio']:.3e}; steps "
        f"{OBS_SYNC_FREE[0]}-{OBS_SYNC_FREE[1]} clean under sync debug "
        f"'error'")
    log(f"phase 5 (ii) device-op table over steps {OBS_WINDOW[0]}-"
        f"{OBS_WINDOW[1] - 1} = counters: {json.dumps(seen)}; device busy "
        f"{busy:.3f} ms, {busy / steps:.3f} ms a step; this fit's log "
        f"windows (step 1; steps 2-6 with the profiled ones): hapi/mfu "
        f"{json.dumps(fit_mfu)}, hapi/flops_per_sec {json.dumps(fit_fps)}"
        f" ({card})")
    # what the audit costs: the same steps with numerics off and on
    # (log_freq 10: one window at the first step, one at the end)
    cost = {}
    for mode in ("off", "record", "off", "record"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.fit(data, batch_size=BATCH, shuffle=False, verbose=0,
                  numerics=mode)
        torch.cuda.synchronize()
        cost.setdefault(mode, []).append(
            (time.perf_counter() - t) / OBS_STEPS * 1e3)
    off, on = (min(cost[m]) for m in ("off", "record"))
    from paddle_tpu_torch.framework import program_registry
    flops = model._step_flops[(BATCH, SEQ)]
    peak = program_registry.peak_flops()
    log(f"phase 5 (ii) the audit's cost: {OBS_STEPS}-step fits, ms a step "
        f"(wall / steps, the faster of two): numerics off {off:.3f}, "
        f"record {on:.3f} ({on / off:.3f}x); runs {json.dumps(cost)}; "
        f"{flops:.4e} counted FLOPs a step: MFU at those walls "
        f"{flops / off * 1e3 / peak:.4f} off, {flops / on * 1e3 / peak:.4f} "
        f"record")
    del model, net
    gc.collect()
    return counts


def phase_oom(device):
    """Phase 5 (iii): a ``Model.fit`` whose batch (512 x 1024 on GPT-2
    small, bf16 O2) cannot fit on the card raises the allocator's own
    ``torch.cuda.OutOfMemoryError``; the memory postmortem holds the
    ledger and the largest live tensors."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.profiler import memory
    net, cfg = gpt2_small(SEED + 60, device)
    model = Model(net, inputs=["ids", "labels"])
    model.prepare(AdamW(LR, parameters=net.parameters(),
                        multi_precision=True),
                  loss=lambda loss, logits: loss,
                  amp_configs={"level": "O2", "dtype": "bfloat16"})
    ids = torch.randint(0, cfg.vocab_size, (OBS_OOM_BATCH, SEQ),
                        device=device)
    dumps = memory.tracker().dumps
    raised = None
    try:
        model.fit(pt.io.TensorDataset([ids, ids]), batch_size=OBS_OOM_BATCH,
                  verbose=0)
    except torch.cuda.OutOfMemoryError as e:
        raised = repr(e)[:160]
    if raised is None or memory.tracker().dumps != dumps + 1:
        raise AssertionError(f"phase 5 (iii): no OutOfMemoryError ({raised})"
                             f" or no postmortem")
    path = memory.tracker().last_dump_path
    with open(path) as f:
        doc = json.load(f)
    top = doc["largest_live_arrays"]
    if doc["phase"] != "Model.fit" or not any(
            k.endswith("/params") for k in doc["ledger"]) or not top:
        raise AssertionError(f"phase 5 (iii): postmortem {path} lacks the "
                             f"ledger or the live tensors")
    log(f"phase 5 (iii) OOM: {raised}; postmortem {os.path.getsize(path)} "
        f"bytes: {len(doc['ledger'])} ledger keys, {len(top)} largest live "
        f"tensors (the largest {top[0]['shape']} {top[0]['dtype']} "
        f"{top[0]['nbytes']} bytes), device in use "
        f"{doc['crosscheck']['device_bytes_in_use']}")
    del model, net, ids
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 6: the op library and nn.Transformer (base) through Model.fit
# ---------------------------------------------------------------------------

#: Transformer (base), Vaswani et al. 2017 Table 3, and WMT14 en-de's
#: shared BPE vocabulary: depth and width not cut
TF_VOCAB, TF_D, TF_HEADS, TF_FF, TF_LAYERS = 37000, 512, 8, 2048, 6
TF_BATCH, TF_SRC, TF_TGT, TF_STEPS, TF_LR = 16, 256, 256, 8, 1e-4
#: the card-vs-CPU parity run: the same width at 2 + 2 layers, float32
TF_PARITY_LAYERS, TF_PARITY_BATCH, TF_PARITY_SEQ = 2, 2, 64
#: logits and gradients, card against CPU, relative to each tensor's
#: largest value: float32 on both, the card's attention on the CUDA-core
#: flash kernels (unmasked) or the op's plain body (masked), the CPU's on
#: the plain versions, sums over up to 128 rows in another order
TF_PARITY_TOL = 1e-4
#: the op sweep, card against CPU: float32 results (decompositions by
#: their identities), integers and booleans exactly
SWEEP_TOL = 1e-4
#: the sweep's case keys whose second call read the card back
SWEEP_SYNCING = []


def transformer_net(layers, device, seed):
    """Transformer (base) as its users build it from the public ``nn``
    API: a shared ``Embedding(37000, 512)`` scaled by sqrt(512) plus
    sinusoidal positions made from the op library, ``nn.Transformer(512,
    8, layers, layers, 2048, dropout=0.1, attn_dropout=0.0)`` with
    ``XavierUniform`` weights, an output ``Linear(512, 37000)``; the
    decoder's self-attention takes the causal mask of
    ``generate_square_subsequent_mask``. Random weights from ``seed``."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import nn

    def positions(length, dev):
        pos = pt.unsqueeze(pt.arange(0, length, dtype="float32",
                                     device=dev), 1)
        i = pt.arange(0, TF_D, 2, dtype="float32", device=dev)
        angle = pos * pt.exp(i * (-math.log(10000.0) / TF_D))
        return pt.reshape(pt.stack([pt.sin(angle), pt.cos(angle)], axis=-1),
                          [length, TF_D])

    class Seq2Seq(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(TF_VOCAB, TF_D, weight_attr=nn.ParamAttr(
                initializer=nn.initializer.Normal(0.0, TF_D ** -0.5)))
            self.transformer = nn.Transformer(
                TF_D, TF_HEADS, layers, layers, TF_FF, dropout=0.1,
                attn_dropout=0.0,
                weight_attr=nn.initializer.XavierUniform())
            self.proj = nn.Linear(TF_D, TF_VOCAB)

        def forward(self, src, tgt):
            scale = math.sqrt(TF_D)
            x = self.embed(src) * scale + positions(src.shape[1], src.device)
            y = self.embed(tgt) * scale + positions(tgt.shape[1], tgt.device)
            mask = nn.Transformer.generate_square_subsequent_mask(
                tgt.shape[1], device=tgt.device)
            return self.proj(self.transformer(x, y, tgt_mask=mask))

    pt.seed(seed)
    return Seq2Seq().to(device)


def tf_want(net):
    """One train step's launches, from the network's structure: K4 and K6
    once a unmasked attention (each encoder self-attention and each
    cross-attention), K2 and K3 once a LayerNorm (post-norm: two an
    encoder layer, three a decoder layer), K8 the plan's launches over
    the parameter tensors, each tensor once; the masked decoder
    self-attentions run the op's plain body."""
    n_enc = len(net.transformer.encoder.layers)
    n_dec = len(net.transformer.decoder.layers)
    n_ln = sum(1 for m in net.modules()
               if type(m).__name__ == "LayerNorm")
    numels = [p.numel() for p in net.parameters()]
    return {"flash_attention_fwd": n_enc + n_dec,
            "flash_attention_bwd": n_enc + n_dec,
            "fused_layer_norm": n_ln, "fused_layer_norm_bwd": n_ln,
            "fused_adamw": adamw_launches(numels),
            "fused_adamw_tensors": len(numels)}, n_dec


def tf_batch(seed, rows, seq):
    rs = np.random.RandomState(seed)
    return tuple(rs.randint(0, TF_VOCAB, (rows, seq)).astype(np.int64)
                 for _ in range(3))


def phase_op_sweep(device):
    """Every op of the library on CUDA tensors at its case's small shape
    (``ops/op_cases.py``) against the same op on the CPU: float32 within
    ``SWEEP_TOL``, integers and booleans exactly, decompositions by their
    identities, samplers in distribution; every tensor it returns lies on
    the card. An op that raises fails the phase. Each op runs once more
    under ``set_sync_debug_mode("error")`` to list the ops that read the
    card back (those whose output size depends on the data, or that take
    a Python number from it)."""
    from paddle_tpu_torch.framework.dispatch import call_op
    from paddle_tpu_torch.ops import op_cases

    def conv(a, dev):
        if isinstance(a, str) and a == op_cases.KEY:
            return torch.Generator(device=dev).manual_seed(SEED)
        if isinstance(a, (np.ndarray, np.generic)):
            return torch.as_tensor(np.array(a), device=dev)
        if isinstance(a, list) and a and all(isinstance(v, np.ndarray)
                                             for v in a):
            return [torch.as_tensor(v, device=dev) for v in a]
        return a

    def operands(case, dev):
        attrs = {k: conv(v, dev) for k, v in case.attrs.items()}
        if case.creation:
            attrs["device"] = dev
        return [conv(a, dev) for a in case.args], attrs

    def run(case, dev):
        args, attrs = operands(case, dev)
        return call_op(case.name, *args, **attrs)

    def on_card(out):
        outs = out if isinstance(out, (list, tuple)) else [out]
        return all(o.is_cuda for o in outs if isinstance(o, torch.Tensor))

    cases = op_cases.cases(SEED)
    syncing, t0 = SWEEP_SYNCING, time.perf_counter()
    syncing.clear()
    for key, case in sorted(cases.items()):
        got = run(case, device)
        if not on_card(got):
            raise AssertionError(f"op sweep {key}: a result left the card")
        want = None if case.check == "random" else run(case, "cpu")
        try:
            op_cases.check(case, op_cases.to_numpy_tree(got),
                           None if want is None
                           else op_cases.to_numpy_tree(want),
                           SWEEP_TOL, SWEEP_TOL)
        except AssertionError as e:
            raise AssertionError(f"op sweep {key}: card vs CPU: {e}") \
                from None
        args, attrs = operands(case, device)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            call_op(case.name, *args, **attrs)
        except RuntimeError as e:
            if "synchroniz" not in str(e):
                raise
            syncing.append(key)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    names = {c.name for c in cases.values()}
    log(f"phase 6 op sweep: {len(cases)} cases over {len(names)} ops on the "
        f"card against the CPU, all within {SWEEP_TOL} (integers exact), "
        f"{time.perf_counter() - t0:.1f} s; {len(syncing)} read the card "
        f"back: {' '.join(syncing)}")
    return names


def tf_parity(device):
    """The same ``nn.Transformer`` at base width and 2 + 2 layers, in
    float32 with its dropout at 0, on the card (kernels) and on a CPU copy
    with the same weights (plain versions). As built (ReLU in the
    feed-forward layers): the logits within ``TF_PARITY_TOL`` of their
    largest value and the loss within rtol 1e-5. Then the same network
    with GELU there: the logits and every parameter's gradient within
    ``TF_PARITY_TOL`` of each tensor's largest value, but the attention
    key biases', whose true gradient is zero (a constant per softmax row):
    both sides there lie below 1e-7. ReLU's kink turns float32 rounding
    differences of the pre-activations (BLAS reductions in another order)
    into gradient differences of up to 2e-2 in the encoder's first layer
    with every kernel switched off (PR 15 diagnosis run, PERF.md), so the
    ReLU network's gradients say nothing of the kernels; the smooth one's
    agree to ~3e-6."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.convert import layer_from_jax, layer_to_numpy
    cpu = torch.device("cpu")
    src, tgt, lab = tf_batch(SEED + 63, TF_PARITY_BATCH, TF_PARITY_SEQ)
    report = []
    for act in ("relu", "gelu"):
        card = transformer_net(TF_PARITY_LAYERS, device, SEED + 61)
        host = transformer_net(TF_PARITY_LAYERS, cpu, SEED + 62)
        layer_from_jax(host, layer_to_numpy(card))
        for net in (card, host):
            for m in net.modules():
                if isinstance(m, nn.Dropout):
                    m.p = 0.0
                if hasattr(m, "activation"):
                    m.activation = act
        outs = {}
        for key, net, dev in (("card", card, device), ("host", host, cpu)):
            logits = net(torch.from_numpy(src).to(dev),
                         torch.from_numpy(tgt).to(dev))
            loss = nn.CrossEntropyLoss()(logits,
                                         torch.from_numpy(lab).to(dev))
            loss.backward()
            outs[key] = (logits.detach().cpu(), loss.item(),
                         {n: p.grad.detach().cpu()
                          for n, p in net.named_parameters()})
        checked = [("logits", outs["card"][0], outs["host"][0])]
        if act == "gelu":
            checked += [(n, g, outs["host"][2][n])
                        for n, g in outs["card"][2].items()]
        worst, bad = {}, []
        for name, got, want in checked:
            if name.endswith("k_proj.bias"):
                top = max(got.abs().max().item(), want.abs().max().item())
                if top > 1e-7:
                    bad.append(f"{name} |grad| {top:.3e}")
                continue
            top = want.abs().max().item()
            err = (got - want).abs().max().item() / max(top, 1e-30)
            worst[name] = err
            if not (torch.isfinite(got).all() and err <= TF_PARITY_TOL):
                bad.append(f"{name} {err:.3e} of {top:.3e}")
        if abs(outs["card"][1] - outs["host"][1]) > 1e-5 * abs(
                outs["host"][1]):
            bad.append(f"loss {outs['card'][1]} vs {outs['host'][1]}")
        if bad:
            raise AssertionError(f"phase 6 parity ({act}): card vs CPU "
                                 f"beyond {TF_PARITY_TOL}: {bad}")
        name = max(worst, key=worst.get)
        report.append(f"{act}: loss card {outs['card'][1]:.6f} CPU "
                      f"{outs['host'][1]:.6f}, {len(worst)} tensors, worst "
                      f"{name} {worst[name]:.3e}")
        del card, host
    log(f"phase 6 parity: Transformer (base width) at {TF_PARITY_LAYERS} + "
        f"{TF_PARITY_LAYERS} layers, float32, batch {TF_PARITY_BATCH} x "
        f"{TF_PARITY_SEQ}, card vs CPU within {TF_PARITY_TOL}: "
        + "; ".join(report))


def phase_transformer(device, card, timer):
    """6: the op library on the card, then Transformer (base) trained
    through ``Model.fit`` (AdamW lr 1e-4 on float32 parameters, bf16 AMP
    O1, 8 steps on one batch of 16 x 256 source and 256 target tokens)
    with each step's launches held to the network's structure; then the
    path's kernels against their plain versions at its shapes. Returns
    the fit's launches, the kernels line's rows and the swept ops'
    names."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.optimizer.optimizer as opt_module
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.callbacks import Callback
    from paddle_tpu_torch.framework import monitor
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.optimizer import AdamW
    swept = phase_op_sweep(device)
    tf_parity(device)
    gc.collect()
    net = transformer_net(TF_LAYERS, device, SEED + 60)
    want, n_masked = tf_want(net)
    counters = train_counters()

    class Steps(Callback):
        def __init__(self):
            super().__init__()
            self.loss, self.spans, self.launches = [], [], []

        def _read(self):
            return {**read_counts(counters),
                    "sdpa": monitor.stat_get(
                        "op_count/scaled_dot_product_attention")}

        def on_train_batch_begin(self, step, logs=None):
            self._t0, self._at = time.perf_counter(), self._read()

        def on_train_batch_end(self, step, logs=None):
            self.spans.append(time.perf_counter() - self._t0)
            self.loss.append(logs["loss"])
            now = self._read()
            self.launches.append({k: now[k] - self._at[k] for k in now})

    model = Model(net, inputs=["src", "tgt"], labels=["label"],
                  device=device)
    model.prepare(AdamW(TF_LR, parameters=net.parameters()),
                  loss=nn.CrossEntropyLoss(),
                  amp_configs={"level": "O1", "dtype": "bfloat16"})
    src, tgt, lab = tf_batch(SEED + 64, TF_BATCH, TF_SRC)
    data = pt.io.TensorDataset([np.tile(a, (TF_STEPS, 1))
                                for a in (src, tgt, lab)])
    rec = Steps()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    with count_plain() as plain, adamw_dtypes(opt_module) as kinds:
        t0 = time.perf_counter()
        model.fit(data, batch_size=TF_BATCH, shuffle=False, log_freq=1,
                  verbose=0, callbacks=[rec])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_counts(counters)
    peak = torch.cuda.max_memory_allocated()
    step_want = dict(want, sdpa=want["flash_attention_fwd"] + n_masked)
    if rec.launches != [step_want] * TF_STEPS:
        raise AssertionError(f"phase 6: launches a step {rec.launches}, "
                             f"expected {step_want} each of {TF_STEPS}")
    check_launches("phase 6", launches, want, TF_STEPS)
    if sum(plain.values()) or set(kinds) != {("float32", "float32", None)}:
        raise AssertionError(f"phase 6: plain versions {dict(plain)}, "
                             f"AdamW (p, g, copy) dtypes {dict(kinds)}")
    check_flash_route("phase 6", counters, "tc")
    check_ln_route("phase 6", (counters["fused_layer_norm"],
                               counters["fused_layer_norm_bwd"]))
    if len(rec.loss) != TF_STEPS or not all(
            math.isfinite(x) for x in rec.loss) \
            or not rec.loss[-1] < rec.loss[0]:
        raise AssertionError(f"phase 6 losses on a repeated batch: "
                             f"{rec.loss}")
    tokens = TF_BATCH * (TF_SRC + TF_TGT) * TF_STEPS
    n_params = sum(p.numel() for p in net.parameters())
    log(f"phase 6: Transformer (base) {TF_LAYERS} + {TF_LAYERS} layers, "
        f"d_model {TF_D}, {TF_HEADS} heads, ffn {TF_FF}, vocab {TF_VOCAB}, "
        f"{n_params} parameters in {want['fused_adamw_tensors']} tensors "
        f"({want['fused_adamw']} K8 launches a step); "
        f"attn_dropout 0.0 puts the encoder's self-attention and the "
        f"cross-attention on the flash kernels (attention dropout would "
        f"refuse them, as the JAX override does); the decoder's "
        f"{n_masked} masked self-attentions a step run the op's plain "
        f"body, as in the JAX package")
    log(f"phase 6 fit: bf16 O1, AdamW lr {TF_LR}, batch {TF_BATCH} x "
        f"({TF_SRC} + {TF_TGT}) tokens, {TF_STEPS} steps in {wall:.3f} s: "
        f"{tokens / wall:.1f} tokens/s, {wall / TF_STEPS * 1e3:.3f} ms per "
        f"step (wall / steps), median step "
        f"{float(np.median(rec.spans)) * 1e3:.3f} ms, max memory allocated "
        f"{peak} bytes ({peak / 2 ** 30:.3f} GiB) on {card}; losses "
        f"{json.dumps(rec.loss)}; launches a step {json.dumps(step_want)} "
        f"(sdpa: op calls), every flash launch on the tensor-core route, "
        f"every LayerNorm launch on the warp-row route; {len(swept)} ops "
        f"swept")
    shapes = [tuple(p.shape) for p in net.parameters()]
    del model, net, data
    gc.collect()
    torch.cuda.empty_cache()
    return launches, tf_rows(device, timer, launches, shapes), swept


def tf_rows(device, timer, launches, shapes):
    """The kernels line's rows of phase 6: each kernel against its plain
    version at the fit's shapes and dtypes (LayerNorm float32 [4096, 512],
    flash bf16 [16, 256, 8, 64] not causal, AdamW on the [37000, 512]
    table with a float32 gradient, and AdamW over the whole parameter
    list of ``shapes`` as its step hands it over), with the fit's
    launches."""
    gen = torch.Generator(device=device).manual_seed(SEED + 65)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (scale * torch.randn(*shape, device=device,
                                    generator=gen)).to(dtype)

    rows_ln = TF_BATCH * TF_SRC
    x, g = randn(rows_ln, TF_D), randn(rows_ln, TF_D)
    w, b = 1 + randn(TF_D, scale=0.1), randn(TF_D, scale=0.1)
    ln_fwd = ln_fwd_case(timer, x, w, b)
    ln_bwd = ln_bwd_case(timer, x, w, g)
    q, k, v, do = (randn(TF_BATCH, TF_SRC, TF_HEADS, TF_D // TF_HEADS,
                         dtype=torch.bfloat16) for _ in range(4))
    fa_fwd, fa_bwd = flash_case(timer, q, k, v, do, causal=False,
                                route="tc", core=True)
    n = (TF_VOCAB, TF_D)
    adamw = adamw_case(timer, randn(*n, scale=0.05), randn(*n, scale=1e-3),
                       randn(*n, scale=1e-4), randn(*n, scale=1e-4).square(),
                       None, TF_LR, 0.9, 0.999, 1e-8, 0.01, 3)
    adamw_step = adamw_step_case(timer, device, shapes, None, TF_LR, 0.01)
    out = []
    for name, src, tpu, row, count in (
            ("fused_layer_norm_transformer", LN_SRC, LN_TPU, ln_fwd,
             "fused_layer_norm"),
            ("fused_layer_norm_bwd_transformer", LN_SRC, LN_BWD_TPU, ln_bwd,
             "fused_layer_norm_bwd"),
            ("flash_attention_fwd_transformer", FA_TC_SRC, FA_FWD_TPU,
             fa_fwd, "flash_attention_fwd"),
            ("flash_attention_bwd_transformer", FA_TC_SRC, FA_BWD_TPU,
             fa_bwd, "flash_attention_bwd"),
            ("fused_adamw_transformer", ADAMW_SRC, ADAMW_TPU, adamw,
             "fused_adamw"),
            ("fused_adamw_step_transformer", ADAMW_SRC, ADAMW_TPU,
             adamw_step, "fused_adamw")):
        log(f"phase 6 {name} {fmt(row)}")
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": tpu, "launches": launches[count],
                    "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                    "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                    "bound_by": row["bound_by"],
                    "library_ms": row["library_ms"]})
        if "core_ms" in row:
            out[-1].update(core_source=FA_SRC, core_ms=row["core_ms"],
                           core_err=row["core_err"])
        if "host_us" in row:
            out[-1].update({k: row[k] for k in STEP_KEYS},
                           launches_note=STEP_NOTE)
    return out


# ---------------------------------------------------------------- phase 7

#: ``bench.py``'s ``bench_resnet50``: ResNet-50 at 1000 classes, NHWC,
#: batch 128 at 224 x 224, bf16 AMP O2, Momentum(0.1, 0.9) with float32
#: masters; not cut
RN_BATCH, RN_HW, RN_CLASSES, RN_LR, RN_MOMENTUM = 128, 224, 1000, 0.1, 0.9
#: 1 warm-up and 8 timed steps on the fixed batch; up to 16 timed steps
#: when 8 do not lower the loss
RN_WARM, RN_STEPS, RN_MAX_STEPS = 1, 8, 16
#: the card-vs-CPU parity run: resnet18 at 10 classes, float32, batch 4
#: at 32 x 32, both layouts
RN_PARITY_BATCH, RN_PARITY_HW, RN_PARITY_CLASSES = 4, 32, 10
#: card against CPU, each tensor's largest |difference| over its largest
#: |value|: the logits, the loss and the running statistics
RN_PARITY_TOL = 1e-4
#: the same for every gradient and every parameter after the Momentum
#: step: ReLU's kink turns float32 rounding of a pre-activation near 0
#: into a gradient difference (PR 15, PERF.md section 6), so the
#: gradients get ten times the room of the values
RN_GRAD_TOL = 1e-3


def rn_batch(seed, rows, hw, classes, data_format):
    """``bench_resnet50``'s data: ``RandomState(seed)`` images ``randn(rows,
    3, hw, hw)`` float32 (moved to NHWC for a channel-last network), then
    int64 labels ``[rows, 1]`` in ``[0, classes)``."""
    rs = np.random.RandomState(seed)
    x = rs.randn(rows, 3, hw, hw).astype(np.float32)
    if data_format == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    return x, rs.randint(0, classes, (rows, 1)).astype(np.int64)


def kernel_counters():
    """Every kernel's launch-counting wrapper, K1/K1q's with the training
    path's, by name."""
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    return {**train_counters(),
            "ragged_paged_attention": rpa.ragged_paged_attention}


def kernel_counts(counters):
    return {f"{name}.{attr}": getattr(fn, attr)
            for name, fn in counters.items()
            for attr in ("launches", "quant_launches") if hasattr(fn, attr)}


def reset_kernel_counts(counters):
    reset_counts(counters)
    rpa = counters["ragged_paged_attention"]
    for attr in RPA_COUNTS:
        setattr(rpa, attr, 0)


def rn_rel(got, want):
    """``got``'s largest |difference| from ``want`` over ``want``'s largest
    |value| (both moved to the CPU in float32)."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return (got - want).abs().max().item() / max(
        want.abs().max().item(), 1e-30)


def rn_parity(device):
    """``resnet18(num_classes=10)`` in float32 on the card and on a CPU copy
    of the same weights, NCHW and NHWC, one batch of 4 at 32 x 32. With
    BatchNorm on its running statistics: the logits and the loss within
    ``RN_PARITY_TOL``, every gradient (the input's too) and every
    parameter after one ``Momentum(0.1, 0.9)`` step within
    ``RN_GRAD_TOL``, each relative to its tensor's largest value. In
    training mode: after one forward, the running statistics of every
    BatchNorm before the last stage within ``RN_PARITY_TOL``. The last
    stage's maps are 1 x 1 at 32 x 32, so each of its BatchNorms
    normalizes 4 values a channel by their own spread and turns float32
    rounding into differences of up to 1e-1 of the logits (the JAX
    package's NCHW and NHWC forms of one network differ that much on the
    CPU, ``tests/test_torch_resnet.py``): its statistics are not held."""
    import copy

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.convert import layer_to_numpy
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet18
    cpu = torch.device("cpu")
    report = []
    for df in ("NCHW", "NHWC"):
        pt.seed(SEED + 70)
        host = resnet18(num_classes=RN_PARITY_CLASSES, data_format=df)
        card = copy.deepcopy(host).to(device)
        x, y = rn_batch(SEED + 71, RN_PARITY_BATCH, RN_PARITY_HW,
                        RN_PARITY_CLASSES, df)
        outs = {}
        for key, net, dev in (("card", card, device), ("host", host, cpu)):
            net.eval()
            xt = torch.from_numpy(x).to(dev).requires_grad_()
            logits = net(xt)
            loss = nn.CrossEntropyLoss()(logits, torch.from_numpy(y).to(dev))
            loss.backward()
            grads = {n: p.grad.detach().cpu()
                     for n, p in net.named_parameters()}
            grads["input"] = xt.grad.detach().cpu()
            Momentum(RN_LR, RN_MOMENTUM, parameters=net.parameters()).step()
            params = {n: p.detach().cpu() for n, p in net.named_parameters()}
            net.train()
            with torch.no_grad():
                net(torch.from_numpy(x).to(dev))
            stats = {k: torch.from_numpy(v) for k, v in
                     layer_to_numpy(net).items()
                     if k.endswith(("_mean", "_variance"))
                     and not k.startswith("layer4")}
            outs[key] = (logits.detach().cpu(), loss.item(), grads, params,
                         stats)
        (c_logits, c_loss, c_grads, c_params, c_stats), \
            (h_logits, h_loss, h_grads, h_params, h_stats) = \
            outs["card"], outs["host"]
        worst, bad = {}, []
        checked = [("logits", c_logits, h_logits, RN_PARITY_TOL)] + \
            [(f"grad {k}", c_grads[k], h_grads[k], RN_GRAD_TOL)
             for k in h_grads] + \
            [(f"param {k}", c_params[k], h_params[k], RN_GRAD_TOL)
             for k in h_params] + \
            [(f"stat {k}", c_stats[k], h_stats[k], RN_PARITY_TOL)
             for k in h_stats]
        for name, got, want, tol in checked:
            err = rn_rel(got, want)
            kind = name.split()[0]
            if err > worst.get(kind, (0.0, ""))[0]:
                worst[kind] = (err, name)
            if not (torch.isfinite(got).all() and err <= tol):
                bad.append(f"{name} {err:.3e} (limit {tol})")
        if abs(c_loss - h_loss) > RN_PARITY_TOL * abs(h_loss):
            bad.append(f"loss {c_loss} vs {h_loss}")
        if bad:
            raise AssertionError(f"phase 7 parity ({df}): card vs CPU: "
                                 f"{bad}")
        report.append(
            f"{df}: loss card {c_loss:.6f} CPU {h_loss:.6f}, "
            f"{len(checked)} tensors (" + ", ".join(
                f"worst {k} {e:.3e} {n.split(' ', 1)[-1]}"
                for k, (e, n) in sorted(worst.items())) + ")")
        del card, host
    log(f"phase 7 parity: resnet18 ({RN_PARITY_CLASSES} classes), float32, "
        f"batch {RN_PARITY_BATCH} at {RN_PARITY_HW} x {RN_PARITY_HW}, card "
        f"vs CPU, logits/loss/statistics within {RN_PARITY_TOL}, gradients "
        f"and the Momentum step within {RN_GRAD_TOL} of each tensor's "
        f"largest value: " + "; ".join(report))


class LayoutCopies:
    """Counts, while active, the tensor copies that aten runs on the
    dispatcher (forward and backward): the dtype casts, the layout copies
    (a copy whose stride order differs from its source's) and the other
    copies, each with its bytes. cuDNN's own layout transforms run inside
    its convolution; they are read from the step's device trace."""

    _COPIES = ("clone", "_to_copy", "copy_")

    def __init__(self):
        self.counts = collections.Counter()
        self.nbytes = collections.Counter()
        self.layout_shapes = collections.Counter()

    @staticmethod
    def _order(t):
        return tuple(d for d in sorted(range(t.dim()),
                                       key=lambda d: -t.stride(d))
                     if t.shape[d] > 1)

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        outer = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                name = func.overloadpacket.__name__
                if name in LayoutCopies._COPIES:
                    src = args[1] if name == "copy_" else args[0]
                    dst = out
                    if isinstance(src, torch.Tensor) and isinstance(
                            dst, torch.Tensor):
                        if src.dtype != dst.dtype:
                            kind = "dtype"
                        elif outer._order(src) != outer._order(dst):
                            kind = "layout"
                        else:
                            kind = "plain"
                        outer.counts[kind] += 1
                        outer.nbytes[kind] += dst.numel() * \
                            dst.element_size()
                        if kind == "layout":
                            outer.layout_shapes[str(tuple(dst.shape))] += 1
                return out

        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


def rn_layout_copies(model, inputs, labels):
    """One more train step of the fit's model, counted: the copies aten
    runs (:class:`LayoutCopies`) and, from a ``torch.profiler`` trace of
    the same step, the device's copy kernels (names with ``copy``: dtype
    casts and layout copies), cuDNN's layout-transform kernels (names with
    ``nchwToNhwc`` or ``nhwcToNchw``) and every kernel."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            LayoutCopies() as copies:
        model._train_step(inputs, labels)
        torch.cuda.synchronize()
    kernels = collections.Counter(
        ev.name for ev in prof.events()
        if ev.device_type == torch.autograd.DeviceType.CUDA)
    trace = {"kernels": sum(kernels.values()),
             "copy": sum(c for n, c in kernels.items()
                         if "copy" in n.lower()),
             "transform": {n[:80]: c for n, c in kernels.items()
                           if "nchwToNhwc" in n or "nhwcToNchw" in n}}
    return copies, trace


def phase_resnet(device, card, sweep):
    """7: ResNet-50 at ``bench_resnet50``'s configuration trained through
    ``hapi.Model.fit`` (``RN_WARM`` + ``RN_STEPS`` steps on the fixed
    batch, the loss finite every step and lower at the last timed step
    than at the first), with no kernel's counter moving (the JAX package
    runs this network without a Pallas kernel: convolutions, pools and
    BatchNorm are XLA there, cuDNN and PyTorch's own kernels here); one
    more step under ``set_sync_debug_mode("error")`` and one counted for
    its layout copies; the resnet18 card/CPU parity (:func:`rn_parity`);
    the 22 ``extra_nn_ops`` among phase 6's swept ops (``sweep``)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import amp, nn
    from paddle_tpu_torch.callbacks import Callback
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.ops import extra_nn_ops
    from paddle_tpu_torch.ops.registry import get_op, op_names
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50
    extra = {n for n in op_names()
             if get_op(n).fn.__module__ == extra_nn_ops.__name__}
    missing = sorted(extra - set(sweep))
    if len(extra) != 22 or missing:
        raise AssertionError(f"phase 7: extra_nn_ops {sorted(extra)} not all "
                             f"swept on the card by phase 6: {missing}")
    rn_parity(device)
    gc.collect()
    torch.cuda.empty_cache()

    pt.seed(SEED)
    net = resnet50(num_classes=RN_CLASSES, data_format="NHWC")
    amp.decorate(net, level="O2", dtype="bfloat16")
    model = Model(net, inputs=["image"], labels=["label"], device=device)
    model.prepare(Momentum(learning_rate=RN_LR, momentum=RN_MOMENTUM,
                           parameters=net.parameters(),
                           multi_precision=True),
                  loss=nn.CrossEntropyLoss(), metrics=[Accuracy()],
                  amp_configs={"level": "O2", "dtype": "bfloat16"})
    x, y = rn_batch(SEED, RN_BATCH, RN_HW, RN_CLASSES, "NHWC")
    batch = (torch.from_numpy(x).to(device), torch.from_numpy(y).to(device))
    n_params = sum(p.numel() for p in net.parameters())

    class Steps(Callback):
        def __init__(self):
            super().__init__()
            self.loss, self.acc, self.spans = [], [], []

        def on_train_batch_begin(self, step, logs=None):
            self._t0 = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            self.spans.append(time.perf_counter() - self._t0)
            self.loss.append(logs["loss"])
            self.acc.append(float(logs["acc"]) if "acc" in logs else None)

    counters = kernel_counters()
    rec = Steps()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts(counters)
    with count_plain() as plain:
        model.fit([batch] * RN_WARM, batch_size=RN_BATCH, log_freq=1,
                  verbose=0, callbacks=[rec])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.fit([batch] * RN_STEPS, batch_size=RN_BATCH, log_freq=1,
                  verbose=0, callbacks=[rec])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        timed = RN_STEPS
        while not rec.loss[-1] < rec.loss[RN_WARM] and timed < RN_MAX_STEPS:
            model.fit([batch], batch_size=RN_BATCH, log_freq=1, verbose=0,
                      callbacks=[rec])
            timed += 1
        torch.cuda.synchronize()
        wall_all = time.perf_counter() - t0
    counts = kernel_counts(counters)
    peak = torch.cuda.max_memory_allocated()
    if any(counts.values()) or sum(plain.values()):
        raise AssertionError(f"phase 7: the fit launched kernels {counts} "
                             f"or plain versions {dict(plain)}")
    if not all(math.isfinite(v) for v in rec.loss) \
            or not rec.loss[-1] < rec.loss[RN_WARM]:
        raise AssertionError(f"phase 7 losses on the fixed batch over "
                             f"{timed} timed steps: {rec.loss}")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss, _ = model._train_step([batch[0]], [batch[1]])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not math.isfinite(loss.item()):
        raise AssertionError(f"phase 7: the sync-free step's loss {loss}")
    copies, trace = rn_layout_copies(model, [batch[0]], [batch[1]])
    spans = rec.spans[RN_WARM:RN_WARM + RN_STEPS]
    log(f"phase 7: ResNet-50 (bench.py bench_resnet50), {RN_CLASSES} "
        f"classes, NHWC, {n_params} parameters, bf16 AMP O2 (BatchNorm on "
        f"the black list: float32), Momentum lr {RN_LR} momentum "
        f"{RN_MOMENTUM} with float32 masters, batch {RN_BATCH} x {RN_HW} x "
        f"{RN_HW} x 3, through Model.fit with Accuracy: {RN_WARM} warm-up "
        f"and {timed} timed steps on the fixed batch; K1-K8 launches "
        f"{json.dumps(counts)} (none: the JAX package runs this network "
        f"without a Pallas kernel), no plain version")
    log(f"phase 7 fit on {card}: {RN_STEPS} timed steps in {wall:.3f} s: "
        f"{wall / RN_STEPS * 1e3:.3f} ms per step (wall / steps), median "
        f"step {float(np.median(spans)) * 1e3:.3f} ms, "
        f"{RN_BATCH * RN_STEPS / wall:.1f} images/s, max memory allocated "
        f"{peak} bytes ({peak / 2 ** 30:.3f} GiB); losses "
        f"{json.dumps(rec.loss)} (first timed {rec.loss[RN_WARM]:.4f}, "
        f"last {rec.loss[-1]:.4f}; {timed} timed steps, "
        f"{wall_all:.3f} s with any beyond {RN_STEPS}); accuracy "
        f"{json.dumps(rec.acc)}")
    log(f"phase 7 one step on {card}: under set_sync_debug_mode('error') "
        f"no read back to the host (loss {loss.item():.4f}); the copies "
        f"aten ran in one step, by kind {json.dumps(dict(copies.counts))}, "
        f"bytes {json.dumps(dict(copies.nbytes))}, layout copies by "
        f"shape {json.dumps(dict(copies.layout_shapes))}; the step's device "
        f"trace: {trace['kernels']} kernels, {trace['copy']} copy kernels, "
        f"layout-transform kernels {json.dumps(trace['transform'])}")
    del model, net, batch
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 10: BERT-base fine-tuned at bench_bert's configuration
# ---------------------------------------------------------------------------

#: ``bench.py``'s ``bench_bert``: BERT-base (12 layers, hidden 768, 12
#: heads, ffn 3072, vocab 30522, 512 positions) with both dropouts 0, the
#: QA head, bf16 AMP O2, AdamW(3e-5, weight_decay 0.01) with float32
#: masters, ``RandomState(0)`` ids, start and end positions ``[32, 128]``,
#: 5 warm-up and 30 timed steps; not cut
BERT_BATCH, BERT_SEQ, BERT_WARM, BERT_STEPS = 32, 128, 5, 30
BERT_LR, BERT_WD = 3e-5, 0.01
#: the card-vs-CPU parity run: base width at 2 layers, float32
BERT_PARITY_LAYERS, BERT_PARITY_BATCH, BERT_PARITY_SEQ = 2, 2, 64
#: a gradient whose true value is zero (the attention key biases; under
#: the span loss the last LayerNorm's bias and the classifier's bias,
#: since a shift shared by every position's logit changes no softmax):
#: the CPU's largest |value| below this fraction of the network's largest
#: gradient element, and then the card's must be too
BERT_ZERO_GRAD = 1e-5


def bert_net(cls, layers, device, seed, dtype=None):
    """``cls`` (a ``models.bert`` head) over ``BertConfig()`` cut to
    ``layers`` with both dropouts 0, random weights from ``seed``."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.bert import BertConfig
    cfg = BertConfig(num_hidden_layers=layers, hidden_dropout_prob=0.0,
                     attention_dropout_prob=0.0)
    pt.seed(seed)
    return cls(cfg).to(device=device, dtype=dtype)


def bert_batch(rows, seq, vocab):
    """``bench_bert``'s data: ``RandomState(0)`` ids, then start and end
    positions."""
    rng = np.random.RandomState(SEED)
    ids = rng.randint(0, vocab, (rows, seq)).astype(np.int64)
    start = rng.randint(0, seq, (rows,)).astype(np.int64)
    end = rng.randint(0, seq, (rows,)).astype(np.int64)
    return ids, start, end


def bert_parity(device):
    """BERT at base width cut to ``BERT_PARITY_LAYERS`` in float32, on the
    card (kernels) and on a CPU copy (plain versions): the QA head with a
    padding mask and without (start/end logits, loss, every gradient) and
    the masked-LM head with its decoder tied to the word embeddings
    (logits, loss, every gradient), each within ``TF_PARITY_TOL`` of the
    tensor's largest value; a gradient whose true value is zero is held
    below ``BERT_ZERO_GRAD`` of the network's largest on both sides."""
    from paddle_tpu_torch.convert import layer_from_jax, layer_to_numpy
    from paddle_tpu_torch.models.bert import (BertForMaskedLM,
                                              BertForQuestionAnswering)
    cpu = torch.device("cpu")
    ids, start, end = bert_batch(BERT_PARITY_BATCH, BERT_PARITY_SEQ, 30522)
    mask = np.ones(ids.shape, np.float32)
    mask[0, BERT_PARITY_SEQ // 2:] = 0.0
    labels = np.where(np.arange(BERT_PARITY_SEQ) % 3 == 0, -100,
                      ids).astype(np.int64)
    report = []
    for name, cls, masked in (("qa", BertForQuestionAnswering, False),
                              ("qa masked", BertForQuestionAnswering, True),
                              ("mlm", BertForMaskedLM, False)):
        card = bert_net(cls, BERT_PARITY_LAYERS, device, SEED + 71)
        host = bert_net(cls, BERT_PARITY_LAYERS, cpu, SEED + 72)
        layer_from_jax(host, layer_to_numpy(card))
        outs = {}
        for key, net, dev in (("card", card, device), ("host", host, cpu)):
            def t(a):
                return torch.from_numpy(a).to(dev)
            m = t(mask) if masked else None
            if cls is BertForMaskedLM:
                loss, logits = net(t(ids), attention_mask=m,
                                   labels=t(labels))
                logits = (logits,)
            else:
                loss, *logits = net(t(ids), attention_mask=m,
                                    start_positions=t(start),
                                    end_positions=t(end))
            loss.backward()
            outs[key] = ([x.detach().cpu() for x in logits], loss.item(),
                         {n: p.grad.detach().cpu()
                          for n, p in net.named_parameters()
                          if p.grad is not None})
        (c_logits, c_loss, c_grads), (h_logits, h_loss, h_grads) = \
            outs["card"], outs["host"]
        bad, worst, zeros = [], {}, 0
        if set(c_grads) != set(h_grads):
            bad.append(f"gradients of {sorted(set(c_grads) ^ set(h_grads))}")
        checked = [(f"logits {i}", g, w)
                   for i, (g, w) in enumerate(zip(c_logits, h_logits))]
        top = max(g.abs().max().item() for g in h_grads.values())
        for n, w in h_grads.items():
            g = c_grads.get(n)
            if g is None:
                continue
            if w.abs().max().item() <= BERT_ZERO_GRAD * top:
                zeros += 1
                if g.abs().max().item() > BERT_ZERO_GRAD * top:
                    bad.append(f"{n}: zero gradient on the CPU, "
                               f"{g.abs().max().item():.3e} on the card")
                continue
            checked.append((n, g, w))
        for n, g, w in checked:
            err = rn_rel(g, w)
            worst[n] = err
            if not (torch.isfinite(g).all() and err <= TF_PARITY_TOL):
                bad.append(f"{n} {err:.3e}")
        if abs(c_loss - h_loss) > TF_PARITY_TOL * abs(h_loss):
            bad.append(f"loss {c_loss} vs {h_loss}")
        if bad:
            raise AssertionError(f"phase 10 parity ({name}): card vs CPU "
                                 f"beyond {TF_PARITY_TOL}: {bad}")
        top_name = max(worst, key=worst.get)
        report.append(f"{name}: loss card {c_loss:.6f} CPU {h_loss:.6f}, "
                      f"{len(worst)} tensors within, worst {top_name} "
                      f"{worst[top_name]:.3e}, {zeros} zero gradients")
        del card, host
    log(f"phase 10 parity: BERT (base width) at {BERT_PARITY_LAYERS} layers,"
        f" float32, batch {BERT_PARITY_BATCH} x {BERT_PARITY_SEQ}, card vs "
        f"CPU within {TF_PARITY_TOL}: " + "; ".join(report))


def bert_want(net):
    """One train step's launches from the network's structure: K2 and K3
    once a LayerNorm (the embeddings' and two a post-norm layer), K4 and
    K6 once a layer (unmasked, dropout-free attention), K8 the plan's
    launches over the parameter tensors that get a gradient (the pooler's
    two do not: the QA head reads no pooled output, and the optimizer
    skips a parameter without a gradient, as the JAX one does)."""
    layers = len(net.inner.bert.encoder.layers)
    n_ln = sum(1 for m in net.modules() if type(m).__name__ == "LayerNorm")
    pooler = {id(p) for p in net.inner.bert.pooler.parameters()}
    numels = [p.numel() for p in net.parameters() if id(p) not in pooler]
    return {"flash_attention_fwd": layers, "flash_attention_bwd": layers,
            "fused_layer_norm": n_ln, "fused_layer_norm_bwd": n_ln,
            "fused_adamw": adamw_launches(numels),
            "fused_adamw_tensors": len(numels)}


def phase_bert(device, card, timer, profile=False):
    """10: BERT-base fine-tuned at ``bench_bert``'s configuration through
    the eager loop ``loss.backward(); opt.step(); opt.clear_grad()`` under
    ``amp.auto_cast`` (O2, bf16): ``BERT_WARM`` + ``BERT_STEPS`` steps on
    the fixed batch, every step's launches held to the structure (every
    flash launch tensor-core, every LayerNorm launch warp-row), no plain
    version, the loss finite and lower at the last timed step than at the
    first; one more step under ``set_sync_debug_mode("error")``; steps/s,
    tokens/s, ms a step, peak memory and MFU (``bench.py``'s formula).
    First :func:`bert_parity`. ``profile``: two more steps under the
    port's ``Profiler``, device time by kernel. Returns the fit's
    launches and the kernels line's rows."""
    import paddle_tpu_torch.optimizer.optimizer as opt_module
    from paddle_tpu_torch import amp, nn
    from paddle_tpu_torch.framework.program_registry import peak_flops
    from paddle_tpu_torch.models.bert import BertForQuestionAnswering
    from paddle_tpu_torch.optimizer import AdamW
    bert_parity(device)
    gc.collect()
    torch.cuda.empty_cache()

    class QATrain(nn.Layer):
        """``bench_bert``'s ``_QATrain``: positional (ids, start, end)."""

        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, ids, start, end):
            return self.inner(ids, start_positions=start,
                              end_positions=end)

    model = QATrain(bert_net(BertForQuestionAnswering, 12, device, SEED))
    amp.decorate(model, level="O2", dtype="bfloat16")
    opt = AdamW(learning_rate=BERT_LR, weight_decay=BERT_WD,
                parameters=model.parameters(), multi_precision=True)
    want = bert_want(model)
    vocab = model.inner.bert.cfg.vocab_size
    batch = [torch.from_numpy(a).to(device)
             for a in bert_batch(BERT_BATCH, BERT_SEQ, vocab)]
    n_params = sum(p.numel() for p in model.parameters())
    counters = train_counters()

    def step():
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            loss = model(*batch)[0]
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    losses, per_step = [], []
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(BERT_STEPS + 1)]
    with count_plain() as plain, adamw_dtypes(opt_module) as kinds:
        for _ in range(BERT_WARM):
            at = read_counts(counters)
            losses.append(step())
            now = read_counts(counters)
            per_step.append({k: now[k] - at[k] for k in now})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        events[0].record()
        for i in range(BERT_STEPS):
            at = read_counts(counters)
            losses.append(step())
            events[i + 1].record()
            now = read_counts(counters)
            per_step.append({k: now[k] - at[k] for k in now})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_counts(counters)
    peak = torch.cuda.max_memory_allocated()
    losses = [x.item() for x in losses]
    spans = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    if per_step != [want] * (BERT_WARM + BERT_STEPS):
        bad = [(i, s) for i, s in enumerate(per_step) if s != want]
        raise AssertionError(f"phase 10: launches a step, expected {want}: "
                             f"{bad[:3]}")
    check_flash_route("phase 10", counters, "tc")
    check_ln_route("phase 10", (counters["fused_layer_norm"],
                                counters["fused_layer_norm_bwd"]))
    if sum(plain.values()) or set(kinds) != {
            ("float32", "bfloat16", "bfloat16")}:
        raise AssertionError(f"phase 10: plain versions {dict(plain)}, "
                             f"AdamW (p, g, copy) dtypes {dict(kinds)}")
    timed = losses[BERT_WARM:]
    if not all(math.isfinite(x) for x in losses) or not timed[-1] < timed[0]:
        raise AssertionError(f"phase 10 losses on the fixed batch: {losses}")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        extra = step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not math.isfinite(extra.item()):
        raise AssertionError(f"phase 10: the sync-free step's loss {extra}")
    if profile:
        with device_profile() as prof:
            t0 = time.perf_counter()
            for _ in range(2):
                step()
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3
        device_time_report("bert", prof, prof_ms, 2)
    steps_per_sec = BERT_STEPS / wall
    peak_rate = peak_flops(torch.cuda.get_device_name(0))
    mfu = 6.0 * n_params * BERT_BATCH * BERT_SEQ * steps_per_sec / peak_rate
    log(f"phase 10: BERT-base (bench.py bench_bert), {n_params} parameters "
        f"in {want['fused_adamw_tensors'] + 2} tensors ({want['fused_adamw_tensors']} "
        f"with a gradient: the pooler's two get none on the QA path and "
        f"the optimizer skips them), bf16 AMP O2 (LayerNorm float32), AdamW "
        f"lr {BERT_LR} weight_decay {BERT_WD} with float32 masters, batch "
        f"{BERT_BATCH} x {BERT_SEQ}, the eager loop loss.backward(); "
        f"opt.step(); opt.clear_grad(): {BERT_WARM} warm-up and "
        f"{BERT_STEPS} timed steps; launches a step {json.dumps(want)}, "
        f"every flash launch on the tensor-core route, every LayerNorm "
        f"launch on the warp-row route, no plain version; one more step "
        f"under set_sync_debug_mode('error') (loss {extra.item():.4f})")
    log(f"phase 10 on {card}: bert_base_amp_o2_steps_per_sec "
        f"{steps_per_sec:.3f}; {BERT_BATCH * BERT_SEQ * steps_per_sec:.1f} "
        f"tokens/s; {wall / BERT_STEPS * 1e3:.3f} ms per step (wall / "
        f"steps), median step {statistics.median(spans):.3f} ms (CUDA "
        f"events between steps); max memory allocated {peak} bytes "
        f"({peak / 2 ** 30:.3f} GiB); MFU {mfu:.4f} (6 x parameters x "
        f"tokens x steps/s over {peak_rate:.4g}); losses "
        f"{json.dumps(losses)} (first timed {timed[0]:.4f}, last "
        f"{timed[-1]:.4f})")
    pooler = {id(p) for p in model.inner.bert.pooler.parameters()}
    shapes = [tuple(p.shape) for p in model.parameters()
              if id(p) not in pooler]
    del model, opt, batch
    gc.collect()
    torch.cuda.empty_cache()
    return (launches, bert_rows(device, timer, launches, shapes),
            events[0].elapsed_time(events[-1]) / BERT_STEPS)


def bert_rows(device, timer, launches, shapes, tail="bert"):
    """The kernels line's rows of phase 10: each kernel against its plain
    version at the fit's shapes and dtypes (LayerNorm float32 [4096, 768],
    flash bf16 [32, 128, 12, 64] not causal, AdamW over the parameter
    list with a gradient as its step hands it over: bf16 parameters on
    float32 masters, bf16 gradients and copies), with the fit's
    launches."""
    gen = torch.Generator(device=device).manual_seed(SEED + 73)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (scale * torch.randn(*shape, device=device,
                                    generator=gen)).to(dtype)

    d, heads = 768, 12
    rows = BERT_BATCH * BERT_SEQ
    x, g = randn(rows, d), randn(rows, d)
    w, b = 1 + randn(d, scale=0.1), randn(d, scale=0.1)
    ln_fwd = ln_fwd_case(timer, x, w, b)
    ln_bwd = ln_bwd_case(timer, x, w, g)
    q, k, v, do = (randn(BERT_BATCH, BERT_SEQ, heads, d // heads,
                         dtype=torch.bfloat16) for _ in range(4))
    fa_fwd, fa_bwd = flash_case(timer, q, k, v, do, causal=False,
                                route="tc", core=True)
    adamw_step = adamw_step_case(timer, device, shapes, torch.bfloat16,
                                 BERT_LR, BERT_WD)
    out = []
    for name, src, tpu, row, count in (
            (f"fused_layer_norm_{tail}", LN_SRC, LN_TPU, ln_fwd,
             "fused_layer_norm"),
            (f"fused_layer_norm_bwd_{tail}", LN_SRC, LN_BWD_TPU, ln_bwd,
             "fused_layer_norm_bwd"),
            (f"flash_attention_fwd_{tail}", FA_TC_SRC, FA_FWD_TPU, fa_fwd,
             "flash_attention_fwd"),
            (f"flash_attention_bwd_{tail}", FA_TC_SRC, FA_BWD_TPU, fa_bwd,
             "flash_attention_bwd"),
            (f"fused_adamw_step_{tail}", ADAMW_SRC, ADAMW_TPU, adamw_step,
             "fused_adamw")):
        log(f"phase {10 if tail == 'bert' else 17} {name} {fmt(row)}")
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": tpu, "launches": launches[count],
                    "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                    "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                    "bound_by": row["bound_by"],
                    "library_ms": row["library_ms"]})
        if "core_ms" in row:
            out[-1].update(core_source=FA_SRC, core_ms=row["core_ms"],
                           core_err=row["core_err"])
        if "host_us" in row:
            out[-1].update({k: row[k] for k in STEP_KEYS},
                           launches_note=STEP_NOTE)
    return out


# ---------------------------------------------------------------------------
# phase 11: the text models on the card
# ---------------------------------------------------------------------------

#: Transformer (base) as ``models.seq2seq.TransformerModel`` at phase 6's
#: width (6 + 6 layers, d_model 512, 8 heads, ffn 2048, vocabulary 37000
#: both sides), bf16, 16 sources of 16-64 real tokens padded to 64,
#: decoded to ``max_length`` 64 greedily and with 4 beams (length
#: penalty 0.6); the float32 parity copy at 2 + 2 layers
TEXT_SRC_ROWS, TEXT_SRC_LEN, TEXT_MAX_LEN, TEXT_BEAMS = 16, 64, 64, 4
TEXT_PARITY_LAYERS = 2
#: the recurrent layers on the card against the CPU: input 256, hidden
#: 512, 2 layers, bidirectional, batch 16 x 48 steps with lengths;
#: outputs, states and gradients relative to each tensor's largest value
RNN_DIMS = (256, 512, 16, 48)
RNN_TOL = 1e-4


def text_model(layers, device, seed, dtype=None):
    from paddle_tpu_torch.models.seq2seq import TransformerModel
    import paddle_tpu_torch as pt
    pt.seed(seed)
    return TransformerModel(TF_VOCAB, TF_VOCAB, d_model=TF_D, nhead=TF_HEADS,
                            num_encoder_layers=layers,
                            num_decoder_layers=layers,
                            dim_feedforward=TF_FF, max_length=256).to(
        device=device, dtype=dtype)


def text_sources(seed):
    rng = np.random.RandomState(seed)
    src = rng.randint(2, TF_VOCAB, (TEXT_SRC_ROWS, TEXT_SRC_LEN))
    lengths = rng.randint(16, TEXT_SRC_LEN + 1, TEXT_SRC_ROWS)
    src[np.arange(TEXT_SRC_LEN)[None, :] >= lengths[:, None]] = 0
    return src.astype(np.int64), lengths


def count_steps(model):
    """Wrap ``model._decoder_step`` to count its calls; returns the
    counter list (one entry: the count)."""
    n = [0]
    inner = model._decoder_step

    def counted(*a, **kw):
        n[0] += 1
        return inner(*a, **kw)

    model._decoder_step = counted
    return n


def text_generate(device, card, profile=False):
    """``TransformerModel.generate`` at base width in bf16, greedy and
    beam: K2 launches = 2 x 6 (the encoder once) + 3 x 6 a decode step,
    every one warp-row, K4-K7 0 (every attention is masked), no plain
    version; tokens/s and ms a step. ``profile``: one more greedy decode
    under the port's ``Profiler``."""
    counters = train_counters()
    ln_fwd = counters["fused_layer_norm"]
    model = text_model(TF_LAYERS, device, SEED + 80, torch.bfloat16)
    src, lengths = text_sources(SEED + 81)
    src = torch.from_numpy(src).to(device)
    out = {}
    for name, kw in (("greedy", {}),
                     ("beam", dict(num_beams=TEXT_BEAMS,
                                   length_penalty=0.6))):
        model.generate(src[:2], max_length=8, **kw)          # warm-up
        steps = count_steps(model)
        torch.cuda.synchronize()
        reset_counts(counters)
        with count_plain() as plain:
            t0 = time.perf_counter()
            tokens = model.generate(src, max_length=TEXT_MAX_LEN, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        del model._decoder_step
        counts = read_counts(counters)
        want_ln = 2 * TF_LAYERS + 3 * TF_LAYERS * steps[0]
        others = {k: v for k, v in counts.items()
                  if k not in ("fused_layer_norm",)}
        if counts["fused_layer_norm"] != want_ln or any(others.values()) \
                or ln_fwd.warp_launches != want_ln or sum(plain.values()):
            raise AssertionError(
                f"phase 11 {name}: launches {counts} over {steps[0]} steps "
                f"(K2 {ln_fwd.warp_launches} warp-row), expected K2 "
                f"{want_ln} and nothing else; plain {dict(plain)}")
        if tokens.shape != (TEXT_SRC_ROWS, TEXT_MAX_LEN) or not (
                tokens[:, 0] == model.bos_id).all():
            raise AssertionError(f"phase 11 {name}: tokens {tokens.shape}")
        new = int((tokens[:, 1:] != model.pad_id).sum())
        out[name] = counts["fused_layer_norm"]
        log(f"phase 11 {name}: TransformerModel (base) {TF_LAYERS} + "
            f"{TF_LAYERS} layers, bf16, {TEXT_SRC_ROWS} sources of "
            f"{int(lengths.min())}-{int(lengths.max())} tokens padded to "
            f"{TEXT_SRC_LEN}, max_length {TEXT_MAX_LEN}{' ' + json.dumps(kw) if kw else ''}: "
            f"{steps[0]} decode steps in {wall:.3f} s on {card}: "
            f"{wall / steps[0] * 1e3:.3f} ms a step, {new / wall:.1f} "
            f"generated tokens/s; K2 {counts['fused_layer_norm']} launches "
            f"= 2 x {TF_LAYERS} + 3 x {TF_LAYERS} x {steps[0]}, all "
            f"warp-row; K4-K7 0 (every attention carries a mask); no "
            f"plain version")
    if profile:
        steps = count_steps(model)
        with device_profile() as prof:
            t0 = time.perf_counter()
            model.generate(src, max_length=TEXT_MAX_LEN)
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3
        del model._decoder_step
        device_time_report("seq2seq greedy", prof, prof_ms, steps[0])
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def text_parity(device):
    """The same model at 2 + 2 layers in float32 on the card and on a CPU
    copy, greedy: each row's tokens equal up to the first step whose top-2
    logit margin on the CPU falls below ``GEN_TOL`` (the margins from a
    teacher-forced forward over the CPU's tokens)."""
    from paddle_tpu_torch.convert import layer_from_jax, layer_to_numpy
    cpu = torch.device("cpu")
    card = text_model(TEXT_PARITY_LAYERS, device, SEED + 82)
    host = text_model(TEXT_PARITY_LAYERS, cpu, SEED + 83)
    layer_from_jax(host, layer_to_numpy(card))
    src, _ = text_sources(SEED + 84)
    got = card.generate(torch.from_numpy(src).to(device),
                        max_length=TEXT_MAX_LEN).cpu()
    want = host.generate(torch.from_numpy(src), max_length=TEXT_MAX_LEN)
    with torch.no_grad():
        logits = host(torch.from_numpy(src), want[:, :-1].long()).float()
    top2 = logits.topk(2, dim=-1).values
    margins = (top2[..., 0] - top2[..., 1]).numpy()
    compared, ties = 0, 0
    for r in range(src.shape[0]):
        end = TEXT_MAX_LEN - 1
        eos = (want[r, 1:] == host.eos_id).nonzero()
        if len(eos):
            end = int(eos[0]) + 1           # through the first EOS
        near = np.nonzero(margins[r, :end] < GEN_TOL)[0]
        stop = int(near[0]) + 1 if len(near) else end + 1
        ties += bool(len(near))
        if not torch.equal(got[r, :stop], want[r, :stop]):
            raise AssertionError(
                f"phase 11 parity row {r}: card {got[r, :stop].tolist()} "
                f"CPU {want[r, :stop].tolist()}")
        compared += stop
    log(f"phase 11 parity: TransformerModel at base width, "
        f"{TEXT_PARITY_LAYERS} + {TEXT_PARITY_LAYERS} layers, float32, "
        f"greedy: card = CPU on {compared} tokens of {src.shape[0]} rows "
        f"({ties} rows cut at a CPU top-2 margin below {GEN_TOL})")


def rnn_parity(device):
    """``nn.LSTM`` and ``nn.GRU`` (2 layers, bidirectional, with
    ``sequence_length``) on the card against a CPU copy: outputs, final
    states, the input's and every parameter's gradient within
    ``RNN_TOL`` of each tensor's largest value; then ``dynamic_decode``
    over a ``BeamSearchDecoder`` on an ``LSTMCell`` (beam 4, vocabulary
    1000, 16 steps): every row whose K + 1 best candidates on the CPU
    never come within ``GEN_TOL`` of each other gives the same ids, and
    its final log-probs agree within ``RNN_TOL``."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.models.generation as gen_mod
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.convert import layer_from_jax, layer_to_numpy
    cpu = torch.device("cpu")
    i_sz, h_sz, rows, steps = RNN_DIMS
    rng = np.random.RandomState(SEED + 85)
    x = rng.randn(rows, steps, i_sz).astype(np.float32)
    lengths = rng.randint(steps // 2, steps + 1, rows).astype(np.int64)
    report = []
    for cls in (nn.LSTM, nn.GRU):
        pt.seed(SEED + 86)
        card = cls(i_sz, h_sz, num_layers=2, direction="bidirect").to(device)
        host = cls(i_sz, h_sz, num_layers=2, direction="bidirect")
        layer_from_jax(host, layer_to_numpy(card))
        outs = {}
        for key, net, dev in (("card", card, device), ("host", host, cpu)):
            xt = torch.tensor(x, device=dev, requires_grad=True)
            y, state = net(xt, sequence_length=torch.from_numpy(
                lengths).to(dev))
            leaves = [y] + (list(state) if isinstance(state, tuple)
                            else [state])
            sum((t * t).sum() for t in leaves).backward()
            outs[key] = [t.detach().cpu() for t in leaves] + [
                xt.grad.cpu()] + [p.grad.cpu() for p in net.parameters()]
        worst = max(rn_rel(g, w) for g, w in zip(outs["card"],
                                                 outs["host"]))
        if worst > RNN_TOL:
            raise AssertionError(f"phase 11 {cls.__name__}: card vs CPU "
                                 f"{worst:.3e} beyond {RNN_TOL}")
        report.append(f"{cls.__name__} worst {worst:.3e}")
    vocab, emb, beam, max_steps = 1000, 256, 4, 16
    h0 = torch.from_numpy(0.5 * rng.randn(rows, h_sz).astype(np.float32))
    gaps, topk = [], gen_mod._beam_topk

    def spy(cand, k):
        if not cand.is_cuda:
            best = cand.topk(k + 1, dim=-1).values
            gaps.append((best[:, :-1] - best[:, 1:]).min(dim=1).values)
        return topk(cand, k)

    res = {}
    gen_mod._beam_topk = spy
    try:
        for key, dev in (("card", device), ("host", cpu)):
            pt.seed(SEED + 87)
            cell, embed = nn.LSTMCell(emb, h_sz), nn.Embedding(vocab, emb)
            proj = nn.Linear(h_sz, vocab)
            for m in (cell, embed, proj):
                m.to(dev)
            dec = nn.BeamSearchDecoder(cell, 0, 1, beam, embedding_fn=embed,
                                       output_fn=proj)
            h = h0.to(dev)
            with torch.no_grad():
                ids, lp = nn.dynamic_decode(dec, inits=(h, h * 0.5),
                                            max_step_num=max_steps)
            res[key] = (ids.cpu(), lp.cpu())
    finally:
        gen_mod._beam_topk = topk
    near = (torch.stack(gaps) < GEN_TOL).any(dim=0)           # [B]
    same = (res["card"][0] == res["host"][0]).flatten(1).all(dim=1)
    err = rn_rel(res["card"][1][~near], res["host"][1][~near]) \
        if bool((~near).any()) else 0.0
    if bool((~near & ~same).any()) or err > RNN_TOL:
        raise AssertionError(f"phase 11 dynamic_decode: rows "
                             f"{torch.nonzero(~near & ~same).flatten()} "
                             f"differ with no near-tie, log-probs {err:.3e}")
    report.append(f"dynamic_decode (beam {beam}, vocabulary {vocab}, "
                  f"{max_steps} steps): ids equal in {int(same.sum())} of "
                  f"{rows} rows, every row without a CPU gap below "
                  f"{GEN_TOL} among its K + 1 best candidates equal "
                  f"({int(near.sum())} with one), their log-probs within "
                  f"{err:.3e}")
    log(f"phase 11 recurrent: {i_sz} -> {h_sz}, 2 layers bidirectional, "
        f"batch {rows} x {steps} with lengths, card vs CPU within "
        f"{RNN_TOL}: " + "; ".join(report))


def phase_text(device, card, swept, profile=False):
    """11: the text models on the card: ``TransformerModel`` decoding
    (:func:`text_generate`, :func:`text_parity`), the recurrent layers and
    the beam decoder (:func:`rnn_parity`), and the 13 ``sequence_ops``
    among phase 6's swept ops (``swept``), none of which read the card
    back there (``SWEEP_SYNCING``)."""
    from paddle_tpu_torch.ops import op_cases, sequence_ops
    from paddle_tpu_torch.ops.registry import get_op, op_names
    seq = {n for n in op_names()
           if get_op(n).fn.__module__ == sequence_ops.__name__}
    cases = op_cases.cases(SEED)
    reads = sorted(k for k in SWEEP_SYNCING if cases[k].name in seq)
    if len(seq) != 13 or seq - set(swept) or reads:
        raise AssertionError(f"phase 11: sequence ops {sorted(seq)} not all "
                             f"swept on the card ({sorted(seq - set(swept))})"
                             f" or read the card back ({reads})")
    log(f"phase 11: the 13 sequence ops swept on the card against the CPU "
        f"within {SWEEP_TOL} in phase 6, none reading the card back")
    text_parity(device)
    rnn_parity(device)
    gc.collect()
    torch.cuda.empty_cache()
    return text_generate(device, card, profile)


# ---------------------------------------------------------------------------
# phase 12: the deployment path on the card
# ---------------------------------------------------------------------------

#: bench_serve (bench.py:471-535) and bench_lenet (bench.py:411-436)
SERVE_WARM, SERVE_SINGLES, SERVE_CLIENTS, SERVE_PER_CLIENT = 3, 50, 8, 40
LENET_BATCH, LENET_STEPS = 256, 6
#: Predictor.run / eager / to_static forwards timed at [32, 128]
DEPLOY_RUNS = 20


def deploy_counts(counters):
    """The LayerNorm and flash forward launches and their routes."""
    ln, fa = counters["fused_layer_norm"], counters["flash_attention_fwd"]
    return {"fused_layer_norm": ln.launches, "warp": ln.warp_launches,
            "flash_attention_fwd": fa.launches, "tc": fa.tc_launches,
            "others": sum(counters[k].launches for k in (
                "fused_layer_norm_bwd", "flash_attention_bwd",
                "fused_adamw"))}


def event_ms(fn, runs):
    """Median ms of ``fn()`` between CUDA events, each run synchronised."""
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def artifact_bytes(path):
    return sum(os.path.getsize(path + s)
               for s in (".pdmodel", ".pdiparams", ".meta.json"))


def deploy_bert(device, tmp, counters):
    """12 (i): BERT-base saved by ``Model.save(training=False)`` and
    served by the Predictor; returns the main path's launches."""
    from paddle_tpu_torch import inference, jit
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.models.bert import BertForQuestionAnswering
    from paddle_tpu_torch.static import InputSpec
    from paddle_tpu_torch import amp
    net = bert_net(BertForQuestionAnswering, 12, device, SEED).eval()
    specs = [InputSpec([None, BERT_SEQ], "int64", "input_ids"),
             InputSpec([None, BERT_SEQ], "int64", "token_type_ids")]
    model = Model(net, inputs=specs, device=device)
    model.prepare(amp_configs={"level": "O2", "dtype": "bfloat16"})
    path = os.path.join(tmp, "bert")
    t0 = time.perf_counter()
    model.save(path, training=False)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred = inference.create_predictor(inference.Config(path + ".pdmodel"))
    load_s = time.perf_counter() - t0
    vocab = net.bert.cfg.vocab_size

    def batch(rows):
        ids = bert_batch(rows, BERT_SEQ, vocab)[0]
        return ids, np.zeros_like(ids)

    def eager(ids, types):
        with torch.no_grad(), amp.auto_cast(level="O2", dtype="bfloat16"):
            return net(torch.from_numpy(ids).to(device),
                       torch.from_numpy(types).to(device))

    ids, types = batch(BERT_BATCH)
    want = [w.cpu() for w in eager(ids, types)]
    n_ln = sum(1 for m in net.modules() if type(m).__name__ == "LayerNorm")
    layers = len(net.bert.encoder.layers)
    per_run = {"fused_layer_norm": n_ln, "warp": n_ln,
               "flash_attention_fwd": layers, "tc": layers, "others": 0}
    runs = []

    def served():
        at = deploy_counts(counters)
        out = pred.run([ids, types])
        now = deploy_counts(counters)
        runs.append({k: now[k] - at[k] for k in now})
        return out

    reset_counts(counters)
    with count_plain() as plain:
        got = served()
        run_ms = event_ms(served, DEPLOY_RUNS)
    launches = read_counts(counters)
    if sum(plain.values()):
        raise AssertionError(f"phase 12: plain versions called {plain}")
    if runs != [per_run] * (DEPLOY_RUNS + 1):
        raise AssertionError(f"phase 12: launches a Predictor.run, expected "
                             f"{per_run}: {runs[:3]}")
    errs = [check_close(f"phase 12 served {n} logits",
                        torch.from_numpy(g), w, torch.bfloat16)
            for n, g, w in zip(("start", "end"), got, want)]
    for rows in (1, 7):
        i, t = batch(rows)
        outs = pred.run([i, t])
        for n, g, w in zip(("start", "end"), outs, eager(i, t)):
            w = w.cpu()
            if g.shape != (rows, BERT_SEQ):
                raise AssertionError(f"phase 12 batch {rows}: {n} "
                                     f"{g.shape}")
            check_close(f"phase 12 batch {rows} {n} logits",
                        torch.from_numpy(g), w, torch.bfloat16)
    eager_ms = event_ms(lambda: eager(ids, types), DEPLOY_RUNS)
    jit.to_static(net)
    reset_counts(counters)
    with count_plain() as plain:
        static_out = eager(ids, types)
        static_ms = event_ms(lambda: eager(ids, types), DEPLOY_RUNS)
    static_launches = read_counts(counters)
    if sum(plain.values()) or static_launches["fused_layer_norm"] != n_ln * (
            DEPLOY_RUNS + 1) or static_launches["flash_attention_fwd"] != \
            layers * (DEPLOY_RUNS + 1) or len(net.forward._programs) != 1:
        raise AssertionError(f"phase 12: to_static launches "
                             f"{static_launches}, plain {dict(plain)}, "
                             f"{len(net.forward._programs)} programs")
    for g, w in zip(static_out, want):
        check_close("phase 12 to_static logits", g.cpu(), w, torch.bfloat16)
    log(f"phase 12 (i): BERT-base (bench_bert's configuration, bf16 AMP O2) "
        f"saved by Model.save(training=False) in {export_s:.2f} s "
        f"({artifact_bytes(path)} bytes: .pdmodel, .pdiparams, .meta.json),"
        f" loaded by inference.create_predictor in {load_s:.2f} s; each "
        f"Predictor.run at [{BERT_BATCH}, {BERT_SEQ}] launched K2 = {n_ln} "
        f"(warp-row) and K4 = {layers} (tensor-core) from the loaded "
        f"program, no "
        f"plain version; start/end logits within bf16 TOL of the eager "
        f"network (max abs err {max(errs):.3e}); batch 1 and 7 from the "
        f"same artifact")
    log(f"phase 12 (i) timing: Predictor.run {run_ms:.3f} ms a batch "
        f"(median of {DEPLOY_RUNS}, CUDA events, numpy in and out), "
        f"{BERT_BATCH / run_ms * 1e3:.1f} sequences/s; the same forward "
        f"eager {eager_ms:.3f} ms, through jit.to_static {static_ms:.3f} "
        f"ms (one captured program)")
    del net, model, pred
    gc.collect()
    torch.cuda.empty_cache()
    return {"fused_layer_norm": launches["fused_layer_norm"]
            + static_launches["fused_layer_norm"],
            "flash_attention_fwd": launches["flash_attention_fwd"]
            + static_launches["flash_attention_fwd"]}


def deploy_bert_f32(device, tmp):
    """12 (i): a 2-layer float32 BERT saved on the CPU, run on the card."""
    from paddle_tpu_torch import inference, jit
    from paddle_tpu_torch.models.bert import BertForQuestionAnswering
    from paddle_tpu_torch.static import InputSpec
    cpu = torch.device("cpu")
    host = bert_net(BertForQuestionAnswering, BERT_PARITY_LAYERS, cpu,
                    SEED + 81).eval()
    path = os.path.join(tmp, "bert_f32")
    jit.save(host, path, input_spec=[
        InputSpec([None, BERT_SEQ], "int64", "input_ids"),
        InputSpec([None, BERT_SEQ], "int64", "token_type_ids")])
    ids = bert_batch(BERT_PARITY_BATCH, BERT_SEQ, 30522)[0]
    types = np.zeros_like(ids)
    with torch.no_grad():
        want = host(torch.from_numpy(ids), torch.from_numpy(types))
    pred = inference.create_predictor(inference.Config(path + ".pdmodel"))
    if pred.device.type != device.type:
        raise AssertionError(f"phase 12: the CPU-saved artifact loaded on "
                             f"{pred.device}, not {device}")
    got = pred.run([ids, types])
    errs = [rn_rel(torch.from_numpy(g), w) for g, w in zip(got, want)]
    if not max(errs) <= TF_PARITY_TOL:
        raise AssertionError(f"phase 12: CPU-saved float32 artifact on the "
                             f"card vs the CPU: {errs} > {TF_PARITY_TOL}")
    log(f"phase 12 (i): a {BERT_PARITY_LAYERS}-layer float32 BERT saved on "
        f"the CPU, run on the card: start/end logits within "
        f"{TF_PARITY_TOL} of the CPU (worst {max(errs):.3e})")


def deploy_lenet_serve(device, tmp):
    """12 (ii): bench_serve's LeNet through create_predictor and
    BatchingEngine; returns the artifact's path and its predictor."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import inference, jit
    from paddle_tpu_torch.static import InputSpec
    from paddle_tpu_torch.vision.models import LeNet
    pt.seed(SEED)
    net = LeNet().to(device).eval()
    path = os.path.join(tmp, "lenet")
    jit.save(net, path, input_spec=[InputSpec([None, 1, 28, 28],
                                              "float32")])
    pred = inference.create_predictor(inference.Config(path + ".pdmodel"))
    rng = np.random.RandomState(SEED)
    one = rng.randn(1, 1, 28, 28).astype(np.float32)
    eng = inference.BatchingEngine(pred, max_batch_size=32, max_delay_ms=0)
    for _ in range(SERVE_WARM):
        eng.infer(one)
    lat = []
    for _ in range(SERVE_SINGLES):
        t0 = time.perf_counter()
        eng.infer(one)
        lat.append((time.perf_counter() - t0) * 1e3)
    eng.close()
    lat.sort()
    p50 = lat[len(lat) // 2]
    p95 = lat[max(0, math.ceil(0.95 * len(lat)) - 1)]
    requests = [[rng.randn(1, 1, 28, 28).astype(np.float32)
                 for _ in range(SERVE_PER_CLIENT)]
                for _ in range(SERVE_CLIENTS)]
    single = [[pred.run([x])[0] for x in reqs] for reqs in requests]
    eng2 = inference.BatchingEngine(pred, max_batch_size=64,
                                    max_delay_ms=3.0)
    for _ in range(SERVE_WARM):
        eng2.infer(one)
    results = [[None] * SERVE_PER_CLIENT for _ in range(SERVE_CLIENTS)]

    def client(c):
        for j, x in enumerate(requests[c]):
            results[c][j] = eng2.infer(x)[0]

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    wall = time.perf_counter() - t0
    eng2.close()
    if any(t.is_alive() for t in threads):
        raise AssertionError("phase 12 (ii): a client did not finish")
    worst = max(check_close(f"phase 12 client {c} request {j}",
                            torch.from_numpy(results[c][j]),
                            torch.from_numpy(single[c][j]), torch.float32)
                for c in range(SERVE_CLIENTS)
                for j in range(SERVE_PER_CLIENT))
    total = SERVE_CLIENTS * SERVE_PER_CLIENT
    log(f"phase 12 (ii): bench_serve's LeNet (jit.save with InputSpec([None,"
        f" 1, 28, 28]), create_predictor on the card): latency mode "
        f"(max_batch_size 32, max_delay_ms 0) p50 {p50:.3f} ms p95 "
        f"{p95:.3f} ms over {SERVE_SINGLES} singles; throughput "
        f"(max_batch_size 64, max_delay_ms 3.0, {SERVE_CLIENTS} clients x "
        f"{SERVE_PER_CLIENT}) {total / wall:.1f} requests/s; every "
        f"client's rows equal to a single-request run (max abs err "
        f"{worst:.3e})")
    return path, pred


def deploy_static_lenet(device, tmp, counters):
    """12 (iii): static-mode Model.fit of LeNet at bench_lenet's batch;
    returns K8's launches and the parameter shapes."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import static
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.static import InputSpec
    from paddle_tpu_torch.vision.models import LeNet
    rng = np.random.RandomState(SEED)
    x = rng.randn(LENET_BATCH, 1, 28, 28).astype(np.float32)
    y = rng.randint(0, 10, (LENET_BATCH, 1)).astype(np.int64)
    numels = []
    steps, losses = [], []

    class Steps(Callback):
        def on_train_batch_begin(self, step, logs=None):
            self.at = read_counts(counters)

        def on_train_batch_end(self, step, logs=None):
            now = read_counts(counters)
            steps.append({k: now[k] - self.at[k] for k in now})
            losses.append(logs["loss"])

    pt.enable_static()
    try:
        pt.seed(SEED)
        net = LeNet().to(device)
        numels = [p.numel() for p in net.parameters()]
        model = Model(net, inputs=[InputSpec([None, 1, 28, 28], "float32",
                                             "image")],
                      labels=[InputSpec([None, 1], "int64", "label")],
                      device=device)
        model.prepare(pt.optimizer.Adam(learning_rate=1e-3,
                                        parameters=net.parameters()),
                      pt.nn.CrossEntropyLoss())
        data = pt.io.TensorDataset([np.concatenate([x] * LENET_STEPS),
                                    np.concatenate([y] * LENET_STEPS)])
        reset_counts(counters)
        with count_plain() as plain:
            t0 = time.perf_counter()
            model.fit(data, batch_size=LENET_BATCH, epochs=1,
                      shuffle=False, log_freq=1, verbose=0,
                      callbacks=[Steps()])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = read_counts(counters)
        want = {"flash_attention_fwd": 0, "flash_attention_bwd": 0,
                "fused_layer_norm": 0, "fused_layer_norm_bwd": 0,
                "fused_adamw": adamw_launches(numels),
                "fused_adamw_tensors": len(numels)}
        if sum(plain.values()) or steps != [want] * LENET_STEPS:
            raise AssertionError(f"phase 12 (iii): launches a step {steps[:3]}"
                                 f", expected {want}; plain {dict(plain)}")
        if not all(math.isfinite(v) for v in losses) or \
                not losses[-1] < losses[0]:
            raise AssertionError(f"phase 12 (iii): losses {losses}")
        prefix = os.path.join(tmp, "lenet_static")
        static.save_inference_model(prefix, [InputSpec(
            [None, 1, 28, 28], "float32", "image")], net)
        from paddle_tpu_torch.framework.place import from_torch_device
        layer, names, _ = static.load_inference_model(
            prefix, static.Executor(from_torch_device(device)))
        (ref,) = model.predict_batch([torch.from_numpy(x[:8]).to(device)])
        err = check_close("phase 12 (iii) load_inference_model",
                          layer(x[:8]).cpu(), torch.from_numpy(ref),
                          torch.float32)
    finally:
        pt.disable_static()
    log(f"phase 12 (iii): enable_static(); Model.fit of LeNet (bench_lenet: "
        f"batch {LENET_BATCH}, Adam(1e-3)) for {LENET_STEPS} steps through "
        f"the captured Program / Executor in {wall:.3f} s: K8 "
        f"{want['fused_adamw']} launch(es) over {len(numels)} tensors a "
        f"step, no plain version, losses {json.dumps(losses)}; "
        f"save_inference_model / load_inference_model ({names}) within "
        f"float32 TOL of the static test program (max abs err {err:.3e})")
    return launches["fused_adamw"], [tuple(p.shape)
                                     for p in net.parameters()]


def deploy_capi(pred, path):
    """12 (iv): the C API built with g++ runs one LeNet batch from C."""
    import ctypes
    from paddle_tpu_torch.inference.capi import load_capi
    t0 = time.perf_counter()
    lib, so = load_capi()
    build_s = time.perf_counter() - t0
    repo = os.path.dirname(os.path.abspath(__file__))
    if lib.PDT_Init(repo.encode()) != 0:
        raise AssertionError(f"PDT_Init: {lib.PDT_LastError()}")
    handle = lib.PDT_PredictorCreate(path.encode())
    if not handle:
        raise AssertionError(f"PDT_PredictorCreate: {lib.PDT_LastError()}")
    x = np.random.RandomState(SEED + 12).randn(8, 1, 28, 28).astype(
        np.float32)
    shape = (ctypes.c_int64 * x.ndim)(*x.shape)
    out = ctypes.POINTER(ctypes.c_float)()
    out_shape = ctypes.POINTER(ctypes.c_int64)()
    out_ndim = ctypes.c_int()
    rc = lib.PDT_PredictorRun(
        handle, x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), shape,
        x.ndim, ctypes.byref(out), ctypes.byref(out_shape),
        ctypes.byref(out_ndim))
    if rc != 0:
        raise AssertionError(f"PDT_PredictorRun: {lib.PDT_LastError()}")
    dims = [out_shape[i] for i in range(out_ndim.value)]
    got = np.ctypeslib.as_array(out, shape=(int(np.prod(dims)),)).reshape(
        dims).copy()
    lib.PDT_BufferFree(out)
    lib.PDT_BufferFree(out_shape)
    lib.PDT_PredictorDestroy(handle)
    err = check_close("phase 12 (iv) C API", torch.from_numpy(got),
                      torch.from_numpy(pred.run([x])[0]), torch.float32)
    log(f"phase 12 (iv): the C API ({os.path.basename(so)}, g++ build "
        f"{build_s:.2f} s) ran LeNet on the card from C: output {dims} "
        f"equal to the Predictor's (max abs err {err:.3e})")


def phase_deploy(device, timer):
    """12: the deployment path (``deploy_bert``, ``deploy_bert_f32``,
    ``deploy_lenet_serve``, ``deploy_static_lenet``, ``deploy_capi``).
    Returns the main path's K2/K4 launches at ``[32, 128]`` (for the
    ``_bert`` rows) and the ``fused_adamw_step_lenet`` row."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    counters = train_counters()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_deploy_")
    try:
        bert = deploy_bert(device, tmp, counters)
        deploy_bert_f32(device, tmp)
        path, pred = deploy_lenet_serve(device, tmp)
        k8, shapes = deploy_static_lenet(device, tmp, counters)
        deploy_capi(pred, path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    row = adamw_step_case(timer, device, shapes, None, 1e-3, 0.0)
    log(f"phase 12 fused_adamw_step_lenet {fmt(row)}")
    lenet = {"name": "fused_adamw_step_lenet", "route": "cuda",
             "source": ADAMW_SRC, "replaces": ADAMW_TPU, "launches": k8,
             **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms")},
             **{k: row[k] for k in STEP_KEYS}, "launches_note": STEP_NOTE}
    log(f"phase 12: {time.perf_counter() - t0:.1f} s")
    return bert, lenet


# ---------------------------------------------------------------- phase 13
CORE_WARM, CORE_TIMED = 2, 6    # steps of each loader run
CORE_WORKERS = 2
CORE_ORDER = "ABBA"


def token_windows(path):
    """A GPT-2 trainer's data: ``(ids, labels)`` windows of ``SEQ + 1``
    tokens read from a ``uint16`` token file through ``np.memmap``."""
    import paddle_tpu_torch as pt

    class TokenWindows(pt.io.Dataset):
        def __init__(self):
            self.tokens = np.memmap(path, dtype=np.uint16, mode="r")

        def __len__(self):
            return len(self.tokens) // (SEQ + 1)

        def __getitem__(self, i):
            w = self.tokens[i * (SEQ + 1):(i + 1) * (SEQ + 1)].astype(
                np.int64)
            return w[:-1], w[1:]

    return TokenWindows()


def core_loader(ds, workers):
    """``ds`` through a shuffled ``DistributedBatchSampler`` (one replica,
    epoch 0) and the port's ``DataLoader`` with ``workers`` workers."""
    import paddle_tpu_torch as pt
    sampler = pt.io.DistributedBatchSampler(ds, batch_size=BATCH,
                                            num_replicas=1, rank=0,
                                            shuffle=True)
    sampler.set_epoch(0)
    loader = pt.io.DataLoader(ds, batch_sampler=sampler,
                              num_workers=workers,
                              collate_fn=pt.io.default_collate_fn)
    if not isinstance(loader, pt.io.DataLoader) or \
            len(loader) != CORE_WARM + CORE_TIMED:
        raise AssertionError(f"phase 13: the loader {type(loader)} of "
                             f"{len(loader)} batches")
    return loader


def core_model(device):
    """GPT-2 small as phase 4 builds it (bf16 O2, AdamW with f32 masters)
    from the weights of one seed."""
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.optimizer import AdamW
    net, cfg = gpt2_small(SEED + 130, device)
    model = Model(net, inputs=["ids", "labels"], device=device)
    model.prepare(AdamW(LR, parameters=net.parameters(), weight_decay=WD,
                        multi_precision=True),
                  loss=lambda loss, logits: loss,
                  amp_configs={"level": "O2", "dtype": "bfloat16"})
    return model, net, cfg


def core_run(what, device, ds, workers, prefetch, counters):
    """One ``Model.fit`` epoch of a fresh seeded GPT-2 small over ``ds``
    with ``workers`` loader workers and ``prefetch``: each step's batch
    checksum and loss (kept on the card, read after the fit), CUDA events
    at each step's end, the launches counted over the fit; with
    ``prefetch``, every step from the second on (the prefetch producer's
    and consumer's work in them too) under sync debug "error". Returns
    the run's record and the Model."""
    from paddle_tpu_torch.framework import monitor
    from paddle_tpu_torch.hapi import Callback
    model, net, cfg = core_model(device)
    n = CORE_WARM + CORE_TIMED
    weights = torch.arange(1, BATCH * SEQ + 1, device=device).view(
        BATCH, SEQ)
    sums, losses, stamps, first = [], [], [], []

    def spy(inputs, labels, update=True, _orig=model._train_step):
        if not first:
            first.append(time.perf_counter())
        sums.append((inputs[0].long() * weights).sum())
        loss, outs = _orig(inputs, labels, update)
        losses.append(loss)
        return loss, outs

    class Steps(Callback):
        def on_train_batch_begin(self, step, logs=None):
            if step == 1 and prefetch:
                torch.cuda.set_sync_debug_mode("error")

        def on_train_batch_end(self, step, logs=None):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            stamps.append(ev)
            if step == n - 1:
                torch.cuda.set_sync_debug_mode(0)

        def on_train_abort(self):
            torch.cuda.set_sync_debug_mode(0)

    model._train_step = spy
    loader = core_loader(ds, workers)
    waits0 = len(monitor.histogram_samples("prefetch_wait_ms"))
    batches0 = monitor.stat_get("prefetch_batches")
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    with count_plain() as plain:
        t0 = time.perf_counter()
        model.fit(loader, epochs=1, log_freq=10 * n, verbose=0,
                  prefetch=prefetch, callbacks=[Steps()])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_counts(counters)
    del model._train_step
    peak = torch.cuda.max_memory_allocated()
    if sum(plain.values()) or len(losses) != n:
        raise AssertionError(f"phase 13 {what}: plain versions "
                             f"{dict(plain)}, {len(losses)} steps")
    check_launches(f"phase 13 {what}", launches, expected_launches(
        cfg.num_hidden_layers, [p.numel() for p in net.parameters()]), n)
    check_flash_route(f"phase 13 {what}", counters, "tc")
    check_ln_route(f"phase 13 {what}", (counters["fused_layer_norm"],
                                        counters["fused_layer_norm_bwd"]))
    step_ms = [stamps[i - 1].elapsed_time(stamps[i])
               for i in range(CORE_WARM, n)]
    timed_ms = stamps[CORE_WARM - 1].elapsed_time(stamps[-1])
    waits = monitor.histogram_samples("prefetch_wait_ms")[waits0:]
    rec = {"sums": [int(s) for s in sums],
           "losses": [float(x) for x in losses],
           "launches": launches, "step_ms": step_ms,
           "ms": timed_ms / CORE_TIMED,
           "tokens_s": BATCH * SEQ * CORE_TIMED / timed_ms * 1e3,
           "first_batch_s": first[0] - t0, "wall": wall, "peak": peak,
           "waits": waits,
           "batches": monitor.stat_get("prefetch_batches") - batches0}
    if not all(math.isfinite(x) for x in rec["losses"]):
        raise AssertionError(f"phase 13 {what}: losses {rec['losses']}")
    return rec, model


def no_update(n_layers):
    """The launches of one forward and backward without a step."""
    return dict(expected_launches(n_layers, []), fused_adamw=0)


def core_accumulate(model, ids, labels, counters):
    """``train_batch(update=False)`` on the two halves of one batch against
    ``autograd.grad`` of each half, then one ``update=True`` call. Returns
    the launches of the grad calls and the train_batch calls and the
    largest difference over each tensor's largest value."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.optimizer.optimizer as opt_module
    net = model.network
    params = [p for p in net.parameters() if p.requires_grad]
    numels = [p.numel() for p in params]
    backward = no_update(net.gpt.cfg.num_hidden_layers)
    halves = [[torch.from_numpy(a[rows]).to(model.device)
               for a in (ids, labels)]
              for rows in (slice(0, BATCH // 2), slice(BATCH // 2, BATCH))]
    model._optimizer.clear_grad()
    want = None
    total = {}
    for h in halves:
        reset_counts(counters)
        with model._maybe_amp():
            _, loss = model._forward(h, [])
        got = pt.autograd.grad(loss, params, retain_graph=False)
        counts = read_counts(counters)
        if any(p.grad is not None for p in params) or counts != backward:
            raise AssertionError(f"phase 13 autograd.grad: launches {counts}"
                                 f", .grad set on "
                                 f"{sum(p.grad is not None for p in params)}")
        want = got if want is None else [a + b for a, b in zip(want, got)]
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    grad_counts = dict(total)
    with count_plain() as plain:
        for h in halves:
            reset_counts(counters)
            model.train_batch(h, update=False)
            counts = read_counts(counters)
            if counts != backward:
                raise AssertionError(f"phase 13 update=False: launches "
                                     f"{counts}")
            for k, v in counts.items():
                total[k] += v
            if any(p.grad is None for p in params):
                raise AssertionError("phase 13 update=False: .grad unset")
        worst = 0.0
        for p, w in zip(params, want):
            err = (p.grad.float() - w.float()).abs().max().item()
            scale = max(w.float().abs().max().item(), 1e-30)
            atol, _ = TOL[torch.bfloat16]
            if err > atol * scale:
                raise AssertionError(f"phase 13: accumulated .grad off the "
                                     f"summed autograd.grad by {err} "
                                     f"(largest {scale})")
            worst = max(worst, err / scale)
        reset_counts(counters)
        model.train_batch(halves[0], update=True)
        counts = read_counts(counters)
    if counts != expected_launches(net.gpt.cfg.num_hidden_layers, numels) \
            or any(p.grad is not None for p in params) or sum(plain.values()):
        raise AssertionError(f"phase 13 update=True: launches {counts}, "
                             f"plain {dict(plain)}")
    for k, v in counts.items():
        total[k] += v
    return grad_counts, total, worst


def phase_core_api(device, card):
    """13: the core API on GPT-2 small (phase 4's model and optimizer)
    trained through ``Model.fit`` fed the way a GPT-2 trainer feeds it: a
    ``uint16`` token file read through ``np.memmap`` windows, a shuffled
    ``DistributedBatchSampler`` and the port's ``DataLoader``. Run A: no
    worker, no prefetch; run B: 2 workers and ``device_prefetch``; in the
    order A, B, B, A, each from the same seeded weights: the same batches
    and losses, the launches of phase 4 a step, no host sync in B's steps
    from the second on. Then gradient accumulation
    (``train_batch(update=False)``) against ``autograd.grad`` at full
    width, ``Model.summary``, ``flops``, ``device.cuda`` and ``utils.
    dlpack`` on the card. Returns the launches of its counted runs."""
    import tempfile
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import GPTConfig
    t_phase = time.perf_counter()
    counters = train_counters()
    n = CORE_WARM + CORE_TIMED
    vocab = GPTConfig.gpt2_small().vocab_size
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tokens_") as tmp:
        path = os.path.join(tmp, "tokens.u16")
        np.random.RandomState(SEED).randint(
            0, vocab, BATCH * n * (SEQ + 1)).astype(np.uint16).tofile(path)
        ds = token_windows(path)
        runs, model = {"A": [], "B": []}, None
        for which in CORE_ORDER:        # A B B A: drift falls on both
            del model
            gc.collect()
            workers, prefetch = (0, False) if which == "A" else \
                (CORE_WORKERS, True)
            rec, model = core_run(f"{which} ({workers} workers, prefetch "
                                  f"{prefetch})", device, ds, workers,
                                  prefetch, counters)
            runs[which].append(rec)
            if which == "B" and len(runs["B"]) == 1:
                peak_b = (pt.device.cuda.max_memory_allocated(),
                          torch.cuda.max_memory_allocated())
                summary = pt.device.memory_summary()
    a = runs["A"][0]
    for what, r in ((w, r) for w in "AB" for r in runs[w]):
        if r["sums"] != a["sums"]:
            raise AssertionError(f"phase 13: run {what} saw other batches: "
                                 f"{r['sums']}, A {a['sums']}")
        for i, (x, y) in enumerate(zip(a["losses"], r["losses"])):
            check_close(f"phase 13 loss {i} A vs {what}", torch.tensor([y]),
                        torch.tensor([x]), torch.bfloat16)
        if what == "B" and (r["batches"] != n or len(r["waits"]) != n):
            raise AssertionError(f"phase 13 B: {r['batches']} prefetched "
                                 f"batches, {len(r['waits'])} waits")
        log(f"phase 13 run {what}: GPT-2 small bf16 O2 through Model.fit "
            f"over np.memmap token windows, DistributedBatchSampler "
            f"(shuffle, epoch 0) and io.DataLoader: {CORE_TIMED} timed "
            f"steps {r['ms']:.3f} ms a step (CUDA events), median "
            f"{float(np.median(r['step_ms'])):.3f} ms, {r['tokens_s']:.1f} "
            f"tokens/s; first batch in hand {r['first_batch_s']:.3f} s "
            f"after fit() began; the fit {r['wall']:.3f} s; max memory "
            f"allocated {r['peak']} bytes; on {card}")
    if peak_b[0] != peak_b[1]:
        raise AssertionError(f"phase 13: max_memory_allocated {peak_b}")
    diff = max(abs(x - y) for w in "AB" for r in runs[w]
               for x, y in zip(a["losses"], r["losses"]))
    log(f"phase 13 batch checksums (every run equal): {json.dumps(a['sums'])}")
    log(f"phase 13 losses A {json.dumps(a['losses'])}: the largest "
        f"difference of any run's from them {diff}")
    for w, (ra, rb) in ((w, (runs["A"][i], runs["B"][i]))
                        for i, w in enumerate(("first", "second"))):
        log(f"phase 13 {w} pair: A {ra['ms']:.3f} / B {rb['ms']:.3f} ms a "
            f"step, B/A {rb['ms'] / ra['ms']:.4f}")
    for i, b in enumerate(runs["B"]):
        w = np.asarray(b["waits"])
        log(f"phase 13 B run {i + 1} prefetch: {b['batches']} batches, "
            f"prefetch_wait_ms p50 {np.percentile(w, 50):.4f} p95 "
            f"{np.percentile(w, 95):.4f} max {w.max():.4f} first "
            f"{w[0]:.4f} (all {json.dumps(w.tolist())}); no host sync in "
            f"steps 2-{n} under sync debug 'error'; B's first batch in "
            f"hand {b['first_batch_s'] - a['first_batch_s']:.3f} s after "
            f"A's (the workers' start-up)")
    log(f"phase 13 launches a run ({n} steps): A "
        f"{json.dumps(a['launches'])}, B {json.dumps(runs['B'][0]['launches'])}")
    log("phase 13 device.memory_summary() after the first run B:\n"
        + summary)
    log(f"phase 13 device.cuda.max_memory_allocated() {peak_b[0]} = "
        f"torch.cuda.max_memory_allocated() {peak_b[1]}")

    tokens = np.random.RandomState(SEED + 131).randint(0, vocab,
                                                       (BATCH, SEQ + 1))
    grad_counts, acc_counts, worst = core_accumulate(
        model, tokens[:, :-1], tokens[:, 1:], counters)
    log(f"phase 13 accumulation: train_batch(update=False) on 2 x [4, "
        f"{SEQ}]: .grad = the summed autograd.grad within "
        f"{worst:.3e} of each tensor's largest (bf16 TOL "
        f"{TOL[torch.bfloat16][0]}), K8 0 until update=True launched "
        f"{acc_counts['fused_adamw']}; autograd.grad launches "
        f"{json.dumps(grad_counts)}")
    net = model.network
    total = sum(p.numel() for p in net.parameters())
    got = model.summary()
    if got["total_params"] != total:
        raise AssertionError(f"phase 13: Model.summary {got}, {total}")
    x = torch.from_numpy(tokens[:, :-1]).to(device)
    y = torch.from_numpy(tokens[:, 1:]).to(device)
    with model._maybe_amp():
        fl = pt.flops(net, inputs=[x, y])
    log(f"phase 13 Model.summary total_params {got['total_params']} = "
        f"sum(p.numel()); flops of one [{BATCH}, {SEQ}] forward {fl:.4e}, "
        f"2 x params x tokens {2 * total * BATCH * SEQ:.4e}, 6 x params x "
        f"tokens {6 * total * BATCH * SEQ:.4e} (ratio "
        f"{fl / (6 * total * BATCH * SEQ):.4f})")
    t = torch.arange(1024, device=device, dtype=torch.float32)
    u = pt.utils.dlpack.from_dlpack(pt.utils.dlpack.to_dlpack(t))
    if u.data_ptr() != t.data_ptr() or not torch.equal(u, t):
        raise AssertionError("phase 13: dlpack did not keep the memory")
    log(f"phase 13 utils.dlpack round trip keeps data_ptr "
        f"{u.data_ptr():#x}; device {pt.device.get_all_device_type()} "
        f"cudnn {pt.device.get_cudnn_version()} version.cuda "
        f"{pt.version.cuda()}")
    del model, net
    gc.collect()
    counts = {k: sum(r["launches"][k] for w in "AB" for r in runs[w])
              + acc_counts[k] for k in acc_counts}
    log(f"phase 13: {time.perf_counter() - t_phase:.1f} s")
    return counts


# ---------------------------------------------------------------- phase 14
#: phase 14: BERT-base at phase 10's configuration fine-tuned through a
#: 1.x fluid program (steps after the first: warm-up, then timed), the
#: served forward's runs, and ResNet-50 (phase 7's ``bench_resnet50``
#: configuration) exported to ONNX on the card
LEGACY_WARM, LEGACY_STEPS, LEGACY_SERVE_RUNS = 2, 5, 10
LEGACY_EMA = 0.999


def legacy_program(device, seed, train=True):
    """BERT-base (``bench_bert``'s ``BertConfig``, dropouts 0) decorated
    bf16 O2, under ``fluid.program_guard`` and ``amp.auto_cast`` O2: the
    1.x feeds ``fluid.layers.data`` (the batch dimension prepended), the
    pooled output into a 1.x head ``static.nn.fc(768, gelu)`` ->
    ``static.nn.layer_norm`` -> ``static.nn.fc(2)``, whose parameters are
    made bf16 as O2 makes the body's, and the loss ``mean(fluid.layers.
    softmax_with_cross_entropy)``. With ``train``: ``AdamW(BERT_LR,
    BERT_WD, multi_precision=True).minimize(loss, no_grad_set=<the three
    embedding tables>)``, ``static.gradients(loss, [the head's first
    weight])`` and an ``ExponentialMovingAverage`` bound to the
    program."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import amp, fluid, static
    from paddle_tpu_torch.models.bert import BertModel
    from paddle_tpu_torch.optimizer import AdamW
    bert = bert_net(BertModel, 12, device, seed)
    amp.decorate(bert, level="O2", dtype="bfloat16")
    emb = bert.embeddings
    tables = [emb.word_embeddings.weight, emb.position_embeddings.weight,
              emb.token_type_embeddings.weight]
    main, startup = fluid.Program(), fluid.Program()
    out = {"main": main, "startup": startup, "bert": bert, "tables": tables}
    dtype = pt.get_default_dtype()
    with fluid.program_guard(main, startup), \
            amp.auto_cast(level="O2", dtype="bfloat16"):
        ids = fluid.layers.data("input_ids", [BERT_SEQ], "int64")
        types = fluid.layers.data("token_type_ids", [BERT_SEQ], "int64")
        label = fluid.layers.data("label", [1], "int64")
        _, pooled = bert(ids, token_type_ids=types)
        pt.set_default_dtype("bfloat16")
        try:
            h = static.nn.fc(pooled, size=bert.cfg.hidden_size,
                             activation="gelu")
            h = static.nn.layer_norm(h)
            logits = static.nn.fc(h, size=2)
        finally:
            pt.set_default_dtype(dtype)
        loss = pt.mean(fluid.layers.softmax_with_cross_entropy(logits,
                                                               label))
        body = {id(p) for p in bert.parameters()}
        out.update(ids=ids, types=types, logits=logits, loss=loss,
                   head=[p for p in main._params.values()
                         if id(p) not in body])
        if train:
            opt = AdamW(BERT_LR, weight_decay=BERT_WD, multi_precision=True)
            opt.minimize(loss, no_grad_set=tables)
            (grad,) = static.gradients(loss, [out["head"][0]])
            out.update(opt=opt, grad=grad,
                       ema=static.ExponentialMovingAverage(LEGACY_EMA))
    return out


def legacy_feed(vocab):
    """``bench_bert``'s ids (``bert_batch``), token types 0, and a label
    a row from its start position's parity."""
    ids, start, _ = bert_batch(BERT_BATCH, BERT_SEQ, vocab)
    return {"input_ids": ids, "token_type_ids": np.zeros_like(ids),
            "label": (start % 2).reshape(-1, 1).astype(np.int64)}


def legacy_eager(net, feed, device):
    """One eager forward and backward of the program's network (its own
    body, the head's parameters shared into ``nn`` layers), the same ops
    ``call_op`` runs when the program is built: the loss and the head's
    first weight's gradient; every gradient cleared after."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn import functional as F
    d = net["bert"].cfg.hidden_size
    fc1, ln, fc2 = pt.nn.Linear(d, d), pt.nn.LayerNorm(d), pt.nn.Linear(d, 2)
    mine = [fc1.weight, fc1.bias, ln.weight, ln.bias, fc2.weight, fc2.bias]
    for own, shared in zip(mine, net["head"]):
        own.data = shared.data
    t = {k: torch.from_numpy(v).to(device) for k, v in feed.items()}
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        _, pooled = net["bert"](t["input_ids"],
                                token_type_ids=t["token_type_ids"])
        logits = fc2(ln(F.gelu(fc1(pooled))))
        loss = pt.mean(F.softmax_with_cross_entropy(logits, t["label"]))
    loss.backward()
    grad = fc1.weight.grad.detach().clone()
    for q in mine + list(net["bert"].parameters()) + net["head"]:
        q.grad = None
    return loss.detach().float().cpu(), grad


def onnx_graph(path):
    """``(nodes, initializers)`` of an ONNX file: each node as (op type,
    attribute fields, inputs, outputs), each initializer by name as
    (dims, dtype code, raw bytes). A reader of the wire format of its
    own (varints and length-delimited fields)."""
    def varint(buf, i):
        out = shift = 0
        while True:
            b = buf[i]
            i += 1
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out, i
            shift += 7

    def fields(buf):
        i = 0
        while i < len(buf):
            tag, i = varint(buf, i)
            if tag & 7 == 0:
                val, i = varint(buf, i)
            elif tag & 7 == 2:
                n, i = varint(buf, i)
                val, i = bytes(buf[i:i + n]), i + n
            elif tag & 7 == 5:
                val, i = bytes(buf[i:i + 4]), i + 4
            else:
                raise AssertionError(f"wire type {tag & 7}")
            yield tag >> 3, val

    data = open(path, "rb").read()
    graph = next(v for f, v in fields(data) if f == 7)
    nodes, inits = [], {}
    for f, v in fields(graph):
        if f == 1:
            node = {1: [], 2: [], 4: None, 5: []}
            for ff, vv in fields(v):
                if ff in (1, 2, 5):
                    node[ff].append(vv)
                elif ff == 4:
                    node[4] = vv.decode()
            nodes.append((node[4], tuple(node[5]), tuple(node[1]),
                          tuple(node[2])))
        elif f == 5:
            t = {1: [], 2: None, 8: None, 9: b""}
            for ff, vv in fields(v):
                if ff == 1:
                    t[1].append(vv)
                elif ff in (2, 9):
                    t[ff] = vv
                elif ff == 8:
                    t[8] = vv.decode()
            inits[t[8]] = (tuple(t[1]), t[2], t[9])
    return nodes, inits


def legacy_onnx(device, tmp):
    """14 (v): ResNet-50 (``bench_resnet50``'s configuration) built on
    the card and exported by ``onnx.export``: every initializer of a
    parameter bit-equal to the card's parameter in the JAX layout, and
    the node list and the initializers equal to the export of the same
    weights on the CPU. Returns (bytes, seconds)."""
    import copy
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import onnx
    from paddle_tpu_torch.static import InputSpec
    from paddle_tpu_torch.vision.models import resnet50
    pt.seed(SEED)
    net = resnet50(num_classes=RN_CLASSES).to(device).eval()
    spec = [InputSpec([None, 3, RN_HW, RN_HW], "float32", "image")]
    host = copy.deepcopy(net).cpu()
    t0 = time.perf_counter()
    path = onnx.export(net, os.path.join(tmp, "resnet50"), input_spec=spec)
    secs = time.perf_counter() - t0
    nodes, inits = onnx_graph(path)
    fc = {f"{n}.weight" for n, m in net.named_modules()
          if isinstance(m, pt.nn.Linear)}
    for name, p in net.named_parameters():
        want = p.detach().cpu()
        want = (want.t() if name in fc else want).contiguous().numpy()
        dims, _, raw = inits[name]
        if dims != want.shape or raw != want.tobytes():
            raise AssertionError(f"phase 14 (v): initializer {name} is not "
                                 f"the card's parameter bit for bit")
    cpu_nodes, cpu_inits = onnx_graph(onnx.export(
        host, os.path.join(tmp, "resnet50_cpu"), input_spec=spec))
    if cpu_nodes != nodes or cpu_inits != inits:
        raise AssertionError("phase 14 (v): the export on the card differs "
                             "from the CPU's of the same weights")
    size = os.path.getsize(path)
    convs = sum(1 for n in nodes if n[0] == "Conv")
    log(f"phase 14 (v): onnx.export of ResNet-50 ({RN_CLASSES} classes, "
        f"[None, 3, {RN_HW}, {RN_HW}]) on the card: {len(nodes)} nodes "
        f"({convs} Conv), {len(inits)} initializers, {size} bytes in "
        f"{secs:.2f} s; every parameter's initializer bit-equal to the "
        f"card's (the fc weight [in, out]); nodes and initializers equal "
        f"to the CPU export of the same weights")
    del net, host
    return size, secs


def phase_legacy(device, card, timer, profile=False):
    """14: the legacy static surface on the card. BERT-base at phase 10's
    configuration fine-tuned through a 1.x fluid program
    (:func:`legacy_program`): the first ``Executor.run`` fetches the loss
    and ``static.gradients``' variable (both held to an eager step of the
    same weights within bf16 TOL), then ``LEGACY_WARM`` + ``LEGACY_STEPS``
    more, each followed by the EMA's ``update()`` (the head weight's
    shadow held bit-equal to the recursion in plain torch); every step's
    launches
    held to the structure (K2 = K3 = 25 + 1 for the head's LayerNorm, K4
    = K6 = 12, K8 the plan over the stepped list), every flash launch
    tensor-core, every LayerNorm launch warp-row, no plain version, the
    embedding tables bit-equal after. The EMA's ``apply()`` and
    ``restore()``; ``static.save``/``static.load`` and the ``serialize_
    persistables`` pair into a freshly built program (its logits bit-
    equal); ``fluid.io.save_inference_model``/``load_inference_model``
    served on the card (K2 26, K4 12 a forward); ResNet-50 to ONNX
    (:func:`legacy_onnx`). K2 and K3 are held against their plain
    versions at every shape a train step or a served forward ran them at
    (:func:`ln_shape_checks`). Returns the launches of the train steps
    and of the served forwards, the kernels line's
    ``fused_adamw_step_bert_static`` row (K8 at the stepped list's
    shapes, the phase's K8 launches) and the LayerNorm checks' errors by
    shape."""
    import shutil
    import tempfile
    import paddle_tpu_torch.optimizer.optimizer as opt_module
    from paddle_tpu_torch import fluid, static
    t_phase = time.perf_counter()
    counters = train_counters()
    net = legacy_program(device, SEED)
    main, opt = net["main"], net["opt"]
    feed = legacy_feed(net["bert"].cfg.vocab_size)
    n_ln = 1 + sum(1 for m in net["bert"].modules()
                   if type(m).__name__ == "LayerNorm")
    layers = len(net["bert"].encoder.layers)
    stepped = [p for _, p in main._opt_chosen]
    frozen = {id(p) for p in net["tables"]}
    if len(stepped) + 3 != len(main._params) or any(
            id(p) in frozen for p in stepped):
        raise AssertionError(f"phase 14: {len(stepped)} stepped of "
                             f"{len(main._params)} parameters")
    numels = [p.numel() for p in stepped]
    want = {"flash_attention_fwd": layers, "flash_attention_bwd": layers,
            "fused_layer_norm": n_ln, "fused_layer_norm_bwd": n_ln,
            "fused_adamw": adamw_launches(numels),
            "fused_adamw_tensors": len(numels)}
    eager_loss, eager_grad = legacy_eager(net, feed, device)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(net["startup"])
    tables = [t.detach().clone() for t in net["tables"]]
    torch.cuda.synchronize()
    reset_counts(counters)
    per_step, losses, host_ms, step_ms = [], [], [], []
    # the EMA's recursion is recomputed in plain torch from the head's
    # first weight as each update() saw it
    ema_p, ema_in = net["head"][0], []

    def ema_update():
        ema_in.append(ema_p.detach().clone())
        net["ema"].update()

    with count_plain() as plain, adamw_dtypes(opt_module) as kinds:
        at = read_counts(counters)
        with ln_launch_shapes() as (ln_fwd, ln_bwd):
            first, grad = exe.run(main, feed=feed,
                                  fetch_list=[net["loss"], net["grad"]])
        now = read_counts(counters)
        per_step.append({k: now[k] - at[k] for k in now})
        ema_update()
        for i in range(LEGACY_WARM + LEGACY_STEPS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            at = read_counts(counters)
            a.record()
            t0 = time.perf_counter()
            (loss,) = exe.run(main, feed=feed, fetch_list=[net["loss"]],
                              return_numpy=False)
            t1 = time.perf_counter()
            b.record()
            torch.cuda.synchronize()
            now = read_counts(counters)
            per_step.append({k: now[k] - at[k] for k in now})
            losses.append(loss.item())
            if i >= LEGACY_WARM:
                host_ms.append((t1 - t0) * 1e3)
                step_ms.append(a.elapsed_time(b))
            ema_update()
    launches = read_counts(counters)
    if per_step != [want] * (1 + LEGACY_WARM + LEGACY_STEPS):
        bad = [(i, st) for i, st in enumerate(per_step) if st != want]
        raise AssertionError(f"phase 14: launches a step, expected {want}: "
                             f"{bad[:3]}")
    # every step runs the same program on the same feed, with the same
    # launches: the first step's LayerNorm shapes are every step's
    if (sum(ln_fwd.values()), sum(ln_bwd.values())) != (
            want["fused_layer_norm"], want["fused_layer_norm_bwd"]):
        raise AssertionError(f"phase 14: LayerNorm calls by shape "
                             f"{dict(ln_fwd)} / {dict(ln_bwd)}, launches "
                             f"{per_step[0]}")
    check_flash_route("phase 14", counters, "tc")
    check_ln_route("phase 14", (counters["fused_layer_norm"],
                                counters["fused_layer_norm_bwd"]))
    if sum(plain.values()) or set(kinds) != {
            ("float32", "bfloat16", "bfloat16")}:
        raise AssertionError(f"phase 14: plain versions {dict(plain)}, "
                             f"AdamW (p, g, copy) dtypes {dict(kinds)}")
    if not all(torch.equal(a, b) for a, b in zip(tables, net["tables"])):
        raise AssertionError("phase 14: a frozen embedding table changed")
    loss_err = check_close("phase 14 first loss vs the eager step",
                           torch.tensor(float(first)), eager_loss,
                           torch.bfloat16)
    grad_err = check_scaled("phase 14 static.gradients vs the eager .grad",
                            torch.from_numpy(grad), eager_grad.float().cpu(),
                            torch.bfloat16)
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < float(first):
        raise AssertionError(f"phase 14 losses: {float(first)}, {losses}")
    if profile:
        with device_profile() as prof:
            t0 = time.perf_counter()
            for _ in range(2):
                exe.run(main, feed=feed, fetch_list=[net["loss"]],
                        return_numpy=False)
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3
        device_time_report("legacy", prof, prof_ms, 2)
    log(f"phase 14: BERT-base (bench_bert's BertConfig, bf16 AMP O2, "
        f"AdamW lr {BERT_LR} weight_decay {BERT_WD} with float32 masters) "
        f"under a 1.x head (fc 768 gelu, layer_norm, fc 2) built with "
        f"fluid.program_guard, fluid.layers.data [-1, {BERT_SEQ}], "
        f"minimize(no_grad_set=<3 embedding tables>): {len(numels)} of "
        f"{len(main._params)} tensors stepped, batch {BERT_BATCH} x "
        f"{BERT_SEQ}; 1 + {LEGACY_WARM} + {LEGACY_STEPS} "
        f"fluid.Executor(CUDAPlace(0)).run steps, launches a step "
        f"{json.dumps(want)}, every flash launch tensor-core, every "
        f"LayerNorm launch warp-row, no plain version, the embedding "
        f"tables bit-equal after; first loss {float(first):.6f} vs the "
        f"eager step's {eager_loss.item():.6f} (err {loss_err:.3e}), "
        f"static.gradients of the head's fc weight vs the eager .grad "
        f"(rel err {grad_err:.3e}); losses {json.dumps(losses)}")
    log(f"phase 14 on {card}: step {statistics.median(step_ms):.3f} ms "
        f"median (CUDA events around each Executor.run, {LEGACY_STEPS} "
        f"timed; min {min(step_ms):.3f}, max {max(step_ms):.3f}); "
        f"Executor.run host {statistics.median(host_ms):.3f} ms median, "
        f"host share {statistics.median(host_ms) / statistics.median(step_ms):.4f}")
    test = main.clone(for_test=True)
    eval_feed = {k: feed[k] for k in ("input_ids", "token_type_ids")}

    def logits_of(prog, out):
        (got,) = exe.run(prog, feed=eval_feed, fetch_list=[out],
                         return_numpy=False)
        return got

    ema_name = next(n for n, p in main._params.items() if p is ema_p)
    shadow = ema_in[0].clone()
    keep, take = (torch.tensor(v, dtype=shadow.dtype).item()
                  for v in (LEGACY_EMA, 1 - LEGACY_EMA))
    for q in ema_in[1:]:
        shadow = shadow * keep + q * take
    got = net["ema"]._shadow[ema_name]
    if not torch.equal(got, shadow) or torch.equal(got, ema_in[0]):
        raise AssertionError(
            f"phase 14 (ii): the EMA shadow of {ema_name} after "
            f"{len(ema_in)} updates is not the recursion recomputed in "
            f"plain {shadow.dtype} (max |diff| "
            f"{(got.float() - shadow.float()).abs().max().item():.4e}), or "
            f"it never left the first snapshot")
    raw = logits_of(test, net["logits"])
    before = {n: p.detach().clone() for n, p in main._params.items()}
    with net["ema"].apply():
        ema_logits = logits_of(test, net["logits"])
    if torch.equal(ema_logits, raw) or not all(
            torch.equal(before[n], p) for n, p in main._params.items()):
        raise AssertionError("phase 14 (ii): EMA apply() gave the raw "
                             "logits, or restore() did not give back the "
                             "parameters bit for bit")
    del before
    log(f"phase 14 (ii): ExponentialMovingAverage({LEGACY_EMA}) updated "
        f"after each step: the shadow of {ema_name} after {len(ema_in)} "
        f"updates bit-equal to the recursion recomputed in plain "
        f"{shadow.dtype} (it moved {(shadow.float() - ema_in[0].float()).abs().max().item():.4e} "
        f"from the first snapshot); under apply() the test program's "
        f"logits differ "
        f"from the raw weights' (max |diff| "
        f"{(ema_logits.float() - raw.float()).abs().max().item():.4e}); "
        f"after restore() every parameter bit-equal to before")
    del ema_in
    tmp = tempfile.mkdtemp(prefix="chip_smoke_legacy_")
    try:
        prefix = os.path.join(tmp, "bert_legacy")
        t0 = time.perf_counter()
        static.save(main, prefix)
        save_s = time.perf_counter() - t0
        fresh = legacy_program(device, SEED + 1, train=False)
        ftest = fresh["main"].clone(for_test=True)
        t0 = time.perf_counter()
        static.load(fresh["main"], prefix)
        load_s = time.perf_counter() - t0
        if not torch.equal(logits_of(ftest, fresh["logits"]), raw):
            raise AssertionError("phase 14 (iii): static.load into a fresh "
                                 "program: logits not bit-equal")
        blob = static.serialize_persistables(
            [net["ids"], net["types"]], [net["logits"]], main)
        with torch.no_grad():
            for p in fresh["main"]._params.values():
                p.zero_()
        static.deserialize_persistables(fresh["main"], blob)
        if not torch.equal(logits_of(ftest, fresh["logits"]), raw):
            raise AssertionError("phase 14 (iii): deserialize_persistables: "
                                 "logits not bit-equal")
        log(f"phase 14 (iii): static.save {os.path.getsize(prefix + '.pdparams')}"
            f" bytes .pdparams + {os.path.getsize(prefix + '.pdopt')} bytes "
            f".pdopt in {save_s:.2f} s; static.load into a freshly built "
            f"program ({len(fresh['main']._params)} parameters, other "
            f"seed) in {load_s:.2f} s: eval logits bit-equal; "
            f"serialize_persistables ({len(blob)} bytes) into its zeroed "
            f"parameters: bit-equal again")
        del fresh, ftest, blob
        served, serve_fwd = legacy_serve(exe, test, net, eval_feed, raw,
                                         counters, tmp)
        legacy_onnx(device, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    shapes = [tuple(p.shape) for p in stepped]
    del net, main, opt, test, stepped, raw, ema_logits
    gc.collect()
    torch.cuda.empty_cache()
    ln_errs = ln_shape_checks(timer, "phase 14", ln_fwd + serve_fwd,
                              ln_bwd)
    row = adamw_step_case(timer, device, shapes, torch.bfloat16, BERT_LR,
                          BERT_WD)
    log(f"phase 14 fused_adamw_step_bert_static {fmt(row)}")
    k8 = {"name": "fused_adamw_step_bert_static", "route": "cuda",
          "source": ADAMW_SRC, "replaces": ADAMW_TPU,
          "launches": launches["fused_adamw"],
          **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms")},
          **{k: row[k] for k in STEP_KEYS}, "launches_note": STEP_NOTE}
    log(f"phase 14: {time.perf_counter() - t_phase:.1f} s")
    return launches, served, k8, ln_errs


def legacy_serve(exe, test, net, eval_feed, raw, counters, tmp):
    """14 (iv): ``fluid.io.save_inference_model`` of the test program
    (feeds by name), ``fluid.io.load_inference_model`` on the executor's
    place; each served forward launches K2 = 26 (warp-row) and K4 = 12
    (tensor-core) and nothing else of the kernels, its logits within bf16
    TOL of the test program's. Returns the served forwards' K2 and K4
    launches, and the LayerNorm shapes of one forward (every forward
    serves the same batch)."""
    from paddle_tpu_torch import fluid
    d = os.path.join(tmp, "served")
    t0 = time.perf_counter()
    fluid.io.save_inference_model(d, ["input_ids", "token_type_ids"],
                                  [net["logits"]], exe, main_program=test)
    save_s = time.perf_counter() - t0
    pred, names, _ = fluid.io.load_inference_model(d, exe)
    ids, types = eval_feed["input_ids"], eval_feed["token_type_ids"]
    n_ln = 1 + sum(1 for m in net["bert"].modules()
                   if type(m).__name__ == "LayerNorm")
    layers = len(net["bert"].encoder.layers)
    per_run = {"fused_layer_norm": n_ln, "warp": n_ln,
               "flash_attention_fwd": layers, "tc": layers, "others": 0}
    runs = []

    def served():
        at = deploy_counts(counters)
        out = pred(ids, types)
        now = deploy_counts(counters)
        runs.append({k: now[k] - at[k] for k in now})
        return out

    reset_counts(counters)
    with count_plain() as plain:
        with ln_launch_shapes() as (shapes, _):
            got = served()
        ms = event_ms(served, LEGACY_SERVE_RUNS)
    launches = read_counts(counters)
    if sum(plain.values()) or runs != [per_run] * (LEGACY_SERVE_RUNS + 1) \
            or sum(shapes.values()) != n_ln:
        raise AssertionError(f"phase 14 (iv): launches a served forward "
                             f"{runs[:3]}, expected {per_run}; plain "
                             f"{dict(plain)}; LayerNorm calls by shape "
                             f"{dict(shapes)}")
    err = check_close("phase 14 (iv) served logits", got.float().cpu(),
                      raw.float().cpu(), torch.bfloat16)
    log(f"phase 14 (iv): fluid.io.save_inference_model(feeds {names}) of "
        f"the test program in {save_s:.2f} s "
        f"({artifact_bytes(os.path.join(d, 'model'))} bytes); "
        f"load_inference_model on CUDAPlace(0); each forward at "
        f"[{BERT_BATCH}, {BERT_SEQ}] launched K2 = {n_ln} (warp-row) and "
        f"K4 = {layers} (tensor-core), no plain version; logits within "
        f"bf16 TOL of the test program's (max abs err {err:.3e}); "
        f"served forward {ms:.3f} ms (median of {LEGACY_SERVE_RUNS}, "
        f"CUDA events, numpy in)")
    return {"fused_layer_norm": launches["fused_layer_norm"],
            "flash_attention_fwd": launches["flash_attention_fwd"]}, shapes


# ---------------------------------------------------------------- phase 15
#: ``bench.py``'s ``bench_gpt2_decode``: GPT-2 small, bf16 weights, 8
#: prompts of 128 tokens, 128 new, greedy, no EOS; not cut
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 8, 128, 128
#: the beam and keyed artifacts: 4 beams, and sampling at temperature 0.8,
#: 32 new tokens each
SERVE_BEAMS, SERVE_SHORT, SERVE_TEMP = 4, 32, 0.8
SERVE_RUNS = 3
SERVE_LN_ROW = "fused_layer_norm_serving"


def served_graph_nodes(layer):
    """The node counts of a loaded artifact's graphs: the top graph and
    each ``while_loop`` body and condition."""
    return {name or "top": len(m.graph.nodes)
            for name, m in layer._exported.graph_module.named_modules()
            if isinstance(m, torch.fx.GraphModule)}


@contextlib.contextmanager
def ln_route_shapes():
    """The dtype and [rows, D] of every LayerNorm launch while the block
    runs, read where a launch picks its route (``ops.layer_norm.
    ln_route``, called once a forward or backward launch): an exported
    program's ``while_loop`` body reaches its custom op there too, where
    neither a module hook nor a dispatch mode sees it."""
    from paddle_tpu_torch.ops import layer_norm as ln
    seen = collections.Counter()
    orig = ln.ln_route

    def spy(x, *operands):
        seen[(x.dtype, x.numel() // x.shape[-1], x.shape[-1])] += 1
        return orig(x, *operands)

    ln.ln_route = spy
    try:
        yield seen
    finally:
        ln.ln_route = orig


def serve_call(what, fn, want, counters, shapes):
    """``fn()`` with the counts set to 0 just before and read just after:
    K2 and K4 must equal ``want``, every K2 launch warp-row, every K4
    launch tensor-core, no plain version; the K2 shapes are added to
    ``shapes``. Returns (tokens, wall s)."""
    reset_counts(counters)
    torch.cuda.synchronize()
    with count_plain() as plain, ln_route_shapes() as fwd:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    got = {k: counters[k].launches for k in want}
    if got != want or sum(plain.values()):
        raise AssertionError(f"phase 15 {what}: launches {got}, expected "
                             f"{want}; plain versions {dict(plain)}")
    check_ln_route(f"phase 15 {what}", (counters["fused_layer_norm"],))
    fa = counters["flash_attention_fwd"]
    if fa.tc_launches != fa.launches:
        raise AssertionError(f"phase 15 {what}: {fa.launches} flash "
                             f"launches, {fa.tc_launches} tensor-core")
    shapes.update(fwd)
    return out, wall


def phase_serving(device, card):
    """15: the exported generate artifact. GPT-2 small (bf16, full width
    and depth, random weights from a seed) at ``bench_gpt2_decode``'s
    configuration: ``save_for_serving`` on the card (export seconds,
    artifact bytes, the graphs' node counts), then ``jit.load`` and
    ``inference.create_predictor`` serve it with no model code: their
    tokens equal eager ``generate()``'s on the card, each call launching
    K2 (2L + 1) x 128 = 3200 times (warp-row) and K4 L = 12 times (the
    prefill, tensor-core), no plain version; served and eager ms per
    token in the same run. A beam artifact (4 beams, 32 new) equals eager
    beam search (K2 (2L + 1) x 32, K4 12); a ``runtime_key`` artifact
    (sampled at temperature 0.8, 32 new) gives equal tokens for equal
    keys and different tokens for two keys. Returns the launches of the
    served calls and the K2 shapes recorded."""
    import tempfile
    from paddle_tpu_torch import inference, jit
    from paddle_tpu_torch.models import save_for_serving
    model, cfg = gpt2_small(SEED + 150, device)
    model = model.to(torch.bfloat16).eval()
    n_layers = cfg.num_hidden_layers
    counters = gen_counters()
    ids = torch.from_numpy(np.random.RandomState(SEED + 151).randint(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT))).to(device)
    greedy = {"fused_layer_norm": (2 * n_layers + 1) * SERVE_NEW,
              "flash_attention_fwd": n_layers}
    shapes = collections.Counter()
    totals = collections.Counter()

    def counted(what, fn, want):
        out, wall = serve_call(what, fn, want, counters, shapes)
        totals.update(want)
        return out, wall

    eager, _ = counted("eager generate", lambda: model.generate(
        ids, max_new_tokens=SERVE_NEW), greedy)
    eager_walls = [counted("eager generate", lambda: model.generate(
        ids, max_new_tokens=SERVE_NEW), greedy)[1]
        for _ in range(SERVE_RUNS)]
    tmp = tempfile.mkdtemp(dir=TRACE_ROOT)
    path = os.path.join(tmp, "gpt2_greedy")
    t0 = time.perf_counter()
    save_for_serving(model, path, batch=SERVE_BATCH,
                     prompt_len=SERVE_PROMPT, max_new_tokens=SERVE_NEW)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = jit.load(path)
    load_s = time.perf_counter() - t0
    pred = inference.create_predictor(inference.Config(path + ".pdmodel"))
    nodes = served_graph_nodes(loaded)
    host_ids = ids.to(torch.int32).cpu().numpy()
    served, _ = counted("jit.load", lambda: loaded(host_ids), greedy)
    served_walls = [counted("jit.load", lambda: loaded(host_ids),
                            greedy)[1] for _ in range(SERVE_RUNS)]
    predicted, _ = counted("Predictor.run",
                           lambda: pred.run([host_ids])[0], greedy)
    want = eager.cpu()
    if not (served.device.type == device.type
            and torch.equal(served.cpu(), want)
            and np.array_equal(predicted, want.numpy())):
        diff = (served.cpu() != want).nonzero()[:5].tolist()
        raise AssertionError(f"phase 15: served tokens on {served.device} "
                             f"differ from eager generate's at {diff} (the "
                             f"Predictor's equal: "
                             f"{np.array_equal(predicted, want.numpy())})")

    beam_want = {"fused_layer_norm": (2 * n_layers + 1) * SERVE_SHORT,
                 "flash_attention_fwd": n_layers}
    eager_beam, _ = counted("eager beams", lambda: model.generate(
        ids, max_new_tokens=SERVE_SHORT, num_beams=SERVE_BEAMS), beam_want)
    bpath = os.path.join(tmp, "gpt2_beams")
    t0 = time.perf_counter()
    save_for_serving(model, bpath, batch=SERVE_BATCH,
                     prompt_len=SERVE_PROMPT, max_new_tokens=SERVE_SHORT,
                     num_beams=SERVE_BEAMS)
    beam_export_s = time.perf_counter() - t0
    beam_layer = jit.load(bpath)
    beams, _ = counted("beam artifact", lambda: beam_layer(host_ids),
                       beam_want)
    if not torch.equal(beams.cpu(), eager_beam.cpu()):
        raise AssertionError("phase 15: the beam artifact's tokens differ "
                             "from eager beam search's")

    kpath = os.path.join(tmp, "gpt2_keyed")
    t0 = time.perf_counter()
    save_for_serving(model, kpath, batch=SERVE_BATCH,
                     prompt_len=SERVE_PROMPT, max_new_tokens=SERVE_SHORT,
                     do_sample=True, temperature=SERVE_TEMP,
                     runtime_key=True)
    key_export_s = time.perf_counter() - t0
    keyed = inference.create_predictor(inference.Config(kpath + ".pdmodel"))
    key_want = {"fused_layer_norm": (2 * n_layers + 1) * SERVE_SHORT,
                "flash_attention_fwd": n_layers}
    k1, k2 = (np.array(k, np.uint32) for k in ([SEED, 1], [SEED, 2]))
    a, _ = counted("keyed artifact", lambda: keyed.run([host_ids, k1])[0],
                   key_want)
    b, _ = counted("keyed artifact", lambda: keyed.run([host_ids, k1])[0],
                   key_want)
    c, _ = counted("keyed artifact", lambda: keyed.run([host_ids, k2])[0],
                   key_want)
    if not (np.array_equal(a, b) and not np.array_equal(a, c)
            and np.array_equal(a[:, :SERVE_PROMPT], host_ids)
            and a.max() < cfg.vocab_size and a.min() >= 0):
        raise AssertionError("phase 15: the keyed artifact: equal keys "
                             f"{np.array_equal(a, b)}, two keys differ "
                             f"{not np.array_equal(a, c)}")
    served_ms = statistics.median(served_walls) * 1e3 / SERVE_NEW
    eager_ms = statistics.median(eager_walls) * 1e3 / SERVE_NEW
    log(f"phase 15: GPT-2 small (bench_gpt2_decode: bf16, {SERVE_BATCH} x "
        f"{SERVE_PROMPT} prompts, {SERVE_NEW} new, greedy) exported by "
        f"save_for_serving in {export_s:.3f} s (beams {beam_export_s:.3f} "
        f"s, keyed {key_export_s:.3f} s), {artifact_bytes(path)} bytes, "
        f"graph nodes {json.dumps(nodes)}; loaded by jit.load in "
        f"{load_s:.3f} s; tokens of jit.load and Predictor.run equal eager "
        f"generate's; every served call K2 {greedy['fused_layer_norm']} "
        f"(warp-row) and K4 {n_layers} (tensor-core), no plain version")
    log(f"phase 15 timing on {card}: served {served_ms:.4f} ms per token "
        f"step (median of {SERVE_RUNS} calls, {SERVE_BATCH} rows; walls "
        f"{json.dumps([round(w * 1e3, 3) for w in served_walls])} ms), "
        f"eager generate {eager_ms:.4f} ms per token step (walls "
        f"{json.dumps([round(w * 1e3, 3) for w in eager_walls])} ms); "
        f"beam artifact = eager beams ({SERVE_BEAMS} beams, {SERVE_SHORT} "
        f"new), keyed artifact: equal keys equal tokens, two keys differ")
    del model, loaded, pred, beam_layer, keyed
    gc.collect()
    torch.cuda.empty_cache()
    return dict(totals), shapes


def serving_rows(timer, launches, shapes):
    """The kernels line's rows of phase 15: K2 at every dtype and [rows,
    D] the calls ran it at (the main shape, a decode step's bf16 [8,
    768]), and K4 at the served prefill's shape, bf16 [8, 128, 12, 64]
    causal, on the tensor-core route."""
    bf16 = torch.bfloat16
    LN_SHAPES[SERVE_LN_ROW].update(shapes)
    ln = ln_shape_row(timer, SERVE_LN_ROW, launches["fused_layer_norm"],
                      (bf16, SERVE_BATCH, 768))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 152)
    q, k, v, do = (torch.randn(SERVE_BATCH, SERVE_PROMPT, 12, 64,
                               device="cuda", generator=gen).to(bf16)
                   for _ in range(4))
    fwd, _ = flash_case(timer, q, k, v, do, route="tc")
    log(f"K4/K5 flash_attention_fwd at the served prefill's shape, bf16 "
        f"[{SERVE_BATCH}, {SERVE_PROMPT}, 12, 64] causal, tc route "
        f"{fmt(fwd)}")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    return [{"name": SERVE_LN_ROW, "route": "cuda", "source": LN_SRC,
             "replaces": LN_TPU, "launches": launches["fused_layer_norm"],
             **{k: ln[k] for k in keys}},
            {"name": "flash_attention_fwd_serving", "route": "cuda",
             "source": FA_TC_SRC, "replaces": FA_FWD_TPU,
             "launches": launches["flash_attention_fwd"],
             **{k: fwd[k] for k in keys}}]


# ---------------------------------------------------------------- phase 16
#: (i) MobileNetV2 (Sandler et al. 2018: scale 1.0, 1000 classes, 224 x
#: 224) under ``bench_resnet50``'s recipe (NHWC, bf16 O2, Momentum 0.9
#: with float32 masters, batch 128); images: 256 x 256 uint8 ``.npy``
#: files in 8 class folders, ``VISION_STEPS`` batches of them
VISION_CLASSES_DIRS, VISION_SIDE, VISION_STEPS = 8, 256, 10
VISION_WORKERS = 2
IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)
#: (ii) each other family at its reference input: a timed bf16 batch and
#: a float32 batch held against the CPU within ``ZOO_TOL`` of the
#: logits' largest magnitude (cuDNN's and the CPU's float32 sums in
#: another order)
ZOO = (("vgg16", 224), ("alexnet", 224), ("squeezenet1_1", 224),
       ("mobilenet_v1", 224), ("mobilenet_v3_large", 224),
       ("shufflenet_v2_x1_0", 224), ("densenet121", 224),
       ("googlenet", 224), ("inception_v3", 299))
ZOO_BATCH, ZOO_CHECK_BATCH, ZOO_RUNS, ZOO_TOL = 32, 4, 5, 1e-3
#: (iii) the detection ops: YOLOv3 on COCO (608 x 608, 80 classes, grids
#: 19/38/76 with the paper's nine anchors, batch 8, 50 boxes an image),
#: Faster R-CNN's C4 features ([2, 1024, 50, 76] at 1/16, 512 regions an
#: image), R-FCN's 7 x 7 x 21 position-sensitive maps, a 3 x 3 256 -> 256
#: deformable convolution v2; the CPU holds the region ops on the first
#: ``DET_CHECK_ROIS`` regions of each image
YOLO_ANCHORS = (10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90,
                156, 198, 373, 326)
YOLO_HEADS = ((19, 32, (6, 7, 8)), (38, 16, (3, 4, 5)), (76, 8, (0, 1, 2)))
YOLO_BATCH, YOLO_CLASSES, YOLO_GT, YOLO_NMS_TOP, YOLO_IOU = 8, 80, 50, \
    1000, 0.45
DET_ROIS, DET_CHECK_ROIS, DET_TOL = 512, 16, 1e-4


def rel_err(got, want):
    """max |got - want| over the largest |want|."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp(
        min=1e-30))


def write_image_folders(root, n_images, seed):
    """``n_images`` random 256 x 256 x 3 uint8 ``.npy`` images spread over
    the class folders under ``root``."""
    rs = np.random.RandomState(seed)
    for i in range(n_images):
        d = os.path.join(root, f"class_{i % VISION_CLASSES_DIRS}")
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, f"{i:05d}.npy"), rs.randint(
            0, 256, (VISION_SIDE, VISION_SIDE, 3)).astype(np.uint8))


def vision_train(device, card, tmp):
    """16 (i): MobileNetV2 trained through ``Model.fit`` from a
    ``DatasetFolder`` of ``.npy`` images through the ImageNet training
    transforms in ``VISION_WORKERS`` loader workers with prefetch. Every
    loss finite; no kernel of the port launched (none is on this path,
    as in the JAX package) and no plain version. Returns the record."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import amp, nn
    from paddle_tpu_torch.framework import monitor
    from paddle_tpu_torch.hapi import Callback, Model
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision import datasets, transforms as T
    from paddle_tpu_torch.vision.models import mobilenet_v2
    root = os.path.join(tmp, "images")
    t0 = time.perf_counter()
    write_image_folders(root, RN_BATCH * VISION_STEPS, SEED + 160)
    write_s = time.perf_counter() - t0
    tf = T.Compose([T.RandomResizedCrop(224), T.RandomHorizontalFlip(),
                    T.Transpose((1, 2, 0)),
                    T.Normalize(IMAGENET_MEAN, IMAGENET_STD,
                                data_format="HWC")])
    ds = datasets.DatasetFolder(root, loader=np.load, extensions=(".npy",),
                                transform=tf)
    if len(ds.classes) != VISION_CLASSES_DIRS or \
            len(ds) != RN_BATCH * VISION_STEPS:
        raise AssertionError(f"phase 16: {len(ds)} images in "
                             f"{ds.classes}")
    loader = pt.io.DataLoader(ds, batch_size=RN_BATCH, shuffle=True,
                              drop_last=True, num_workers=VISION_WORKERS)
    pt.seed(SEED + 161)
    net = mobilenet_v2(num_classes=RN_CLASSES, scale=1.0,
                       data_format="NHWC")
    n_params = sum(p.numel() for p in net.parameters())
    amp.decorate(net, level="O2", dtype="bfloat16")
    model = Model(net, inputs=["image"], labels=["label"], device=device)
    model.prepare(Momentum(learning_rate=RN_LR, momentum=RN_MOMENTUM,
                           parameters=net.parameters(),
                           multi_precision=True),
                  loss=nn.CrossEntropyLoss(), metrics=[Accuracy()],
                  amp_configs={"level": "O2", "dtype": "bfloat16"})
    losses, stamps, shapes = [], [], []

    class Steps(Callback):
        def on_train_batch_end(self, step, logs=None):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            stamps.append(ev)
            losses.append(logs["loss"])

    def spy(inputs, labels, update=True, _orig=model._train_step):
        shapes.append((tuple(inputs[0].shape), inputs[0].device.type))
        return _orig(inputs, labels, update)

    model._train_step = spy
    counters = kernel_counters()
    waits0 = len(monitor.histogram_samples("prefetch_wait_ms"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts(counters)
    with count_plain() as plain:
        t0 = time.perf_counter()
        model.fit(loader, epochs=1, log_freq=1, verbose=0, prefetch=True,
                  callbacks=[Steps()])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    del model._train_step
    counts = kernel_counts(counters)
    peak = torch.cuda.max_memory_allocated()
    waits = monitor.histogram_samples("prefetch_wait_ms")[waits0:]
    if any(counts.values()) or sum(plain.values()):
        raise AssertionError(f"phase 16: the fit launched kernels {counts} "
                             f"or plain versions {dict(plain)}")
    if len(losses) != VISION_STEPS or not all(
            math.isfinite(x) for x in losses) or any(
            s != ((RN_BATCH, 224, 224, 3), device.type) for s in shapes):
        raise AssertionError(f"phase 16: {len(losses)} steps, losses "
                             f"{losses}, batches {shapes[:2]}")
    step_ms = [stamps[i - 1].elapsed_time(stamps[i])
               for i in range(1, len(stamps))]
    timed_ms = stamps[0].elapsed_time(stamps[-1])
    rec = {"ms_step": timed_ms / (len(stamps) - 1),
           "median_ms": float(np.median(step_ms)),
           "images_s": RN_BATCH * (len(stamps) - 1) / timed_ms * 1e3,
           "wait_p50": float(np.median(waits)) if waits else None,
           "wait_max": float(max(waits)) if waits else None}
    log(f"phase 16 (i): MobileNetV2 (scale 1.0, {RN_CLASSES} classes, "
        f"{n_params} parameters, NHWC), bf16 AMP O2, Momentum lr {RN_LR} "
        f"momentum {RN_MOMENTUM} with float32 masters, batch {RN_BATCH} x "
        f"224 x 224 x 3 through Model.fit from vision.datasets."
        f"DatasetFolder({RN_BATCH * VISION_STEPS} .npy images of "
        f"{VISION_SIDE}^2 in {VISION_CLASSES_DIRS} folders, written in "
        f"{write_s:.2f} s) with RandomResizedCrop(224), "
        f"RandomHorizontalFlip, Transpose, Normalize(ImageNet, HWC) in "
        f"{VISION_WORKERS} loader workers with prefetch; K1-K8 launches "
        f"{json.dumps(counts)} (none on this path), no plain version")
    log(f"phase 16 (i) on {card}: {len(losses)} steps in {wall:.3f} s "
        f"(the first with the workers' start); steps 2-{len(losses)}: "
        f"{rec['ms_step']:.3f} ms a step (CUDA events between step ends),"
        f" median {rec['median_ms']:.3f}, {rec['images_s']:.1f} images/s;"
        f" the loader's wait (prefetch_wait_ms) p50 {rec['wait_p50']} ms, "
        f"max {rec['wait_max']} ms over {len(waits)} batches; max memory "
        f"allocated {peak} bytes; losses {json.dumps(losses)}")
    del model, net, loader
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def vision_zoo(device, card):
    """16 (ii): each other family at its reference input, eval mode: a
    bf16 (AMP O2) batch of ``ZOO_BATCH`` timed on the card, and a float32
    batch of ``ZOO_CHECK_BATCH`` on the card held against the same
    weights' float32 forward on the CPU within ``ZOO_TOL``; GoogLeNet's
    two auxiliary heads too, in training mode with its dropout off."""
    import copy
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn.layer.common import Dropout
    from paddle_tpu_torch.vision import models
    out = {}
    for i, (name, side) in enumerate(ZOO):
        pt.seed(SEED + 170 + i)
        cpu_net = getattr(models, name)(num_classes=RN_CLASSES)
        aux = name == "googlenet"
        if aux:
            for m in cpu_net.modules():
                if isinstance(m, Dropout):
                    m.p = 0.0
        cpu_net.train() if aux else cpu_net.eval()
        card_net = copy.deepcopy(cpu_net).to(device)
        x = torch.from_numpy(np.random.RandomState(SEED + 171 + i).randn(
            ZOO_CHECK_BATCH, 3, side, side).astype(np.float32))
        with torch.no_grad():
            want = cpu_net(x)
            got = card_net(x.to(device))
        want = list(want) if aux else [want]
        got = list(got) if aux else [got]
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        if len(got) != (3 if aux else 1) or max(errs) > ZOO_TOL:
            raise AssertionError(f"phase 16 {name}: card vs CPU "
                                 f"{errs} > {ZOO_TOL}")
        card_net.eval()
        amp.decorate(card_net, level="O2", dtype="bfloat16")
        xb = torch.randn(ZOO_BATCH, 3, side, side, device=device)

        def fwd():
            with torch.no_grad(), amp.auto_cast(level="O2",
                                                dtype="bfloat16"):
                return card_net(xb)

        logits = fwd()
        if tuple(logits.shape) != (ZOO_BATCH, RN_CLASSES) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"phase 16 {name}: bf16 logits "
                                 f"{tuple(logits.shape)}")
        ms = event_ms(fwd, ZOO_RUNS)
        out[name] = {"ms": ms, "err": max(errs)}
        log(f"phase 16 (ii) {name} at {side}^2 on {card}: bf16 batch "
            f"{ZOO_BATCH} forward {ms:.3f} ms (median of {ZOO_RUNS}), "
            f"{ZOO_BATCH / ms * 1e3:.1f} images/s; float32 batch "
            f"{ZOO_CHECK_BATCH} card vs CPU {json.dumps(errs)} of the "
            f"largest |logit|" + (" (main, aux1, aux2)" if aux else ""))
        del cpu_net, card_net
        gc.collect()
        torch.cuda.empty_cache()
    return out


def det_rois(rs, n, h, w):
    """``n`` xyxy regions inside an ``h`` x ``w`` image."""
    x1 = rs.uniform(0, w - 32, n)
    y1 = rs.uniform(0, h - 32, n)
    return np.stack([x1, y1, x1 + rs.uniform(16, w / 3, n),
                     y1 + rs.uniform(16, h / 3, n)], 1).astype(np.float32)


def vision_ops_phase(device, card):
    """16 (iii): the seven detection ops at detection shapes on the card,
    each timed and held against the same call on the CPU (float32
    within ``DET_TOL`` of each output's largest magnitude, NMS indices
    exactly): ``yolo_box`` over the three YOLOv3-COCO heads, then
    categorical ``nms`` (IoU 0.45) over each image's 1000 best (box,
    class) pairs; ``yolo_loss`` forward and backward on the three heads
    with 50 boxes an image; ``roi_align`` (14 x 14) and ``roi_pool`` (7 x
    7) at Faster R-CNN C4's shapes; ``psroi_pool`` at R-FCN's; a
    ``deform_conv2d`` v2."""
    from paddle_tpu_torch.vision import ops as V
    rs = np.random.RandomState(SEED + 180)
    times, errs = {}, {}

    def timed(name, fn):
        out = fn()
        times[name] = event_ms(fn, 3)
        return out

    def hold(name, got, want):
        err = rel_err(got, want)
        errs[name] = max(errs.get(name, 0.0), err)
        if not err <= DET_TOL:
            raise AssertionError(f"phase 16 {name}: card vs CPU {err}")

    heads = [torch.from_numpy(rs.randn(YOLO_BATCH, 3 * (5 + YOLO_CLASSES),
                                       g, g).astype(np.float32))
             for g, _, _ in YOLO_HEADS]
    size = torch.full((YOLO_BATCH, 2), 608, dtype=torch.int32)
    boxes, scores = [], []
    for x, (g, stride, mask) in zip(heads, YOLO_HEADS):
        anchors = [YOLO_ANCHORS[2 * m + k] for m in mask for k in (0, 1)]

        def box(dev, x=x, anchors=anchors, stride=stride):
            return V.yolo_box(x.to(dev), size.to(dev), anchors,
                              YOLO_CLASSES, 0.01, stride)

        got = timed(f"yolo_box_{g}", lambda: box(device))
        want = box("cpu")
        for gt_, wt in zip(got, want):
            hold("yolo_box", gt_, wt)
        boxes.append(want[0])
        scores.append(want[1])
    boxes, scores = torch.cat(boxes, 1), torch.cat(scores, 1)
    kept_total = 0
    for n in range(YOLO_BATCH):
        top = torch.topk(scores[n].reshape(-1), YOLO_NMS_TOP)
        b = boxes[n][top.indices // YOLO_CLASSES]
        cat = top.indices % YOLO_CLASSES

        def nms(dev, b=b, s=top.values, cat=cat):
            return V.nms(b.to(dev), YOLO_IOU, s.to(dev), cat.to(dev),
                         list(range(YOLO_CLASSES)))

        got = timed("nms", lambda: nms(device)) if n == 0 else nms(device)
        want = nms("cpu")
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"phase 16 nms image {n}: card "
                                 f"{got[:8].tolist()} CPU {want[:8].tolist()}")
        kept_total += want.numel()
    gt = np.zeros((YOLO_BATCH, YOLO_GT, 4), np.float32)
    gt[..., :2] = rs.uniform(0.05, 0.95, (YOLO_BATCH, YOLO_GT, 2))
    gt[..., 2:] = rs.uniform(0.02, 0.5, (YOLO_BATCH, YOLO_GT, 2))
    labels = rs.randint(0, YOLO_CLASSES, (YOLO_BATCH, YOLO_GT)).astype(
        np.int32)
    for x, (g, stride, mask) in zip(heads, YOLO_HEADS):
        def loss(dev, x=x, mask=mask, stride=stride):
            xin = x.to(dev).requires_grad_(True)
            out = V.yolo_loss(xin, torch.from_numpy(gt).to(dev),
                              torch.from_numpy(labels).to(dev),
                              YOLO_ANCHORS, mask, YOLO_CLASSES, 0.7, stride)
            out.sum().backward()
            return out, xin.grad

        got = timed(f"yolo_loss_{g}", lambda: loss(device))
        want = loss("cpu")
        hold("yolo_loss", got[0], want[0])
        hold("yolo_loss_grad", got[1], want[1])
    c4 = torch.from_numpy(rs.randn(2, 1024, 50, 76).astype(np.float32))
    ps = torch.from_numpy(rs.randn(2, 21 * 49, 50, 76).astype(np.float32))
    rois = [det_rois(rs, DET_ROIS, 800, 1216) for _ in range(2)]
    all_rois = torch.from_numpy(np.concatenate(rois))
    sub = torch.from_numpy(np.concatenate([r[:DET_CHECK_ROIS]
                                           for r in rois]))
    pick = np.concatenate([np.arange(DET_CHECK_ROIS),
                           DET_ROIS + np.arange(DET_CHECK_ROIS)])
    for name, fn, feat, out in (
            ("roi_align", V.roi_align, c4, 14),
            ("roi_pool", V.roi_pool, c4, 7),
            ("psroi_pool", V.psroi_pool, ps, 7)):
        feat_d, rois_d = feat.to(device), all_rois.to(device)
        got = timed(name, lambda: fn(feat_d, rois_d, [DET_ROIS] * 2, out,
                                     1 / 16))
        want = fn(feat, sub, [DET_CHECK_ROIS] * 2, out, 1 / 16)
        hold(name, got[torch.from_numpy(pick).to(device)], want)
    x = torch.from_numpy(rs.randn(2, 256, 50, 76).astype(np.float32))
    off = torch.from_numpy(2 * rs.randn(2, 18, 50, 76).astype(np.float32))
    mask = torch.sigmoid(torch.from_numpy(rs.randn(2, 9, 50, 76).astype(
        np.float32)))
    w = torch.from_numpy((rs.randn(256, 256, 3, 3) / 48).astype(np.float32))
    bias = torch.from_numpy(rs.randn(256).astype(np.float32))
    args = (x, off, w, bias)
    dargs = [a.to(device) for a in args]
    got = timed("deform_conv2d", lambda: V.deform_conv2d(
        *dargs, padding=1, mask=mask.to(device)))
    hold("deform_conv2d", got, V.deform_conv2d(*args, padding=1, mask=mask))
    log(f"phase 16 (iii) on {card}: ms on the card (median of 3, CUDA "
        f"events) {json.dumps({k: round(v, 4) for k, v in times.items()})}"
        f"; card vs CPU, of each output's largest magnitude "
        f"{json.dumps(errs)} (bound {DET_TOL}); categorical nms kept "
        f"{kept_total} of {YOLO_BATCH} x {YOLO_NMS_TOP} pairs, equal to "
        f"the CPU's; region ops held on the first {DET_CHECK_ROIS} of "
        f"{DET_ROIS} regions an image")
    return {"ms": times, "err": errs}


def phase_vision(device, card):
    """16: the rest of ``vision`` on the card: (i) MobileNetV2 trained
    (:func:`vision_train`), (ii) the other families' forwards
    (:func:`vision_zoo`), (iii) the seven detection ops
    (:func:`vision_ops_phase`)."""
    import tempfile
    tmp = tempfile.mkdtemp(dir=TRACE_ROOT)
    return {"train": vision_train(device, card, tmp),
            "zoo": vision_zoo(device, card),
            "ops": vision_ops_phase(device, card)}


# ---------------------------------------------------------------- phase 17
#: (i) BERT-base fine-tuned quantization-aware at ``bench_bert``'s
#: configuration through ``Model.fit``: ``QAT_WARM`` warm-up and
#: ``QAT_STEPS`` timed steps on phase 10's fixed batch
QAT_WARM, QAT_STEPS = 3, 8
#: (ii) PTQ calibration batches of [32, 128]
PTQ_BATCHES = 4
#: (iii) ``Predictor.run`` calls timed (median of CUDA events)
QAT_SERVE_RUNS = 10
#: a fake-quantized bf16 weight over its scale, times 127, lies within
#: this fraction of its magnitude (and at least of 1) from an integer:
#: the quantizer's last two steps (times the scale, over 127) each round
#: to bf16, at most half an ulp (2 ** -8 relative) each; bf16 cannot hold
#: the grid exactly above code 64, where its ulp is half a code
QAT_GRID_TOL = 2.0 ** -7
#: (iv) float32 card vs CPU: the loss of each of 3 QAT steps (SGD, lr
#: ``QAT_F32_LR``) within ``QAT_F32_TOL`` relative; LeNet's quantized
#: program outputs within ``QAT_F32_TOL`` of their largest value
QAT_F32_TOL = 1e-4
QAT_F32_LR = 1e-3
#: an int8 code whose pre-round value on the CPU lies within this of a
#: rounding boundary (in code units) may round the other way on the
#: card, whose float32 sums run in another order: the codes must agree
#: everywhere else
QAT_TIE = 1e-3


def quant_net(device, layers, seed, dtype=None):
    """``BertForQuestionAnswering`` at base width cut to ``layers``
    (dropout 0), wrapped for ``Model.fit`` (positional ids, start, end);
    the wrapper's ``inner`` is the network."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.models.bert import BertForQuestionAnswering

    class SpanFinetune(nn.Layer):
        """The span-extraction fine-tune of phase 17: (ids, start, end)
        in, (loss, start logits, end logits) out."""

        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, ids, start, end):
            return self.inner(ids, start_positions=start,
                              end_positions=end)

    return SpanFinetune(bert_net(BertForQuestionAnswering, layers, device,
                                 seed, dtype))


def count_linears(net):
    from paddle_tpu_torch.nn import Linear
    return sum(isinstance(m, Linear) for m in net.modules())


def grid_check(what, net):
    """Every ``QuantizedLinear``'s fake-quantized weight lies on its int8
    grid: ``w_q / s * 127`` within ``QAT_GRID_TOL`` of an integer.
    Returns the layers checked and the worst distance found."""
    from paddle_tpu_torch.quantization import QuantizedLinear
    worst, n = 0.0, 0
    with torch.no_grad():
        for name, m in net.named_modules():
            if not isinstance(m, QuantizedLinear):
                continue
            w = m.inner.weight
            wq = m.weight_quant(w)
            v = wq.float() / w.abs().amax().float() * 127.0
            dist = (v - v.round()).abs()
            lim = QAT_GRID_TOL * v.abs().clamp_min(1.0)
            if (dist > lim).any() or v.abs().max() > 127.0 + QAT_GRID_TOL \
                    * 127.0:
                raise AssertionError(
                    f"{what}: {name}'s fake-quantized weight is off its "
                    f"int8 grid: {int((dist > lim).sum())} values, worst "
                    f"{dist.max().item():.3e}")
            worst = max(worst, dist.max().item())
            n += 1
    return n, worst


def qat_fit(device, card):
    """17 (i): BERT-base, ``amp.decorate`` (O2, bf16) and then
    ``ImperativeQuantAware().quantize``, trained through ``Model.fit``
    (AdamW with float32 masters) on phase 10's fixed batch; returns the
    fit's launches, the parameter shapes with a gradient, the network,
    and its step time."""
    import paddle_tpu_torch.optimizer.optimizer as opt_module
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.hapi import Callback, Model
    from paddle_tpu_torch.io import TensorDataset
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.quantization import (ImperativeQuantAware,
                                               QuantizedLinear)
    net = quant_net(device, 12, SEED)
    n_linear = count_linears(net)
    amp.decorate(net, level="O2", dtype="bfloat16")
    ImperativeQuantAware().quantize(net)
    swapped = sum(isinstance(m, QuantizedLinear) for m in net.modules())
    if swapped != n_linear or count_linears(net) != n_linear:
        raise AssertionError(f"phase 17: {swapped} QuantizedLinear for "
                             f"{n_linear} Linear")
    want = bert_want(net)
    model = Model(net, inputs=["ids", "start", "end"], device=device)
    model.prepare(AdamW(learning_rate=BERT_LR, weight_decay=BERT_WD,
                        parameters=net.parameters(), multi_precision=True),
                  loss=lambda loss, start, end: loss,
                  amp_configs={"level": "O2", "dtype": "bfloat16"})
    n = QAT_WARM + QAT_STEPS + 1
    vocab = net.inner.bert.cfg.vocab_size
    rows = [torch.from_numpy(a) for a in bert_batch(BERT_BATCH, BERT_SEQ,
                                                     vocab)]
    data = TensorDataset([r.repeat(n, *([1] * (r.dim() - 1)))
                          for r in rows])
    counters = train_counters()
    losses, per_step, stamps = [], [], []

    def spy(inputs, labels, update=True, _orig=model._train_step):
        at = read_counts(counters)
        loss, outs = _orig(inputs, labels, update)
        now = read_counts(counters)
        per_step.append({k: now[k] - at[k] for k in now})
        losses.append(loss.detach())
        return loss, outs

    class Steps(Callback):
        """The last step runs under sync debug "error"; CUDA events at
        each step's end."""

        def on_train_batch_begin(self, step, logs=None):
            if step == n - 1:
                torch.cuda.set_sync_debug_mode("error")

        def on_train_batch_end(self, step, logs=None):
            if step == n - 1:
                torch.cuda.set_sync_debug_mode(0)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            stamps.append(ev)

        def on_train_abort(self):
            torch.cuda.set_sync_debug_mode(0)

    model._train_step = spy
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    try:
        with count_plain() as plain, adamw_dtypes(opt_module) as kinds:
            t0 = time.perf_counter()
            model.fit(data, batch_size=BERT_BATCH, epochs=1, shuffle=False,
                      log_freq=10 * n, verbose=0, callbacks=[Steps()])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
    del model._train_step
    launches = read_counts(counters)
    peak = torch.cuda.max_memory_allocated()
    if per_step != [want] * n:
        bad = [(i, s) for i, s in enumerate(per_step) if s != want]
        raise AssertionError(f"phase 17: launches a QAT step, expected "
                             f"{want}: {bad[:3]} ({len(per_step)} steps)")
    check_flash_route("phase 17", counters, "tc")
    check_ln_route("phase 17", (counters["fused_layer_norm"],
                                counters["fused_layer_norm_bwd"]))
    if sum(plain.values()) or set(kinds) != {
            ("float32", "bfloat16", "bfloat16")}:
        raise AssertionError(f"phase 17: plain versions {dict(plain)}, "
                             f"AdamW (p, g, copy) dtypes {dict(kinds)}")
    losses = [x.item() for x in losses]
    timed = losses[QAT_WARM:QAT_WARM + QAT_STEPS]
    if not all(math.isfinite(x) for x in losses) or not timed[-1] < timed[0]:
        raise AssertionError(f"phase 17: QAT losses on the fixed batch: "
                             f"{losses}")
    step_ms = [stamps[i - 1].elapsed_time(stamps[i])
               for i in range(QAT_WARM, QAT_WARM + QAT_STEPS)]
    ms = stamps[QAT_WARM - 1].elapsed_time(
        stamps[QAT_WARM + QAT_STEPS - 1]) / QAT_STEPS
    layers, worst = grid_check("phase 17 (i)", net)
    # Model.prepare's O2 decorate made every observer's state bf16; the
    # moving average writes it back float32 (bf16 state, float32 abs-max)
    # in each one that saw a batch: all but the unused pooler's
    ran = {n: m.act_quant.scale_state for n, m in net.named_modules()
           if isinstance(m, QuantizedLinear)
           and not n.endswith("bert.pooler")}
    if len(ran) != swapped - 1 or any(
            s.dtype != torch.float32 or not (s > 0).all()
            or not torch.isfinite(s).all() for s in ran.values()):
        seen = {n: (s.dtype, s.tolist()) for n, s in ran.items()}
        raise AssertionError(f"phase 17: {len(ran)} observers ran for "
                             f"{swapped - 1}; states {seen}")
    log(f"phase 17 (i): BERT-base (bench_bert's configuration), "
        f"amp.decorate (O2, bf16) then ImperativeQuantAware().quantize: "
        f"{swapped} Linear -> QuantizedLinear (12 layers x 6, the pooler "
        f"and the classifier), trained through Model.fit with AdamW lr "
        f"{BERT_LR} (float32 masters), batch {BERT_BATCH} x {BERT_SEQ}: "
        f"{QAT_WARM} warm-up, {QAT_STEPS} timed steps and one more under "
        f"set_sync_debug_mode('error'); launches a step {json.dumps(want)} "
        f"(phase 10's), every flash launch tensor-core, every LayerNorm "
        f"launch warp-row, no plain version; losses {json.dumps(losses)}; "
        f"{layers} fake-quantized weights on their int8 grid (worst "
        f"distance {worst:.3e} codes)")
    log(f"phase 17 (i) on {card}: QAT step {ms:.3f} ms (CUDA events over "
        f"the timed steps; median step {statistics.median(step_ms):.3f} "
        f"ms), {BERT_BATCH * BERT_SEQ / ms * 1e3:.1f} tokens/s, wall "
        f"{wall:.2f} s for {n} steps; max memory allocated {peak} bytes")
    pooler = {id(p) for p in net.inner.bert.pooler.parameters()}
    shapes = [tuple(p.shape) for p in net.parameters() if id(p) not in pooler]
    return launches, shapes, net, ms


def ptq_check(device):
    """17 (ii): ``PostTrainingQuantization`` on a float bf16 BERT-base
    over ``PTQ_BATCHES`` batches under O2; each recorded scale is the
    largest |input| of its ``Linear``, read independently by a hook that
    keeps the running maximum on the card."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.bert import BertForQuestionAnswering
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.quantization import (PostTrainingQuantization,
                                               QuantizedLinear)
    net = bert_net(BertForQuestionAnswering, 12, device, SEED + 170)
    amp.decorate(net, level="O2", dtype="bfloat16")
    vocab = net.bert.cfg.vocab_size
    rng = np.random.RandomState(SEED + 171)
    batches = [torch.from_numpy(rng.randint(0, vocab, (BERT_BATCH, BERT_SEQ))
                                ).to(device) for _ in range(PTQ_BATCHES)]
    seen, hooks = {}, []
    for name, m in net.named_modules():
        if isinstance(m, Linear):
            def hook(mod, inputs, _name=name):
                cur = inputs[0].detach().abs().amax().float()
                seen[_name] = cur if _name not in seen \
                    else torch.maximum(seen[_name], cur)
            hooks.append(m.register_forward_pre_hook(hook))
    ptq = PostTrainingQuantization(net)
    t0 = time.perf_counter()
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        scales = ptq.collect(batches)
    collect_s = time.perf_counter() - t0
    for h in hooks:
        h.remove()
    if set(scales) != set(seen) or not scales:
        raise AssertionError(f"phase 17 (ii): scales of {sorted(scales)}, "
                             f"inputs seen at {sorted(seen)}")
    bad = {k: (v, seen[k].item()) for k, v in scales.items()
           if v != seen[k].item()}
    if bad:
        raise AssertionError(f"phase 17 (ii): PTQ scale != the input's "
                             f"abs-max: {bad}")
    model = ptq.quantize()
    frozen = {n: m.act_quant.scale_state.item()
              for n, m in model.named_modules()
              if isinstance(m, QuantizedLinear) and n in scales}
    if any(frozen[n] != float(np.float32(scales[n])) for n in frozen):
        raise AssertionError(f"phase 17 (ii): frozen observer states "
                             f"{frozen} vs {scales}")
    with torch.no_grad(), amp.auto_cast(level="O2", dtype="bfloat16"):
        out = model(batches[0])
    if not all(torch.isfinite(o).all() for o in out):
        raise AssertionError("phase 17 (ii): the PTQ model's logits")
    log(f"phase 17 (ii): PostTrainingQuantization of a float bf16 BERT-base "
        f"(the QA head, which never runs the pooler) over {PTQ_BATCHES} "
        f"batches of [{BERT_BATCH}, {BERT_SEQ}] in {collect_s:.2f} s: "
        f"{len(scales)} scales, each equal to its Linear's input abs-max "
        f"read by a separate hook (range {min(scales.values()):.4g} .. "
        f"{max(scales.values()):.4g}); the quantized model's observers "
        f"start from them and its logits are finite")
    del net, model
    gc.collect()
    torch.cuda.empty_cache()


def qat_serve(device, card, net, counters, tmp):
    """17 (iii): ``save_quantized_model`` of (i)'s network (its ``inner``
    BERT, ids and token types of ``[None, 128]``) -> ``create_predictor``
    -> ``Predictor.run``; returns the launches of the served runs."""
    from paddle_tpu_torch import amp, inference
    from paddle_tpu_torch.nn.layer.layers import port_axis
    from paddle_tpu_torch.quantization import (ImperativeQuantAware,
                                               QuantizedInferenceLinear,
                                               QuantizedLinear,
                                               quantize_weight)
    from paddle_tpu_torch.static import InputSpec
    bert = net.inner
    # the trained bf16 weights in float32, as convert_to_int8 reads them,
    # per output channel (the JAX layout's last axis)
    codes = {n: quantize_weight(m.inner.weight.detach().float(),
                                channel_axis=port_axis(m.inner.weight, -1))[0]
             for n, m in bert.named_modules()
             if isinstance(m, QuantizedLinear)}
    specs = [InputSpec([None, BERT_SEQ], "int64", "input_ids"),
             InputSpec([None, BERT_SEQ], "int64", "token_type_ids")]
    path = os.path.join(tmp, "bert_int8")
    t0 = time.perf_counter()
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        live = ImperativeQuantAware().save_quantized_model(
            bert, path, input_spec=specs)
    export_s = time.perf_counter() - t0
    frozen = {n: m for n, m in live.named_modules()
              if isinstance(m, QuantizedInferenceLinear)}
    if set(frozen) != set(codes):
        raise AssertionError(f"phase 17 (iii): {len(frozen)} int8 layers "
                             f"for {len(codes)} QAT layers")
    for n, m in frozen.items():
        if m.weight_int8.dtype != torch.int8 or not torch.equal(
                m.weight_int8, codes[n]):
            raise AssertionError(f"phase 17 (iii): {n}.weight_int8 is not "
                                 f"quantize_weight of the trained weight")
    from paddle_tpu_torch.framework.io import load as pt_load
    stored = pt_load(path + ".pdiparams")
    dtypes = {str(np.asarray(v).dtype) for k, v in stored.items()
              if k.endswith("weight_int8")}
    held = sum(k.endswith("weight_int8") for k in stored)
    if held != len(codes) or dtypes != {"int8"}:
        raise AssertionError(f"phase 17 (iii): the .pdiparams holds {held} "
                             f"int8 weights, dtypes {sorted(dtypes)}")
    t0 = time.perf_counter()
    pred = inference.create_predictor(inference.Config(path + ".pdmodel"))
    load_s = time.perf_counter() - t0
    ids = bert_batch(BERT_BATCH, BERT_SEQ, bert.bert.cfg.vocab_size)[0]
    types = np.zeros_like(ids)
    with torch.no_grad(), amp.auto_cast(level="O2", dtype="bfloat16"):
        want = [w.cpu() for w in live(torch.from_numpy(ids).to(device),
                                      torch.from_numpy(types).to(device))]
    n_ln = sum(1 for m in bert.modules() if type(m).__name__ == "LayerNorm")
    layers = len(bert.bert.encoder.layers)
    per_run = {"fused_layer_norm": n_ln, "warp": n_ln,
               "flash_attention_fwd": layers, "tc": layers, "others": 0}
    runs = []

    def served():
        at = deploy_counts(counters)
        out = pred.run([ids, types])
        now = deploy_counts(counters)
        runs.append({k: now[k] - at[k] for k in now})
        return out

    reset_counts(counters)
    with count_plain() as plain:
        got = served()
        run_ms = event_ms(served, QAT_SERVE_RUNS)
    launches = read_counts(counters)
    if sum(plain.values()) or runs != [per_run] * (QAT_SERVE_RUNS + 1):
        raise AssertionError(f"phase 17 (iii): launches a Predictor.run, "
                             f"expected {per_run}: {runs[:3]}; plain "
                             f"{dict(plain)}")
    errs = [check_close(f"phase 17 (iii) served {n} logits",
                        torch.from_numpy(g), w, torch.bfloat16)
            for n, g, w in zip(("start", "end"), got, want)]
    size = artifact_bytes(path)
    log(f"phase 17 (iii): the QAT BERT-base frozen by save_quantized_model "
        f"(convert_to_int8: {len(frozen)} int8-weight Linear layers, "
        f"weight_int8 bit-equal to quantize_weight of the trained weights, "
        f"int8 in the .pdiparams) and exported in {export_s:.2f} s "
        f"({size} bytes: .pdmodel, .pdiparams, .meta.json; phase 12's "
        f"float bf16 artifact beside it above), loaded by create_predictor "
        f"in {load_s:.2f} s; each Predictor.run at [{BERT_BATCH}, "
        f"{BERT_SEQ}] launched K2 = {n_ln} (warp-row) and K4 = {layers} "
        f"(tensor-core), no plain version; logits within bf16 TOL of the "
        f"live converted model (max abs err {max(errs):.3e})")
    log(f"phase 17 (iii) on {card}: Predictor.run {run_ms:.3f} ms a batch "
        f"(median of {QAT_SERVE_RUNS}, CUDA events, numpy in and out)")
    del pred, live
    return launches


def near_tie(w, bits=8):
    """Where ``w``'s per-output-channel int8 pre-round value (as
    ``quantize_weight`` computes it) lies within ``QAT_TIE`` of a
    rounding boundary."""
    from paddle_tpu_torch.nn.layer.layers import port_axis
    keep = port_axis(w, -1)
    w = w.detach().float()
    axes = tuple(i for i in range(w.dim()) if i != keep)
    scale = w.abs().amax(dim=axes, keepdim=True) / 127.0
    v = w / torch.where(scale == 0, torch.ones_like(scale), scale)
    return ((v - v.floor()) - 0.5).abs() < QAT_TIE


class CodeTrace:
    """Forward hooks on every activation observer of a QAT network.
    ``record``: keep each call's fake-quantized output (moved to the
    CPU). ``follow``: where an output's int8 code differs from the
    recorded one, which must be a near-tie of this side's pre-round value
    (within ``QAT_TIE`` of a rounding boundary, one code apart), take the
    recorded code, with the straight-through gradient kept; count those
    flips."""

    def __init__(self, net, mode):
        from paddle_tpu_torch.quantization import MovingAverageAbsMaxScale
        self.mode, self.outs, self.flips, self.sites = mode, [], 0, 0
        self._at = 0
        self._hooks = [m.register_forward_hook(self._hook)
                       for m in net.modules()
                       if isinstance(m, MovingAverageAbsMaxScale)]

    def _hook(self, mod, inputs, out):
        if self.mode == "record":
            self.outs.append(out.detach().cpu())
            return None
        want = self.outs[self._at]
        self._at += 1
        s = mod.scale_state.float().reshape(())
        x = inputs[0].detach()
        v = torch.minimum(torch.maximum(x, -s), s) / s * 127.0
        step = (out.detach() - want) / s * 127.0
        flip = step.abs() > 0.5
        tie = ((v - v.floor()) - 0.5).abs() < QAT_TIE
        if (flip & ~tie).any() or (step.abs() > 1.5).any():
            raise AssertionError(
                f"phase 17 (iv): {int((flip & ~tie).sum())} activation "
                f"codes differ card vs CPU away from a near-tie")
        self.flips += int(flip.sum())
        self.sites += flip.numel()
        return out + torch.where(flip, want - out, 0.0).detach()

    def close(self):
        for h in self._hooks:
            h.remove()


def qat_f32(device):
    """17 (iv): float32 at base width cut to 2 layers, card against a CPU
    copy: 3 QAT steps (SGD) in lockstep with losses within
    ``QAT_F32_TOL``, then ``convert_to_int8``'s codes equal away from
    near-ties; and LeNet's recorded program through
    ``QuantizationTransformPass``, ``calibrate_program`` and
    ``PostTrainingQuantizationProgram``, its outputs within
    ``QAT_F32_TOL``.

    Fake quantization is discontinuous: an activation within float32
    rounding of a code boundary rounds one way on the card and the other
    on the CPU (their sums run in other orders), and one such code moves
    the loss by more than ``QAT_F32_TOL``. So each step runs on the card
    first (:class:`CodeTrace` records its codes) and then on the CPU,
    which takes the card's code wherever they differ, after checking
    that every such place is a near-tie."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import static
    from paddle_tpu_torch.convert import layer_from_jax, layer_to_numpy
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.quantization import (
        ImperativeQuantAware, PostTrainingQuantizationProgram,
        QuantizationTransformPass, QuantizedInferenceLinear,
        calibrate_program, convert_to_int8)
    from paddle_tpu_torch.vision.models import LeNet
    cpu = torch.device("cpu")
    ids, start, end = bert_batch(BERT_PARITY_BATCH, BERT_PARITY_SEQ, 30522)
    card = quant_net(device, BERT_PARITY_LAYERS, SEED + 172)
    host = quant_net(cpu, BERT_PARITY_LAYERS, SEED + 173)
    layer_from_jax(host, layer_to_numpy(card))
    side = {}
    for key, net, dev in (("card", card, device), ("host", host, cpu)):
        ImperativeQuantAware().quantize(net)
        side[key] = (net, SGD(learning_rate=QAT_F32_LR,
                              parameters=net.parameters()),
                     [torch.from_numpy(a).to(dev) for a in (ids, start, end)])
    losses = {"card": [], "host": []}
    flips = sites = 0
    for _ in range(3):
        rec = CodeTrace(card, "record")
        for key in ("card", "host"):
            net, opt, batch = side[key]
            follow = None
            if key == "host":
                follow = CodeTrace(host, "follow")
                follow.outs = rec.outs
            loss = net(*batch)[0]
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses[key].append(loss.item())
            if follow is not None:
                follow.close()
                flips += follow.flips
                sites += follow.sites
        rec.close()
    for a, b in zip(losses["card"], losses["host"]):
        if not abs(a - b) <= QAT_F32_TOL * abs(b):
            raise AssertionError(f"phase 17 (iv): QAT losses card "
                                 f"{losses['card']} vs CPU {losses['host']}")
    near = {n: near_tie(m.inner.weight) for n, m in host.named_modules()
            if type(m).__name__ == "QuantizedLinear"}
    nets = {}
    for key, net in (("card", card), ("host", host)):
        convert_to_int8(net)
        nets[key] = {n: m.weight_int8.detach().cpu()
                     for n, m in net.named_modules()
                     if isinstance(m, QuantizedInferenceLinear)}
    differ = ties = 0
    for n, c in nets["card"].items():
        h = nets["host"][n]
        tie = near[n]
        ties += int(tie.sum())
        off = c != h
        differ += int(off.sum())
        if (off & ~tie).any() or ((c.int() - h.int()).abs() > 1).any():
            raise AssertionError(f"phase 17 (iv): {n}: {int(off.sum())} "
                                 f"int8 codes differ card vs CPU, "
                                 f"{int((off & ~tie).sum())} away from a "
                                 f"near-tie")
    log(f"phase 17 (iv): QAT BERT (base width, {BERT_PARITY_LAYERS} layers, "
        f"float32, batch {BERT_PARITY_BATCH} x {BERT_PARITY_SEQ}, SGD lr "
        f"{QAT_F32_LR}) card vs CPU in lockstep: {flips} of {sites} "
        f"activation codes were near-ties rounded the other way on the "
        f"CPU (it took the card's); 3 losses within {QAT_F32_TOL} (card "
        f"{losses['card']}, CPU {losses['host']}); convert_to_int8 codes "
        f"of {len(nets['card'])} layers equal but at {differ} of {ties} "
        f"weight near-ties (within {QAT_TIE} of a rounding boundary)")
    rng = np.random.RandomState(SEED + 174)
    feeds = [{"image": rng.randn(2, 1, 28, 28).astype(np.float32)}
             for _ in range(3)]
    outs = {}
    pt.seed(SEED + 175)
    lenet = LeNet()
    state = layer_to_numpy(lenet)
    old = pt.get_device()
    try:
        for key, dev in (("card", device), ("host", cpu)):
            pt.set_device(dev.type)
            net = LeNet().to(dev)
            layer_from_jax(net, state)
            net.eval()
            pt.enable_static()
            try:
                main = static.Program()
                with static.program_guard(main, static.Program()):
                    x = static.data(name="image", shape=[None, 1, 28, 28],
                                    dtype="float32")
                    out = net(x)
            finally:
                pt.disable_static()
            exe = static.Executor()
            dyn = QuantizationTransformPass().apply(main)
            scales = calibrate_program(main, feeds)
            if key == "card":
                ptq = PostTrainingQuantizationProgram(main, feeds)
                prog = ptq.quantize()
                card_scales = ptq.scales
            else:
                # the card's frozen scales, so that an activation code
                # differs only where the values do (the scales themselves
                # are compared below)
                prog = QuantizationTransformPass().apply(main, card_scales)
            outs[key] = (
                exe.run(dyn, feed=feeds[0], fetch_list=[out])[0],
                exe.run(prog, feed=feeds[1], fetch_list=[out])[0],
                scales)
    finally:
        pt.set_device(old)
    errs = []
    for i, what in enumerate(("transformed", "PTQ")):
        got, want = outs["card"][i], outs["host"][i]
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
        errs.append(err)
        if not err <= QAT_F32_TOL:
            raise AssertionError(f"phase 17 (iv): LeNet's {what} program "
                                 f"card vs CPU {err:.3e} > {QAT_F32_TOL}")
    cs, hs = outs["card"][2], outs["host"][2]
    if set(cs) != set(hs) or len(cs) != 5 or any(
            abs(cs[k] - hs[k]) > QAT_F32_TOL * hs[k] for k in hs):
        raise AssertionError(f"phase 17 (iv): calibrated scales card {cs} "
                             f"vs CPU {hs}")
    log(f"phase 17 (iv): LeNet recorded as a float32 static program: "
        f"QuantizationTransformPass (live scales) and "
        f"PostTrainingQuantizationProgram (scales from calibrate_program "
        f"over 3 feeds of 2 images, within {QAT_F32_TOL} card vs CPU; 5 "
        f"quantized nodes, 2 conv2d and 3 linear; the CPU's program frozen "
        f"at the card's scales) card vs CPU within {QAT_F32_TOL} (worst "
        f"{max(errs):.3e})")


def phase_quant(device, card, timer, bert_ms):
    """17: quantization on the card: (i) BERT-base fine-tuned
    quantization-aware through ``Model.fit`` (:func:`qat_fit`), (ii) PTQ
    (:func:`ptq_check`), (iii) the served int8-weight artifact
    (:func:`qat_serve`), (iv) float32 card against CPU (:func:`qat_f32`),
    (v) the numerics libraries card against CPU
    (:func:`numerics_phase`). Returns the kernels line's ``_qat`` rows."""
    import tempfile
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(dir=TRACE_ROOT)
    launches, shapes, net, ms = qat_fit(device, card)
    log(f"phase 17 on {card}: the QAT step {ms:.3f} ms against phase 10's "
        f"eager bf16 step {bert_ms:.3f} ms in this run ({ms / bert_ms:.3f}"
        f"x; {BERT_BATCH * BERT_SEQ / ms * 1e3:.1f} against "
        f"{BERT_BATCH * BERT_SEQ / bert_ms * 1e3:.1f} tokens/s)")
    served = qat_serve(device, card, net, train_counters(), tmp)
    del net
    gc.collect()
    torch.cuda.empty_cache()
    ptq_check(device)
    qat_f32(device)
    numerics_phase(device)
    rows = bert_rows(device, timer, launches, shapes, tail="qat")
    for row in rows:
        for name, count in (("fused_layer_norm_qat", "fused_layer_norm"),
                            ("flash_attention_fwd_qat",
                             "flash_attention_fwd")):
            if row["name"] == name:
                row["launches"] += served[count]
    log(f"phase 17: {time.perf_counter() - t0:.1f} s")
    return rows


#: (v) the numerics libraries, card against CPU: float32 results within
#: ``REL_TOL[float32]`` (1e-5) of each tensor's largest value; the
#: decompositions' reconstructions (qr, svd, eigh, lu on the card) within
#: ``NUM_RECON_TOL`` of the input's 2-norm, and their singular values and
#: eigenvalues within it of the largest, the scale of a float32
#: factorization's backward error (a few ``n * eps * ||A||_2``: cuSOLVER's
#: eigh of a [256, 256] matrix lies near 1.8e-4 of its largest entry)
NUM_RECON_TOL = 1e-4
NUM_MATS, NUM_N = 64, 256
NUM_SIGNALS, NUM_RATE, NUM_FFT, NUM_HOP = 16, 16000, 512, 128
NUM_DRAWS = 100_000
#: a draw's mean and variance within this many standard errors of the
#: distribution's (the variance's standard error from the fourth moment)
NUM_SE = 5.0
#: the point cloud: active sites in an NDHWC grid, channels
CLOUD_SITES, CLOUD_GRID, CLOUD_C = 20_000, (2, 64, 64, 64), 16


def numerics_phase(device):
    """17 (v): ``linalg`` over ``NUM_MATS`` well-conditioned ``[NUM_N,
    NUM_N]`` matrices, ``signal.stft``/``istft`` of ``NUM_SIGNALS``
    one-second signals and ``fft``, each ``distribution``'s closed forms
    and ``NUM_DRAWS`` draws, sparse ``SubmConv3D`` + ``BatchNorm`` +
    ``MaxPool3D`` over a point cloud, ``nn.utils`` weight and spectral
    norm: card against the same calls on the CPU, each timed once on the
    card (median of 3, CUDA events)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import distribution as D
    from paddle_tpu_torch import fft as F_
    from paddle_tpu_torch import linalg as L
    from paddle_tpu_torch import signal as S
    from paddle_tpu_torch import sparse as SP
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.nn import utils as U
    cpu = torch.device("cpu")
    tol = REL_TOL[torch.float32]
    rs = np.random.RandomState(SEED + 190)
    times, errs = {}, {}

    def timed(name, fn):
        out = fn()
        times[name] = event_ms(fn, 3)
        return out

    def hold(name, got, want, limit=tol):
        if isinstance(got, (tuple, list)):
            for i, (g, w) in enumerate(zip(got, want)):
                hold(name, g, w, limit)
            return
        got, want = got.detach().cpu(), want.detach().cpu()
        if got.is_complex():
            got, want = torch.view_as_real(got), torch.view_as_real(want)
        err = rel_err(got, want)
        errs[name] = max(errs.get(name, 0.0), err)
        if not (torch.isfinite(got).all() and err <= limit):
            raise AssertionError(f"phase 17 (v) {name}: card vs CPU {err} "
                                 f"> {limit}")

    def both(name, fn, *arrays, limit=tol):
        got = timed(name, lambda: fn(*[a.to(device) for a in arrays]))
        want = fn(*arrays)
        hold(name, got, want, limit)
        return got, want

    # linalg
    n = NUM_N
    a = torch.from_numpy(rs.randn(NUM_MATS, n, n).astype(np.float32)) \
        / math.sqrt(n) + 2 * torch.eye(n)
    spd = a @ a.mT + torch.eye(n)
    b = torch.from_numpy(rs.randn(NUM_MATS, n, 8).astype(np.float32))
    both("solve", L.solve, a, b)
    both("inv", L.inv, a)
    both("cholesky", L.cholesky, spd)
    both("slogdet", L.slogdet, a)
    tall = torch.cat([a, a[:, : n // 2]], 1)
    # lstsq takes one system at a time (jnp.linalg.lstsq's contract)
    both("lstsq", lambda x, y: torch.stack(
        [L.lstsq(x[i], y[i])[0] for i in range(4)]), tall[:4],
        torch.cat([b, b[:, : n // 2]], 1)[:4])
    recon = {}
    for name, fn, mat in (
            ("qr", lambda x: (lambda q, r: q @ r)(*L.qr(x)), a),
            ("svd", lambda x: (lambda u, s_, vh: u @ torch.diag_embed(s_)
                               @ vh)(*L.svd(x)), a),
            ("eigh", lambda x: (lambda w, v: v @ torch.diag_embed(w)
                                @ v.mT)(*L.eigh(x)), spd),
            ("lu", lambda x: (lambda p_, l_, u_: p_ @ l_ @ u_)(
                *L.lu_unpack(*L.lu(x))), a)):
        got = timed(name, lambda: fn(mat.to(device))).cpu()
        norm2 = torch.linalg.matrix_norm(mat.double(), ord=2).amax().item()
        err = (got - mat).abs().max().item() / norm2
        recon[name] = err
        if not (torch.isfinite(got).all() and err <= NUM_RECON_TOL):
            raise AssertionError(f"phase 17 (v) {name} reconstruction: "
                                 f"{err} of the 2-norm > {NUM_RECON_TOL}")
    # the values a decomposition returns carry its backward error too
    hold("svd values", L.svd(a.to(device))[1], L.svd(a)[1], NUM_RECON_TOL)
    hold("eigh values", L.eigh(spd.to(device))[0], L.eigh(spd)[0],
         NUM_RECON_TOL)
    # signal and fft
    t = torch.arange(NUM_RATE, dtype=torch.float32) / NUM_RATE
    freqs = torch.from_numpy(rs.uniform(100, 4000, (NUM_SIGNALS, 1)
                                        ).astype(np.float32))
    wave = torch.sin(2 * math.pi * freqs * t) + 0.1 * torch.from_numpy(
        rs.randn(NUM_SIGNALS, NUM_RATE).astype(np.float32))
    win = torch.hann_window(NUM_FFT, periodic=True)
    spec, _ = both("stft", lambda x, w: S.stft(x, NUM_FFT, NUM_HOP,
                                              window=w), wave, win)
    back, _ = both("istft", lambda x, w: S.istft(
        x, NUM_FFT, NUM_HOP, window=w, length=NUM_RATE),
        S.stft(wave, NUM_FFT, NUM_HOP, window=win), win)
    hold("stft round trip", back[:, NUM_FFT:-NUM_FFT],
         wave[:, NUM_FFT:-NUM_FFT], NUM_RECON_TOL)
    vol = torch.from_numpy(rs.randn(8, 64, 64, 64).astype(np.float32))
    both("fftn", lambda x: F_.fftn(x, axes=(1, 2, 3)), vol)
    both("irfftn", lambda x: F_.irfftn(F_.rfftn(x, axes=(1, 2, 3)),
                                       s=(64, 64, 64), axes=(1, 2, 3)), vol)
    both("hfftn", lambda x: F_.hfftn(x, axes=(1, 2, 3)),
         torch.complex(vol, vol.flip(0)))
    # distributions: closed forms, and draws in distribution
    loc = torch.from_numpy(rs.randn(64).astype(np.float32))
    scale = torch.from_numpy(rs.uniform(0.5, 2, 64).astype(np.float32))
    pos = torch.from_numpy(rs.uniform(0.5, 4, (64, 5)).astype(np.float32))
    logits = torch.from_numpy(rs.randn(64, 7).astype(np.float32))
    vals = torch.from_numpy(rs.uniform(0.05, 0.95, 64).astype(np.float32))

    def dists(dev):
        mv = lambda x: x.to(dev)  # noqa: E731
        return {"normal": (D.Normal(mv(loc), mv(scale)),
                           D.Normal(mv(loc) + 1, mv(scale) * 2), mv(loc)),
                "uniform": (D.Uniform(mv(loc) - 1, mv(loc) + 2),
                            D.Uniform(mv(loc) - 2, mv(loc) + 3), mv(loc)),
                "categorical": (D.Categorical(mv(logits)),
                                D.Categorical(mv(logits) * 0.5),
                                torch.arange(64, device=dev) % 7),
                "beta": (D.Beta(mv(pos[:, 0]), mv(pos[:, 1])),
                         D.Beta(mv(pos[:, 2]), mv(pos[:, 3])), mv(vals)),
                "dirichlet": (D.Dirichlet(mv(pos)), D.Dirichlet(mv(pos) + 1),
                              mv(pos / pos.sum(-1, keepdim=True)))}

    card_d, host_d = dists(device), dists(cpu)
    for name in card_d:
        p, q, v = card_d[name]
        hp, hq, hv = host_d[name]
        hold(f"{name} log_prob", p.log_prob(v), hp.log_prob(hv))
        hold(f"{name} entropy", p.entropy(), hp.entropy())
        hold(f"{name} kl", D.kl_divergence(p, q), D.kl_divergence(hp, hq))
    moments = {}
    probs, ks = torch.softmax(logits[:4], -1), torch.arange(7.)
    share = pos[:4] / pos[:4].sum(-1, keepdim=True)
    pt.seed(SEED + 191)
    for name, dist, mean, var in (
            ("normal", D.Normal(loc[:4].to(device), scale[:4].to(device)),
             loc[:4], scale[:4] ** 2),
            ("uniform", D.Uniform(loc[:4].to(device) - 1,
                                  loc[:4].to(device) + 2),
             loc[:4] + 0.5, torch.full((4,), 0.75)),
            ("beta", D.Beta(pos[:4, 0].to(device), pos[:4, 1].to(device)),
             pos[:4, 0] / pos[:4, :2].sum(-1),
             pos[:4, 0] * pos[:4, 1] / (pos[:4, :2].sum(-1) ** 2
                                         * (pos[:4, :2].sum(-1) + 1))),
            ("categorical", D.Categorical(logits[:4].to(device)),
             (probs * ks).sum(-1),
             (probs * ks ** 2).sum(-1) - (probs * ks).sum(-1) ** 2),
            ("dirichlet", D.Dirichlet(pos[:4].to(device)), share,
             share * (1 - share) / (pos[:4].sum(-1, keepdim=True) + 1))):
        draws = timed(f"{name} sample",
                      lambda d=dist: d.sample((NUM_DRAWS,), seed=7)).float()
        if draws.device.type != torch.device(device).type:
            raise AssertionError(f"phase 17 (v): {name} drew on "
                                 f"{draws.device}")
        d = draws.cpu().double()
        m, v2 = d.mean(0), d.var(0)
        se_m = (v2 / NUM_DRAWS).sqrt()
        se_v = ((((d - m) ** 4).mean(0) - v2 ** 2).clamp_min(0)
                / NUM_DRAWS).sqrt()
        zm = ((m - mean.double()).abs() / se_m).max().item()
        zv = ((v2 - var.double()).abs() / se_v).max().item()
        moments[name] = (zm, zv)
        if not (zm <= NUM_SE and zv <= NUM_SE):
            raise AssertionError(f"phase 17 (v) {name}: {NUM_DRAWS} draws' "
                                 f"mean {zm:.2f}, variance {zv:.2f} standard "
                                 f"errors off")
    # the point cloud through SubmConv3D + BatchNorm + MaxPool3D
    cells = int(np.prod(CLOUD_GRID))
    flat = rs.choice(cells, CLOUD_SITES, replace=False)
    idx = torch.from_numpy(np.stack(np.unravel_index(np.sort(flat),
                                                     CLOUD_GRID)))
    feats = torch.from_numpy(rs.randn(CLOUD_SITES, CLOUD_C).astype(
        np.float32))
    feats[0] = 0.0                  # an active site with zero features
    shape = CLOUD_GRID + (CLOUD_C,)
    pt.seed(SEED + 192)
    state = SP.nn.SubmConv3D(CLOUD_C, 32, 3, padding=1).state_dict()
    pool = SP.nn.MaxPool3D(2)

    def cloud(dev):
        pt.set_device(dev.type)
        c = SP.nn.SubmConv3D(CLOUD_C, 32, 3, padding=1).to(dev)
        c.load_dict(state)
        nm = SP.nn.BatchNorm(32).to(dev)
        x = SP.sparse_coo_tensor(idx.to(dev), feats.to(dev), shape)
        y = c(x)
        z = pool(SP.nn.ReLU()(nm(y)))
        (z.values() ** 2).sum().backward()
        return y, z, c.weight.grad, nm._mean

    old = pt.get_device()
    try:
        cy, cz, cg, cm = timed("point cloud", lambda: cloud(device))
        hy, hz, hg, hm = cloud(cpu)
    finally:
        pt.set_device(old)
    if not torch.equal(cy.indices().cpu(), idx) or not torch.equal(
            cz.indices().cpu(), hz.indices()):
        raise AssertionError("phase 17 (v): the sparse patterns differ")
    for name, g, w in (("subm_conv3d", cy.values(), hy.values()),
                       ("batch_norm + max_pool3d", cz.values(), hz.values()),
                       ("subm_conv3d weight gradient", cg, hg),
                       ("batch_norm running mean", cm, hm)):
        hold(name, g, w)
    # nn.utils on a Linear, forward and gradient
    pt.seed(SEED + 193)
    lin_state = Linear(512, 256).state_dict()
    outs = {}
    for key, dev in (("card", device), ("host", cpu)):
        res = []
        for wrap in (lambda m: U.weight_norm(m, dim=0),
                     lambda m: U.spectral_norm(m, n_power_iterations=2)):
            pt.set_device(dev.type)
            lin = Linear(512, 256).to(dev)
            lin.load_dict(lin_state)
            wrap(lin)
            x = torch.from_numpy(np.random.RandomState(SEED + 194).randn(
                64, 512).astype(np.float32)).to(dev)
            y = lin(x)
            y.square().sum().backward()
            res.append((y, [p.grad for p in lin.parameters()]))
        outs[key] = res
    pt.set_device(old)
    for i, name in enumerate(("weight_norm", "spectral_norm")):
        (cy, cgs), (hy, hgs) = outs["card"][i], outs["host"][i]
        hold(f"{name} forward", cy, hy)
        hold(f"{name} gradient", cgs, hgs)
    worst = moments.items()
    log(f"phase 17 (v): the numerics libraries on the card against the "
        f"CPU: linalg over {NUM_MATS} [{n}, {n}] matrices (solve, inv, "
        f"cholesky, slogdet, lstsq; qr/svd/eigh/lu reconstructions, "
        f"max error over the 2-norm, "
        f"{json.dumps({k: float(f'{v:.3e}') for k, v in recon.items()})} "
        f"within {NUM_RECON_TOL}); stft/istft of {NUM_SIGNALS} one-second "
        f"signals at {NUM_RATE} Hz (n_fft {NUM_FFT}, hop {NUM_HOP}, Hann) "
        f"and the round trip; fftn/irfftn/hfftn over [8, 64, 64, 64]; five "
        f"distributions' log_prob/entropy/KL, and {NUM_DRAWS} draws' mean "
        f"and variance within {NUM_SE} standard errors (worst "
        f"{json.dumps({k: [round(z, 2) for z in v] for k, v in worst})}); "
        f"SubmConv3D (16 -> 32, 3^3) + BatchNorm + ReLU + MaxPool3D(2) over "
        f"{CLOUD_SITES} active sites of a {list(shape)} grid (pattern "
        f"kept, {cz.nnz()} pooled sites), with the weight gradient; "
        f"weight_norm/spectral_norm forward and gradient on a Linear(512, "
        f"256); worst relative errors "
        f"{json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})} "
        f"(limit {tol}, {NUM_RECON_TOL} for the reconstructions)")
    log(f"phase 17 (v) card times (ms, median of 3 CUDA-event runs): "
        f"{json.dumps({k: round(v, 3) for k, v in times.items()})}")


# ---------------------------------------------------------------- phase 18
#: (i) ``FusedMultiTransformer`` at GPT-2 small width, bf16: the context
#: stage over ``INC_PROMPT`` positions of ``INC_BATCH`` rows, ``INC_NEW``
#: scalar decode steps, then ``INC_SLOT_STEPS`` slot-indexed steps with row
#: b at ``INC_FILL + INC_FILL_STEP * b``
INC_LAYERS, INC_D, INC_HEADS, INC_FFN = 12, 768, 12, 3072
INC_BATCH, INC_PROMPT, INC_NEW, INC_SLOT_STEPS = 8, 512, 64, 16
INC_FILL, INC_FILL_STEP = 448, 8
#: the cached rows against the uncached causal forward: the same bf16
#: products at other shapes, so each rounds apart by an ulp now and then
#: and the 12-layer residual stream carries it; max |diff| over the
#: largest |value| within REL_TOL's bf16 2e-2, as the other bf16 paths
INC_DEC_TOL = 2e-2
#: (ii) the fused encoder at BERT-base width, trained on ``[ENC_BATCH,
#: ENC_SEQ]`` ids: 2:4-pruned, ``asp.decorate(LookAhead(AdamW))`` with
#: ``ModelAverage`` beside it
ENC_LAYERS, ENC_VOCAB, ENC_BATCH, ENC_SEQ, ENC_STEPS = 12, 30522, 32, 128, 12
ENC_LR, ENC_WD, ENC_ALPHA, ENC_K = 1e-4, 0.01, 0.5, 4
ENC_AVG = (0.15, 2, 10)     # average_window_rate, min and max windows
#: the witness of the encoder's first step (dropout off, one batch):
#: the port's composed step against ``torch.optim.AdamW`` on float32
#: copies of the same bf16 model's parameters and gradients. The first
#: Adam step moves every entry by lr times the sign of its gradient, so
#: a gradient entry the two runs sum in another order can flip its sign:
#: a master at most ``2 lr`` apart, plus float32 rounding. Only an entry
#: whose gradient lies within rounding of 0 can flip, so at most
#: ``ENC_WIT_MOVED`` of the entries may be over 1e-6 apart (a step that
#: halves or skips the update moves nearly all). The loss before and
#: after the step within 1e-2 of its size
ENC_WIT_MASTER_TOL = 2 * ENC_LR + 1e-6
ENC_WIT_MOVED = 1e-2
ENC_WIT_LOSS_TOL = 1e-2
#: (iii) ``MoELayer`` (8 experts of 3072, top-2, capacity factor 1.25) on
#: bf16 ``MOE_TOKENS`` and float32 ``MOE_F32_TOKENS`` (card against the
#: CPU, within ``MOE_TOL`` of each result's largest value: float32 sums
#: over the tokens in other orders, TF32 off); a routing choice the two
#: devices make differently must be a near-tie (within ``MOE_TIE``)
MOE_E, MOE_HIDDEN, MOE_K, MOE_CAP = 8, 3072, 2, 1.25
MOE_TOKENS, MOE_F32_TOKENS = (32, 128, 768), (4, 128, 768)
MOE_TOL, MOE_TIE = 1e-4, 1e-5
#: (iv) a random graph, and the causal masked softmax's scores; the
#: softmax's float32 values on card and CPU differ in their last bits,
#: so a bf16 probability may round to the neighbouring value: one bf16
#: ulp of 1.0
GRAPH_NODES, GRAPH_EDGES, GRAPH_WIDTH = 100_000, 1_000_000, 64
SOFTMAX_SHAPE = (8, 12, 1024, 1024)
SOFTMAX_TOL = 2.0 ** -8


def inc_counts(counters, before):
    now = read_counts(counters)
    return {k: now[k] - before[k] for k in now}


def incubate_decoder(device, card):
    """18 (i): a 12-layer bf16 ``FusedMultiTransformer`` at GPT-2 small
    width served from its CacheKV: the context stage over ``[8, 512,
    768]``, 64 scalar decode steps (``time_step`` 512..575), then 16
    slot-indexed steps (a ``[8]`` ``time_step``, row b from position
    448 + 8b) over the caches of the context stage. Every call launches
    K2 24 times on the warp-row route and K4 never (every attention is
    masked: the op's plain body); every output row equals the uncached
    causal forward's over the same 576 positions within ``INC_DEC_TOL``.
    Returns the phase's K2 launches."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.incubate.nn import FusedMultiTransformer
    counters = train_counters()
    seed(SEED + 180)
    net = FusedMultiTransformer(INC_D, INC_HEADS, INC_FFN,
                                num_layers=INC_LAYERS).to(
        device, torch.bfloat16).eval()
    total = INC_PROMPT + INC_NEW
    gen = torch.Generator(device=device).manual_seed(SEED + 181)
    x = torch.randn(INC_BATCH, total, INC_D, device=device,
                    generator=gen).bfloat16()
    want_call = {"fused_layer_norm": 2 * INC_LAYERS}
    reset_counts(counters)
    calls = 0

    def call(*a, **kw):
        nonlocal calls
        at = read_counts(counters)
        out = net(*a, **kw)
        moved = {k: v for k, v in inc_counts(counters, at).items() if v}
        if moved != want_call:
            raise AssertionError(f"phase 18 (i): a decoder call launched "
                                 f"{moved}, expected {want_call}")
        calls += 1
        return out

    with torch.no_grad(), count_plain() as plain:
        full = call(x)
        call(x[:, :INC_PROMPT], caches=net.gen_cache(
            INC_BATCH, total, dtype="bfloat16"))          # warm-up
        caches = net.gen_cache(INC_BATCH, total, dtype="bfloat16")
        kept = caches[0].clone()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out, ctx = call(x[:, :INC_PROMPT], caches=caches)
        b.record()
        torch.cuda.synchronize()
        prefill_ms = a.elapsed_time(b)
        if not torch.equal(caches[0], kept):
            raise AssertionError("phase 18 (i): the context stage wrote "
                                 "into the caches passed in")
        rows, cur = [out], ctx
        a.record()
        for t in range(INC_PROMPT, total):
            step, cur = call(x[:, t:t + 1], caches=cur, time_step=t)
            rows.append(step)
        b.record()
        torch.cuda.synchronize()
        decode_ms = a.elapsed_time(b) / INC_NEW
        # the positions live on the host, as a serving loop keeps them
        starts = INC_FILL + INC_FILL_STEP * torch.arange(INC_BATCH)
        batch = torch.arange(INC_BATCH, device=device)
        slot_rows, cur = [], ctx
        for j in range(INC_SLOT_STEPS):
            pos = starts + j
            step, cur = call(x[batch, pos.to(device)][:, None], caches=cur,
                             time_step=pos)
            slot_rows.append(step[:, 0])
        torch.cuda.synchronize()
    launches = read_counts(counters)
    if sum(plain.values()) or launches["flash_attention_fwd"]:
        raise AssertionError(f"phase 18 (i): plain versions {dict(plain)}, "
                             f"flash launches {launches}")
    check_ln_route("phase 18 (i)", (counters["fused_layer_norm"],))
    scale = full.float().abs().max().item()
    err = (torch.cat(rows, 1).float() - full.float()).abs().max().item() \
        / scale
    idx = starts[:, None] + torch.arange(INC_SLOT_STEPS)[None, :]
    want_slot = full[batch[:, None], idx.to(device)]
    slot_err = (torch.stack(slot_rows, 1).float() - want_slot.float()
                ).abs().max().item() / scale
    if not (err <= INC_DEC_TOL and slot_err <= INC_DEC_TOL
            and torch.isfinite(full).all()):
        raise AssertionError(f"phase 18 (i): cached rows off the uncached "
                             f"forward by {err:.3e} (scalar) and "
                             f"{slot_err:.3e} (slot-indexed) of the largest "
                             f"value {scale:.3e}, over {INC_DEC_TOL}")
    copied = sum(c.numel() * c.element_size() for c in ctx)
    log(f"phase 18 (i): FusedMultiTransformer {INC_LAYERS} x {INC_D}, "
        f"{INC_HEADS} heads, FFN {INC_FFN}, gelu, pre-LN, bf16; caches "
        f"[2, {INC_BATCH}, {INC_HEADS}, {total}, {INC_D // INC_HEADS}] a "
        f"layer; {calls} calls, K2 {want_call['fused_layer_norm']} a call "
        f"on the warp-row route, K4 0, no plain version; context + "
        f"{INC_NEW} scalar steps off the uncached causal forward by "
        f"{err:.3e}, {INC_SLOT_STEPS} slot-indexed steps (rows from "
        f"{starts.tolist()}) by {slot_err:.3e} of the largest value "
        f"{scale:.3e} (limit {INC_DEC_TOL})")
    log(f"phase 18 (i) on {card}: prefill {prefill_ms:.3f} ms for "
        f"{INC_BATCH} x {INC_PROMPT} tokens; decode {decode_ms:.3f} ms a "
        f"step, {INC_BATCH / decode_ms * 1e3:.1f} tokens/s; the functional "
        f"cache update writes {copied} bytes a step ({copied / 2 ** 20:.1f} "
        f"MiB: every layer's whole cache anew)")
    del net, full, ctx, cur, rows, caches
    gc.collect()
    torch.cuda.empty_cache()
    return launches["fused_layer_norm"]


def incubate_decoder_f32(device):
    """18 (i), float32: a 2-layer copy on the card against the same
    weights on the CPU (plain versions there), the context stage, 4
    scalar steps and a slot-indexed one, within ``GEN_TOL`` of each
    output's largest value (at least 1)."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.incubate.nn import FusedMultiTransformer
    seed(SEED + 182)
    cpu = FusedMultiTransformer(INC_D, INC_HEADS, INC_FFN,
                                num_layers=2).eval()
    card = FusedMultiTransformer(INC_D, INC_HEADS, INC_FFN,
                                 num_layers=2).to(device).eval()
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(2, 40, INC_D, generator=torch.Generator().manual_seed(
        SEED + 183))
    outs = []
    with torch.no_grad():
        for net, dev in ((cpu, torch.device("cpu")), (card, device)):
            xd = x.to(dev)
            got = [net(xd)]
            o, c = net(xd[:, :32], caches=net.gen_cache(2, 40))
            got.append(o)
            for t in range(32, 36):
                o, c = net(xd[:, t:t + 1], caches=c, time_step=t)
                got.append(o)
            got.append(net(xd[:, 36:37], caches=c,
                           time_step=torch.tensor([36, 30]))[0])
            outs.append([g.cpu() for g in got])
    err = max((a - b).abs().max().item() / max(1.0, a.abs().max().item())
              for a, b in zip(*outs))
    if not err <= GEN_TOL:
        raise AssertionError(f"phase 18 (i) float32: card off the CPU by "
                             f"{err:.3e}, over {GEN_TOL}")
    log(f"phase 18 (i) float32, 2 layers: card against CPU {err:.3e} "
        f"(limit {GEN_TOL})")


def incubate_encoder_net(device):
    """``nn.Embedding(30522, 768)``, 12 ``FusedTransformerEncoderLayer(768,
    12, 3072, dropout_rate=0.1, attn_dropout_rate=0.0, gelu)``, a mean
    pool and ``Linear(768, 2)``; the cross entropy of its logits."""
    from paddle_tpu_torch import nn, seed
    from paddle_tpu_torch.incubate.nn import FusedTransformerEncoderLayer
    from paddle_tpu_torch.nn import functional as F

    class FusedEncoder(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(ENC_VOCAB, INC_D)
            self.layers = nn.LayerList([FusedTransformerEncoderLayer(
                INC_D, INC_HEADS, INC_FFN, dropout_rate=0.1,
                attn_dropout_rate=0.0, activation="gelu")
                for _ in range(ENC_LAYERS)])
            self.head = nn.Linear(INC_D, 2)

        def forward(self, ids, labels):
            h = self.embed(ids)
            for layer in self.layers:
                h = layer(h)
            return F.cross_entropy(self.head(h.mean(1)), labels)

    seed(SEED + 184)
    return FusedEncoder().to(device)


def incubate_encoder(device, card):
    """18 (ii): the fused encoder trained in bf16 AMP O2 with float32
    masters: ``asp.prune_model`` (2:4), ``asp.decorate(LookAhead(AdamW(
    multi_precision=True), alpha=0.5, k=4))``, ``ModelAverage(0.15, 2,
    10)`` stepped beside it, 12 steps on one batch. Each step launches K2
    = K3 = 24 (warp-row) and K4 = K6 = 12 (tensor-core) and K8
    ``adamw_plan``'s count, no plain version; after each, every pruned
    weight passes ``check_sparsity`` on its JAX view; at steps 4, 8, 12
    every master and parameter equal ``mask * (slow + alpha (fast -
    slow))`` from snapshots (the fast weights taken after the inner
    step); inside ``ModelAverage.apply()`` the parameters equal the
    average recomputed from per-step snapshots, after it the live ones
    come back bit for bit; the loss is finite and falls. Then
    ``CostModel.profile_measure`` over one more step. Returns the
    launches and the parameter shapes."""
    import paddle_tpu_torch.optimizer.optimizer as opt_module
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.cost_model import CostModel
    from paddle_tpu_torch.incubate import LookAhead, ModelAverage, asp
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.optimizer import _weak
    net = incubate_encoder_net(device)
    amp.decorate(net, level="O2", dtype="bfloat16")
    asp.reset_excluded_layers()
    masks = asp.prune_model(net)
    if len(masks) != 4 * ENC_LAYERS:
        raise AssertionError(f"phase 18 (ii): {len(masks)} masks")
    pruned = {id(p): p._asp_mask for p in net.parameters()
              if getattr(p, "_asp_mask", None) is not None}
    params = list(net.named_parameters())
    inner = AdamW(ENC_LR, parameters=params, weight_decay=ENC_WD,
                  multi_precision=True)
    look = LookAhead(inner, alpha=ENC_ALPHA, k=ENC_K)
    opt = asp.decorate(look)
    rate, lo, hi = ENC_AVG
    avg = ModelAverage(rate, parameters=params, min_average_window=lo,
                       max_average_window=hi)
    gen = torch.Generator(device=device).manual_seed(SEED + 185)
    ids = torch.randint(0, ENC_VOCAB, (ENC_BATCH, ENC_SEQ), device=device,
                        generator=gen)
    labels = torch.randint(0, 2, (ENC_BATCH,), device=device, generator=gen)
    counters = train_counters()
    numels = [p.numel() for _, p in params]
    want = {"flash_attention_fwd": ENC_LAYERS,
            "flash_attention_bwd": ENC_LAYERS,
            "fused_layer_norm": 2 * ENC_LAYERS,
            "fused_layer_norm_bwd": 2 * ENC_LAYERS,
            "fused_adamw": adamw_launches(numels),
            "fused_adamw_tensors": len(numels)}
    fast = {}
    inner_step = inner.step

    def snap_fast(*a):
        inner_step(*a)
        if look._step_count % ENC_K == ENC_K - 1:     # this step syncs
            masters = inner._master_weights()
            fast.update((n, masters.get(id(p), p).detach().clone())
                        for n, p in params)

    inner.step = snap_fast

    def step():
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            loss = net(ids, labels)
        loss.backward()
        t = time.perf_counter()
        opt.step()
        host = time.perf_counter() - t
        avg.step()
        opt.clear_grad()
        return loss.detach(), host

    torch.cuda.synchronize()
    reset_counts(counters)
    losses, per_step, spans, hosts, synced, snaps = [], [], [], [], [], []
    with count_plain() as plain, adamw_dtypes(opt_module) as kinds:
        for i in range(1, ENC_STEPS + 1):
            slow = {n: s.clone() for n, s in look._slow.items()} \
                if i % ENC_K == 0 else None
            at = read_counts(counters)
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            loss, host = step()
            b.record()
            torch.cuda.synchronize()
            spans.append(a.elapsed_time(b))
            hosts.append(host * 1e6)
            per_step.append(inc_counts(counters, at))
            losses.append(loss.item())
            snaps.append({n: p.detach().clone() for n, p in params})
            bad = [n for n, p in params if id(p) in pruned
                   and not asp.check_sparsity(p)]
            if bad:
                raise AssertionError(f"phase 18 (ii) step {i}: not 2:4 on "
                                     f"the JAX view: {bad[:3]}")
            if slow is not None:
                synced.append(i)
                masters = inner._master_weights()
                for n, p in params:
                    s, f = slow[n], fast[n]
                    new = s + _weak(ENC_ALPHA, s) * (f - s)
                    if id(p) in pruned:
                        new = new * pruned[id(p)]
                    m = masters.get(id(p), p)
                    if not (torch.equal(m, new) and torch.equal(
                            p, new.to(p.dtype))):
                        raise AssertionError(
                            f"phase 18 (ii) step {i}: {n} off the "
                            f"LookAhead sync of its snapshots")
    launches = read_counts(counters)
    inner.step = inner_step
    if per_step != [want] * ENC_STEPS:
        bad = [(i, s) for i, s in enumerate(per_step) if s != want]
        raise AssertionError(f"phase 18 (ii): launches a step, expected "
                             f"{want}: {bad[:3]}")
    check_flash_route("phase 18 (ii)", counters, "tc")
    check_ln_route("phase 18 (ii)", (counters["fused_layer_norm"],
                                     counters["fused_layer_norm_bwd"]))
    if sum(plain.values()) or set(kinds) != {
            ("float32", "bfloat16", "bfloat16")}:
        raise AssertionError(f"phase 18 (ii): plain versions {dict(plain)}, "
                             f"AdamW (p, g, copy) dtypes {dict(kinds)}")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"phase 18 (ii) losses: {losses}")
    # ModelAverage: the windowed sum of the snapshots, as the rule keeps it
    want_avg = {}
    for n, p in params:
        total, count = torch.zeros_like(p), 0
        for snap in snaps:
            total, count = total + snap[n], count + 1
            window = max(lo, min(hi, int(count * rate)))
            if count > window:
                total = total * _weak(window / count, p)
                count = window
        want_avg[n] = total / count
    live = {n: p.detach().clone() for n, p in params}
    with avg.apply():
        off = [n for n, p in params if not torch.equal(p, want_avg[n])]
    back = [n for n, p in params if not torch.equal(p, live[n])]
    if off or back:
        raise AssertionError(f"phase 18 (ii): ModelAverage off the "
                             f"recomputed average {off[:3]}, not restored "
                             f"{back[:3]}")
    costs = CostModel().profile_measure(lambda: step(), repeat=1)
    for op in ("layer_norm", "scaled_dot_product_attention"):
        if costs.get(op, {}).get("calls", 0) <= 0:
            raise AssertionError(f"phase 18 (iv): CostModel saw no {op}: "
                                 f"{sorted(costs)}")
    ms = statistics.median(spans)
    log(f"phase 18 (ii): fused encoder {ENC_LAYERS} x {INC_D} (vocabulary "
        f"{ENC_VOCAB}), bf16 AMP O2 with float32 masters, {len(masks)} "
        f"weights 2:4-pruned, asp.decorate(LookAhead(AdamW(lr {ENC_LR}, wd "
        f"{ENC_WD}), alpha {ENC_ALPHA}, k {ENC_K})), ModelAverage{ENC_AVG}; "
        f"batch {ENC_BATCH} x {ENC_SEQ}, {ENC_STEPS} steps: launches a step "
        f"{json.dumps(want)}, flash on the tensor-core route, LayerNorm on "
        f"the warp-row route, no plain version; 2:4 after every step; the "
        f"sync bit-equal to its snapshots at steps {synced}; ModelAverage "
        f"bit-equal to the recomputed average, restored bit for bit; "
        f"losses {json.dumps([round(x, 5) for x in losses])}")
    log(f"phase 18 (ii) on {card}: {ms:.3f} ms a step (median, CUDA "
        f"events), {ENC_BATCH * ENC_SEQ / ms * 1e3:.1f} tokens/s; "
        f"opt.step() host time median {statistics.median(hosts):.1f} us "
        f"(ASP masks, LookAhead, AdamW's {want['fused_adamw']} launches)")
    cost_ms = {op: round(costs[op]["time"] * 1e3, 4) for op in
               ("layer_norm", "scaled_dot_product_attention", "linear")
               if op in costs}
    log(f"phase 18 (iv): CostModel over one more step: {len(costs)} ops; "
        f"mean ms a call {json.dumps(cost_ms)}; calls "
        f"{json.dumps({op: costs[op]['calls'] for op in cost_ms})}")
    shapes = [tuple(p.shape) for _, p in params]
    del net, opt, look, inner, avg, snaps, fast, want_avg, live
    gc.collect()
    torch.cuda.empty_cache()
    return launches, shapes


def incubate_moe(device, card):
    """18 (iii): ``MoELayer(768, num_experts=8, d_hidden=3072, topk=2,
    capacity_factor=1.25)`` in bf16 on ``[32, 128, 768]``, forward and
    backward timed; then float32 on ``[4, 128, 768]`` on the card against
    a CPU copy (output, ``l_aux``, the input's, gate's and experts'
    gradients within ``MOE_TOL``) with the same routing: where the two
    pick other experts for a token, the gap between the probabilities
    involved must be a near-tie (``MOE_TIE``) and the CPU takes the
    card's choice."""
    import copy

    from paddle_tpu_torch import seed
    from paddle_tpu_torch.incubate import MoELayer
    from paddle_tpu_torch.incubate import moe as moe_mod
    seed(SEED + 186)
    layer = MoELayer(INC_D, num_experts=MOE_E, d_hidden=MOE_HIDDEN,
                     topk=MOE_K, capacity_factor=MOE_CAP).to(
        device, torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(SEED + 187)
    x = torch.randn(*MOE_TOKENS, device=device,
                    generator=gen).bfloat16().requires_grad_()

    def run():
        y = layer(x)
        ((y.float() ** 2).mean() + layer.l_aux.float()).backward()
        return y

    y = run()
    if not (torch.isfinite(y).all() and torch.isfinite(x.grad).all()):
        raise AssertionError("phase 18 (iii): non-finite bf16 MoE")
    ms = event_ms(run, 5)
    tokens = MOE_TOKENS[0] * MOE_TOKENS[1]
    log(f"phase 18 (iii) on {card}: MoELayer bf16 {MOE_E} experts of "
        f"{MOE_HIDDEN}, top-{MOE_K}, capacity "
        f"{math.ceil(tokens / MOE_E * MOE_CAP)} tokens an expert, on "
        f"{list(MOE_TOKENS)}: forward + backward {ms:.3f} ms (median of 5, "
        f"CUDA events), {tokens / ms * 1e3:.1f} tokens/s")
    del layer, x, y
    seed(SEED + 188)
    cpu = MoELayer(INC_D, num_experts=MOE_E, d_hidden=MOE_HIDDEN,
                   topk=MOE_K, capacity_factor=MOE_CAP)
    card_layer = copy.deepcopy(cpu).to(device)
    xc = torch.randn(*MOE_F32_TOKENS,
                     generator=torch.Generator().manual_seed(SEED + 189))
    orig = moe_mod.top_k
    seen = {}

    def record(probs, k):
        vals, idx = orig(probs, k)
        seen["probs"], seen["idx"] = probs.detach(), idx
        return vals, idx

    flips = []

    def take_card(probs, k):
        vals, idx = orig(probs, k)
        card_idx = seen["idx"].cpu()
        differ = (idx != card_idx).any(-1)
        for row in differ.nonzero().flatten().tolist():
            srt = probs[row].detach().sort(descending=True).values
            near = (srt[:k] - srt[1:k + 1]).min().item()
            if near > MOE_TIE:
                raise AssertionError(
                    f"phase 18 (iii): token {row} routed to "
                    f"{card_idx[row].tolist()} on the card and "
                    f"{idx[row].tolist()} on the CPU, not a near-tie "
                    f"(the smallest gap of its top {k + 1} {near:.3e})")
            flips.append((row, near))
        if flips:
            idx = torch.where(differ[:, None], card_idx, idx)
            vals = probs.gather(-1, idx)
        return vals, idx

    outs = []
    try:
        for net, dev, hook in ((card_layer, device, record),
                               (cpu, torch.device("cpu"), take_card)):
            moe_mod.top_k = hook
            xd = xc.to(dev).requires_grad_()
            y = net(xd)
            ((y * y).mean() + net.l_aux).backward()
            outs.append([t.detach().cpu() for t in
                         [y, net.l_aux, xd.grad] +
                         [p.grad for p in net.parameters()]])
    finally:
        moe_mod.top_k = orig
    probs = seen["probs"].float()
    srt = probs.sort(dim=-1, descending=True).values
    gap = (srt[:, :MOE_K] - srt[:, 1:MOE_K + 1]).min().item()
    names = ["out", "l_aux", "x.grad"] + [f"{n}.grad" for n, _ in
                                          cpu.named_parameters()]
    errs = {}
    for name, a, b in zip(names, outs[1], outs[0]):
        errs[name] = (b - a).abs().max().item() / max(
            a.abs().max().item(), 1e-30)
    worst = max(errs.values())
    if not worst <= MOE_TOL:
        raise AssertionError(f"phase 18 (iii) float32: card off the CPU "
                             f"{errs}, over {MOE_TOL}")
    log(f"phase 18 (iii) float32 on {list(MOE_F32_TOKENS)}: card against "
        f"CPU {json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})} "
        f"(limit {MOE_TOL}); the smallest gap between consecutive top-"
        f"{MOE_K + 1} probabilities {gap:.3e}; routing choices that "
        f"differed (near-ties the CPU took from the card): {len(flips)}")


def incubate_graph(device, card):
    """18 (iv): ``graph_send_recv`` (sum, mean, max, min) and the
    ``segment_*`` ops over a random graph of 100,000 nodes, 1,000,000
    edges and width 64 (float32), card against CPU: max/min exactly,
    sum/mean within ``REL_TOL[float32]`` of the largest value (the card
    adds each node's messages in another order); the causal masked
    softmax of bf16 ``[8, 12, 1024, 1024]`` scores, its first batch row
    against the CPU within ``SOFTMAX_TOL``; each timed on the card."""
    from paddle_tpu_torch import incubate
    g = torch.Generator().manual_seed(SEED + 190)
    x = torch.randn(GRAPH_NODES, GRAPH_WIDTH, generator=g)
    src = torch.randint(0, GRAPH_NODES, (GRAPH_EDGES,), generator=g)
    dst = torch.randint(0, GRAPH_NODES, (GRAPH_EDGES,), generator=g)
    seg = dst.sort().values
    xd, srcd, dstd, segd = (t.to(device) for t in (x, src, dst, seg))
    msgs = x[src]
    msgs_d = msgs.to(device)
    times, errs = {}, {}
    for pool in ("sum", "mean", "max", "min"):
        want = incubate.graph_send_recv(x, src, dst, pool_type=pool)
        got = incubate.graph_send_recv(xd, srcd, dstd, pool_type=pool)
        want_s = getattr(incubate, f"segment_{pool}")(msgs, seg)
        got_s = getattr(incubate, f"segment_{pool}")(msgs_d, segd)
        for name, a, b in ((f"graph_send_recv_{pool}", want, got),
                           (f"segment_{pool}", want_s, got_s)):
            b = b.cpu()
            if pool in ("max", "min"):
                ok = torch.equal(a, b)
                errs[name] = 0.0 if ok else float("nan")
            else:
                errs[name] = (a - b).abs().max().item() / \
                    a.abs().max().item()
                ok = errs[name] <= REL_TOL[torch.float32]
            if not ok:
                raise AssertionError(f"phase 18 (iv): {name} card against "
                                     f"CPU off ({errs[name]})")
        times[f"graph_send_recv_{pool}"] = event_ms(
            lambda: incubate.graph_send_recv(xd, srcd, dstd, pool_type=pool),
            5)
        times[f"segment_{pool}"] = event_ms(
            lambda: getattr(incubate, f"segment_{pool}")(msgs_d, segd), 5)
    scores = torch.randn(*SOFTMAX_SHAPE, device=device,
                         generator=torch.Generator(device=device).manual_seed(
                             SEED + 191)).bfloat16()
    probs = incubate.softmax_mask_fuse_upper_triangle(scores)
    want = incubate.softmax_mask_fuse_upper_triangle(scores[:1].cpu())
    sm_err = (probs[:1].cpu().float() - want.float()).abs().max().item()
    if not sm_err <= SOFTMAX_TOL:
        raise AssertionError(f"phase 18 (iv): the causal masked softmax "
                             f"off the CPU's by {sm_err}, over "
                             f"{SOFTMAX_TOL}")
    times["softmax_mask_fuse_upper_triangle"] = event_ms(
        lambda: incubate.softmax_mask_fuse_upper_triangle(scores), 5)
    log(f"phase 18 (iv): graph ops over {GRAPH_NODES} nodes, "
        f"{GRAPH_EDGES} edges, width {GRAPH_WIDTH}, card against CPU "
        f"{json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})} "
        f"(max/min exact, sum/mean limit {REL_TOL[torch.float32]}); the "
        f"causal masked softmax of bf16 {list(SOFTMAX_SHAPE)} off the "
        f"CPU's by {sm_err:.3e} on its first row (limit {SOFTMAX_TOL})")
    log(f"phase 18 (iv) on {card}: ms (median of 5, CUDA events) "
        f"{json.dumps({k: round(v, 4) for k, v in times.items()})}")


def incubate_rows(device, timer, dec_ln, enc, shapes):
    """The kernels line's ``_incubate`` rows: the LayerNorm forward at the
    decoder's bf16 ``[4096, 768]`` (its context stage) with its decode
    rows ``[8, 768]`` and the encoder's float32 ``[4096, 768]`` held too
    (``shape_errs``, ``shape_ms``), the backward at the encoder's float32
    ``[4096, 768]``, flash bf16 ``[32, 128, 12, 64]`` not causal, K8 over
    the encoder's list as its step hands it over; each with its launches
    in phase 18."""
    gen = torch.Generator(device=device).manual_seed(SEED + 192)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (scale * torch.randn(*shape, device=device,
                                    generator=gen)).to(dtype)

    d, rows = INC_D, ENC_BATCH * ENC_SEQ

    def ln_operands(n, dtype):
        return (randn(n, d, dtype=dtype), (1 + randn(d, scale=0.1)).to(
            dtype), randn(d, scale=0.1).to(dtype))

    ln_fwd = ln_fwd_case(timer, *ln_operands(INC_BATCH * INC_PROMPT,
                                             torch.bfloat16))
    extra = {"bf16 [8, 768]": ln_fwd_case(
        timer, *ln_operands(INC_BATCH, torch.bfloat16)),
        "f32 [4096, 768]": ln_fwd_case(timer, *ln_operands(
            rows, torch.float32))}
    ln_fwd["shape_errs"] = {k: r["max_abs_err"] for k, r in extra.items()}
    ln_fwd["shape_ms"] = {k: r["ms"] for k, r in extra.items()}
    x, g = randn(rows, d), randn(rows, d)
    ln_bwd = ln_bwd_case(timer, x, 1 + randn(d, scale=0.1), g)
    q, k, v, do = (randn(ENC_BATCH, ENC_SEQ, INC_HEADS, d // INC_HEADS,
                         dtype=torch.bfloat16) for _ in range(4))
    fa_fwd, fa_bwd = flash_case(timer, q, k, v, do, causal=False,
                                route="tc", core=True)
    adamw = adamw_step_case(timer, device, shapes, torch.bfloat16, ENC_LR,
                            ENC_WD)
    out = []
    for name, src, tpu, row, launches in (
            ("fused_layer_norm_incubate", LN_SRC, LN_TPU, ln_fwd,
             dec_ln + enc["fused_layer_norm"]),
            ("fused_layer_norm_bwd_incubate", LN_SRC, LN_BWD_TPU, ln_bwd,
             enc["fused_layer_norm_bwd"]),
            ("flash_attention_fwd_incubate", FA_TC_SRC, FA_FWD_TPU, fa_fwd,
             enc["flash_attention_fwd"]),
            ("flash_attention_bwd_incubate", FA_TC_SRC, FA_BWD_TPU, fa_bwd,
             enc["flash_attention_bwd"]),
            ("fused_adamw_step_incubate", ADAMW_SRC, ADAMW_TPU, adamw,
             enc["fused_adamw"])):
        log(f"phase 18 {name} {fmt(row)}")
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": tpu, "launches": launches,
                    "max_abs_err": max([row["max_abs_err"]] + list(
                        row.get("shape_errs", {}).values())),
                    "ms": row["ms"], "plain_ms": row["plain_ms"],
                    "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                    "library_ms": row["library_ms"]})
        for key in ("shape_errs", "shape_ms"):
            if key in row:
                out[-1][key] = row[key]
        if "core_ms" in row:
            out[-1].update(core_source=FA_SRC, core_ms=row["core_ms"],
                           core_err=row["core_err"])
        if "host_us" in row:
            out[-1].update({k: row[k] for k in STEP_KEYS},
                           launches_note=STEP_NOTE)
    return out


def incubate_encoder_witness(device):
    """18 (ii) witness: the encoder's first step, dropout off (``eval``),
    on (ii)'s batch, evaluated before and after the step. (a) The port's
    composed step (bf16 O2, 2:4 masks, ``asp.decorate(LookAhead(AdamW(
    multi_precision=True)))``) against ``torch.optim.AdamW`` over float32
    copies of a second, equal bf16 model's parameters and gradients,
    masked as ASP does: every master within ``ENC_WIT_MASTER_TOL``, at
    most a share ``ENC_WIT_MOVED`` of the entries over 1e-6 apart, the
    losses before and after the step within ``ENC_WIT_LOSS_TOL``. Logged beside it,
    the loss before and after the step of the same model in float32, no
    AMP, stepped by ``torch.optim.AdamW`` at (ii)'s learning rate and at
    a tenth of it: whether the jump after the first step is the model's
    and the recipe's, without ASP, LookAhead and the port's optimizer.
    Nothing here is counted on the main path."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.incubate import LookAhead, asp
    from paddle_tpu_torch.optimizer import AdamW
    gen = torch.Generator(device=device).manual_seed(SEED + 185)
    ids = torch.randint(0, ENC_VOCAB, (ENC_BATCH, ENC_SEQ), device=device,
                        generator=gen)
    labels = torch.randint(0, 2, (ENC_BATCH,), device=device, generator=gen)

    def loss_of(net, o2):
        with amp.auto_cast(enable=o2, level="O2", dtype="bfloat16"):
            return net(ids, labels)

    def evaluate(net, o2):
        with torch.no_grad():
            return loss_of(net, o2).item()

    def library_step(net, o2, masks, lr):
        """One ``torch.optim.AdamW`` step over float32 copies of ``net``'s
        parameters (masked as ``masks`` says), written back in their dtype
        and masked; returns the loss before and after and the float32
        values by name."""
        params = list(net.named_parameters())
        with torch.no_grad():
            for n, p in params:
                if n in masks:
                    p.mul_(masks[n])
        if o2 and any(not torch.equal(p, start[n]) for n, p in params):
            raise AssertionError("phase 18 (ii) witness: the twin model "
                                 "does not start from the port's weights")
        before = evaluate(net, o2)
        loss_of(net, o2).backward()
        copies = {n: p.detach().float().clone() for n, p in params}
        for n, p in params:
            copies[n].grad = p.grad.float()
        torch.optim.AdamW(list(copies.values()), lr=lr, betas=(0.9, 0.999),
                          eps=1e-8, weight_decay=ENC_WD,
                          foreach=False).step()
        with torch.no_grad():
            for n, p in params:
                if n in masks:
                    copies[n].mul_(masks[n])
                p.copy_(copies[n].to(p.dtype))
        return before, evaluate(net, o2), copies

    port = incubate_encoder_net(device)
    amp.decorate(port, level="O2", dtype="bfloat16")
    port.eval()
    asp.reset_excluded_layers()
    asp.prune_model(port)
    params = list(port.named_parameters())
    masks = {n: p._asp_mask for n, p in params
             if getattr(p, "_asp_mask", None) is not None}
    twin = incubate_encoder_net(device)
    amp.decorate(twin, level="O2", dtype="bfloat16")
    twin.eval()
    start = {n: p.detach().clone() for n, p in params}
    inner = AdamW(ENC_LR, parameters=params, weight_decay=ENC_WD,
                  multi_precision=True)
    opt = asp.decorate(LookAhead(inner, alpha=ENC_ALPHA, k=ENC_K))
    l0 = evaluate(port, True)
    loss_of(port, True).backward()
    opt.step()
    opt.clear_grad()
    l1 = evaluate(port, True)
    masters = inner._master_weights()
    t0, t1, ref = library_step(twin, True, masks, ENC_LR)
    gap = max((masters.get(id(p), p).float() - ref[n]).abs().max().item()
              for n, p in params)
    moved = sum(int(((masters.get(id(p), p).float() - ref[n]).abs()
                     > 1e-6).sum()) for n, p in params)
    entries = sum(p.numel() for _, p in params)
    del port, twin, inner, opt, masters, ref, start
    gc.collect()
    torch.cuda.empty_cache()
    f32 = incubate_encoder_net(device).eval()
    f0, f1, _ = library_step(f32, False, masks, ENC_LR)
    del f32
    slow = incubate_encoder_net(device).eval()
    s0, s1, _ = library_step(slow, False, masks, ENC_LR / 10)
    del slow
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 18 (ii) witness, dropout off: the port's step {l0:.5f} -> "
        f"{l1:.5f}; torch.optim.AdamW over float32 copies of the same bf16 "
        f"model {t0:.5f} -> {t1:.5f} (masters at most {gap:.3e} apart, "
        f"limit {ENC_WIT_MASTER_TOL:.3e}; {moved} of {entries} entries "
        f"over 1e-6, limit a share {ENC_WIT_MOVED}); float32 "
        f"model, torch.optim.AdamW lr {ENC_LR}: {f0:.5f} -> {f1:.5f}; lr "
        f"{ENC_LR / 10}: {s0:.5f} -> {s1:.5f}")
    if not (gap <= ENC_WIT_MASTER_TOL and moved <= ENC_WIT_MOVED * entries
            and all(abs(a - b) <= ENC_WIT_LOSS_TOL * max(1.0, abs(b))
                    for a, b in ((l0, t0), (l1, t1)))):
        raise AssertionError(f"phase 18 (ii) witness: the port's step off "
                             f"torch.optim.AdamW's: loss {l0} -> {l1} "
                             f"against {t0} -> {t1}, masters {gap:.3e} "
                             f"apart, {moved} of {entries} over 1e-6")


def phase_incubate(device, card, timer):
    """18: ``incubate`` on the card: (i) the ``FusedMultiTransformer``
    decoder served from its CacheKV (:func:`incubate_decoder`, float32
    card against CPU in :func:`incubate_decoder_f32`), (ii) the 2:4-pruned
    fused encoder trained under LookAhead with ModelAverage
    (:func:`incubate_encoder`, with (iv)'s ``CostModel``; its first step
    held against ``torch.optim.AdamW`` in
    :func:`incubate_encoder_witness`), (iii) MoE
    (:func:`incubate_moe`), (iv) the graph ops and the causal masked
    softmax (:func:`incubate_graph`). Returns the kernels line's
    ``_incubate`` rows."""
    t0 = time.perf_counter()
    dec_ln = incubate_decoder(device, card)
    incubate_decoder_f32(device)
    enc, shapes = incubate_encoder(device, card)
    incubate_encoder_witness(device)
    incubate_moe(device, card)
    incubate_graph(device, card)
    rows = incubate_rows(device, timer, dec_ln, enc, shapes)
    log(f"phase 18: {time.perf_counter() - t0:.1f} s")
    return rows


def check_nothing_left_running():
    """Every phase has stopped what it started: no ``device_prefetch``
    producer thread and no loader worker process is still alive (either
    would run on into the interpreter's teardown). Logs every thread
    still alive."""
    import multiprocessing
    gc.collect()
    threads = [t.name for t in threading.enumerate()
               if t is not threading.main_thread()]
    log(f"threads alive at the end: {threads or 'none'}")
    producers = [n for n in threads if "device_prefetch" in n]
    children = multiprocessing.active_children()
    assert not producers, f"device_prefetch producers alive: {producers}"
    assert not children, f"child processes alive: {children}"


def main() -> int:
    global TRACE_ROOT
    import shutil
    import tempfile
    faulthandler.enable()          # a fatal signal prints every stack
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from paddle_tpu_torch.ops import _build   # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    TRACE_ROOT = tempfile.mkdtemp(prefix="chip_smoke_traces_")
    try:
        return run_phases()
    finally:
        shutil.rmtree(TRACE_ROOT, ignore_errors=True)


def run_phases() -> int:
    from paddle_tpu_torch.ops import _build
    profile = "--profile" in sys.argv[1:]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = smi()
    log(card)
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
        f"{torch.version.cuda} nvcc '{nvcc[-1]}' device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(f"kernel build: {_build.build_all():.2f} s for {len(_build.SOURCES)} "
        f"sources into {_build.build_dir()}")
    sass_check()
    timer = Timer(device)
    phase_kernels(device, timer)
    phase_ln_routes(device)
    phase_quant_kernel(device, timer)
    train_main = phase_train_kernels(device, timer)
    model, prompts, outs, bf16_stats, launches, captured = phase_engine(
        device, profile)
    quant_launches, quant_captured, int8_outs = phase_engine_quant(
        model, prompts, outs, bf16_stats, profile)
    gen_launches, beam_launches = phase_generate(model, device, profile)
    gather_ln = phase_gather(model, prompts, outs, profile)
    spec = phase_spec(model, prompts, outs, int8_outs, profile)
    tier = phase_tier(model, profile)
    obs_serve = phase_observe_serve(model, prompts, outs)
    del model
    f16 = phase_serve_f16(device, prompts, profile)
    gen_f32_launches = phase_generate_f32(device)
    beam_f32_launches = phase_beam_f32(device)
    train_launches, train_cap = phase_train(device, profile)
    f32_launches = phase_f32_check(device)
    recipe = phase_recipe(device, card)
    fp16 = phase_fp16(device, card)
    phase_fp16_check(device)
    o1 = phase_o1(device, card)
    obs_train = phase_observe_train(device, card)
    phase_oom(device)
    _, tf_kernel_rows, swept = phase_transformer(device, card, timer)
    phase_resnet(device, card, swept)
    _, bert_kernel_rows, bert_ms = phase_bert(device, card, timer, profile)
    phase_text(device, card, swept, profile)
    deploy_launches, lenet_row = phase_deploy(device, timer)
    core = phase_core_api(device, card)
    legacy, legacy_served, legacy_row, legacy_ln = phase_legacy(
        device, card, timer, profile)
    serving_launches, serving_shapes = phase_serving(device, card)
    phase_vision(device, card)
    qat_rows = phase_quant(device, card, timer, bert_ms)
    incubate_rows_ = phase_incubate(device, card, timer)
    kernels = report_engine(device, timer, launches, captured,
                            quant_launches, quant_captured)
    # the engine row of the LayerNorm forward counts the fused engines'
    # runs (phase 3d's float32 ones too); its fused_layer_norm_train row,
    # the train path's
    kernels += serve_f16_rows(device, timer, f16)
    kernels += spec_rows(timer, spec)
    kernels += tier_rows(timer, tier)
    ln_row = next(k for k in kernels if k["name"] == "fused_layer_norm")
    ln_row["launches"] += quant_launches["fused_layer_norm"] \
        + gather_ln["fused"] + obs_serve["fused_layer_norm"]
    # phase 5 (i) serves phase 3's requests again (K1 at its shapes)
    rpa_row = next(k for k in kernels
                   if k["name"] == "ragged_paged_attention")
    rpa_row["launches"] += obs_serve["launches"]
    rpa_row["combine_launches"] += obs_serve["combine_launches"]
    check_train_operands(train_cap)
    # each row counts the paths that ran its kernel at its dtype: the bf16
    # tensor-core flash rows phase 4, the recipe and O1; the f32 LayerNorm
    # rows every AMP path (LayerNorm is on the black list); AdamW's rows
    # by (grad, copy) dtype
    counts = {
        "flash_attention_fwd": train_launches["flash_attention_fwd"]
        + recipe["flash_attention_fwd"] + o1["flash_attention_fwd"]
        + obs_train["flash_attention_fwd"] + core["flash_attention_fwd"],
        "flash_attention_bwd": train_launches["flash_attention_bwd"]
        + recipe["flash_attention_bwd"] + o1["flash_attention_bwd"]
        + obs_train["flash_attention_bwd"] + core["flash_attention_bwd"],
        "flash_attention_fwd_f32": f32_launches["flash_attention_fwd"],
        "flash_attention_bwd_f32": f32_launches["flash_attention_bwd"],
        "fused_layer_norm_train": sum(
            r["fused_layer_norm"] for r in (train_launches, recipe, fp16,
                                            o1, obs_train, core)),
        "fused_layer_norm_bwd": sum(
            r["fused_layer_norm_bwd"] for r in (train_launches, recipe,
                                                fp16, o1, obs_train, core)),
        "fused_adamw": train_launches["fused_adamw"]
        + recipe["fused_adamw"] + obs_train["fused_adamw"]
        + core["fused_adamw"],
        "flash_attention_fwd_f16": fp16["flash_attention_fwd"],
        "flash_attention_bwd_f16": fp16["flash_attention_bwd"],
        "fused_layer_norm_f16": 0,
        "fused_layer_norm_bwd_f16": 0,
        "fused_adamw_f16": fp16["fused_adamw"],
        "fused_adamw_f32": o1["fused_adamw"] + f32_launches["fused_adamw"],
        "fused_adamw_step": train_launches["fused_adamw"]}
    kernels += train_rows(counts, train_main)
    # the float32 runs' K2 launches join their path's row, their K4
    # launches (the CUDA-core route) the _f32 flash row
    kernels += generate_rows(device, timer, {
        "fused_layer_norm_generate": gen_launches["fused_layer_norm"]
        + gen_f32_launches["fused_layer_norm"],
        "fused_layer_norm_beam": beam_launches["fused_layer_norm"]
        + beam_f32_launches["fused_layer_norm"],
        "fused_layer_norm_gather": gather_ln["gather"],
        "flash_attention_fwd": gen_launches["flash_attention_fwd"]
        + beam_launches["flash_attention_fwd"]})
    f32_fwd = next(k for k in kernels
                   if k["name"] == "flash_attention_fwd_f32")
    f32_fwd["launches"] += gen_f32_launches["flash_attention_fwd"] \
        + beam_f32_launches["flash_attention_fwd"]
    kernels += tf_kernel_rows
    # phase 12 serves BERT-base at phase 10's shapes: its launches join
    # the _bert rows of the LayerNorm and flash forward; phase 14 trains
    # and serves it through a fluid program (its head's LayerNorm at
    # [32, 768] with them): its launches join all four
    for row in bert_kernel_rows:
        for name, count in (("fused_layer_norm_bert", "fused_layer_norm"),
                            ("flash_attention_fwd_bert",
                             "flash_attention_fwd")):
            if row["name"] == name:
                row["launches"] += deploy_launches[count] \
                    + legacy_served[count]
        for name, count in (("fused_layer_norm_bert", "fused_layer_norm"),
                            ("fused_layer_norm_bwd_bert",
                             "fused_layer_norm_bwd"),
                            ("flash_attention_fwd_bert",
                             "flash_attention_fwd"),
                            ("flash_attention_bwd_bert",
                             "flash_attention_bwd")):
            if row["name"] == name:
                row["launches"] += legacy[count]
        # phase 14's LayerNorm shapes (the head's [32, 768] with the
        # body's), each held against the plain version there
        for name, count in (("fused_layer_norm_bert", "fused_layer_norm"),
                            ("fused_layer_norm_bwd_bert",
                             "fused_layer_norm_bwd")):
            if row["name"] == name:
                row["legacy_shape_errs"] = legacy_ln[count]
                row["max_abs_err"] = max(row["max_abs_err"],
                                         *legacy_ln[count].values())
    kernels += bert_kernel_rows
    kernels.append(lenet_row)
    kernels.append(legacy_row)
    kernels += serving_rows(timer, serving_launches, serving_shapes)
    kernels += qat_rows
    kernels += incubate_rows_
    check_nothing_left_running()
    for k in kernels:
        for key, v in k.items():
            if isinstance(v, float) and not math.isfinite(v):
                raise AssertionError(f"{k['name']}: {key} = {v}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
