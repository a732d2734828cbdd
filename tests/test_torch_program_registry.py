"""The program registry and the trace probe of the port
(``framework/program_registry.py``, ``framework/trace_probe.py``)
against the JAX package on the CPU.

* ``peak_flops``: the card's data-sheet dense 16-bit peak by device name
  (989 TFLOP/s for the H100 SXM), the ``PADDLE_TPU_PEAK_FLOPS`` override,
  and ``None`` on the CPU as in the JAX function;
* ``note_compile`` gives the JAX record and counters for the same calls;
  a build of the host C++ recorder is noted as one;
* ``model_flops_per_token`` of a tiny engine (fused, paged gather and
  dense gather) lies within ``FLOPS_TOL`` = 15% of the JAX engine's on
  the same schedule. The port counts the matmuls and the attention the
  bucket's shapes read; XLA's ``cost_analysis`` also counts elementwise
  work and the masked attention it pads to. Measured: +3.4% (fused),
  -9.1% (paged gather), -9.4% (dense gather);
* the trace probe classifies a scripted sequence of signatures into the
  JAX probe's causes and counters, and a served engine builds each of
  its buckets once, under the JAX engine's site names;
* ``fit`` observes ``hapi/flops_per_sec`` and, with a peak, ``hapi/mfu``.
"""
import re

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.framework import monitor as jmon
from paddle_tpu.framework import program_registry as jreg
from paddle_tpu.framework import trace_probe as jprobe
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu.nn.layer.layers import get_params_tree
from paddle_tpu.serving import GenerationEngine as JaxEngine
import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import gpt_from_jax_params
from paddle_tpu_torch.framework import monitor as tmon
from paddle_tpu_torch.framework import program_registry as treg
from paddle_tpu_torch.framework import trace_probe as tprobe
from paddle_tpu_torch.hapi import Model
from paddle_tpu_torch.models import GPTConfig
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving import GenerationEngine

FLOPS_TOL = 0.15


def test_peak_flops_table_and_override(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_PEAK_FLOPS", raising=False)
    assert treg.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert treg.peak_flops("NVIDIA H100 PCIe") == 756e12
    assert treg.peak_flops("NVIDIA A100-SXM4-80GB") is None
    assert treg.peak_flops() is None == jreg.peak_flops()   # the CPU
    monkeypatch.setenv("PADDLE_TPU_PEAK_FLOPS", "1.5e12")
    assert treg.peak_flops() == jreg.peak_flops() == 1.5e12
    assert treg.peak_flops("NVIDIA H100 80GB HBM3") == 1.5e12
    for bad in ("junk", "-3"):
        monkeypatch.setenv("PADDLE_TPU_PEAK_FLOPS", bad)
        assert treg.peak_flops() is None == jreg.peak_flops()


def test_note_compile_gives_the_jax_record_and_counters():
    out = []
    for reg, mon in ((treg, tmon), (jreg, jmon)):
        c0 = mon.stat_get("compile/count")
        reg.note_compile("test/site", 12.5)
        rec = reg.note_compile("test/site", 7.5, eqns=3,
                               analysis={"flops": 100.0, "temp_bytes": 8})
        h = mon.stat_histogram("compile/ms/test/site")
        out.append((rec.as_dict(), mon.stat_get("compile/count") - c0,
                    h["count"], h["sum"], reg.get("test/site") is rec,
                    reg.snapshot()["test/site"]))
        reg.reset()
        mon.stat_reset("compile/ms/test/site")
    assert out[0] == out[1]
    assert out[0][0]["compiles"] == 2 and out[0][0]["flops"] == 100.0


def test_note_cost_moves_no_compile_counter():
    c0 = tmon.stat_get("compile/count")
    rec = treg.note_cost("test/cost", flops=5.0, bytes_accessed=7.0)
    assert (rec.flops, rec.bytes_accessed, rec.compiles) == (5.0, 7.0, 0)
    assert tmon.stat_get("compile/count") == c0
    treg.reset()


def test_a_host_build_is_noted_as_a_compile(tmp_path, monkeypatch):
    from paddle_tpu_torch.ops import _build
    monkeypatch.setenv("PADDLE_TPU_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_libs", {})
    c0 = tmon.stat_get("compile/count")
    try:
        lib = _build.load_host(
            "tpu_prof", _build._CSRC.parent.parent / "native" / "tpu_prof.cc")
    except RuntimeError as e:
        pytest.skip(f"no host C++ toolchain: {e}")
    assert hasattr(lib, "tp_begin")
    assert tmon.stat_get("compile/count") == c0 + 1
    assert treg.get("tpu_prof.cc").compiles >= 1
    assert list(tmp_path.glob("tpu_prof-*.so"))
    _build.load_host("tpu_prof", _build._CSRC.parent.parent / "native"
                     / "tpu_prof.cc")          # loaded: no second build
    assert tmon.stat_get("compile/count") == c0 + 1


def test_gpt_step_cost_counts_the_matmuls_and_the_attention():
    cfg = GPTConfig(vocab_size=100, hidden_size=8, num_hidden_layers=2,
                    num_attention_heads=2, intermediate_size=32,
                    max_position_embeddings=16)
    c = treg.gpt_step_cost(cfg, rows=3, key_reads=10, head_rows=2,
                           param_bytes=4, kv_bytes=2, kv_rows_read=5,
                           kv_rows_written=3)
    per_row = 2 * (4 * 64 + 2 * 8 * 32)
    assert c["flops"] == 2 * (per_row * 3 + 4 * 8 * 10) + 2 * 8 * 100 * 2
    n_params = 2 * (4 * 64 + 2 * 8 * 32) + 100 * 8 + 16 * 8
    assert c["bytes_accessed"] == n_params * 4 + 2 * 2 * 8 * 2 * 8
    assert treg.gpt_step_cost(cfg, 3, 10, 2, train=True)["flops"] == \
        3 * c["flops"]


SCRIPT = [  # (signature, static) -> the JAX probe's cause
    ((((2, 3), "float32"), ((4,), "int32")), {"bucket": 8}),
    ((((2, 3), "float32"), ((8,), "int32")), {"bucket": 8}),       # shape
    ((((2, 3), "bfloat16"), ((8,), "int32")), {"bucket": 8}),      # dtype
    ((((2, 3), "bfloat16"),), {"bucket": 8}),                  # structure
    ((((2, 3), "bfloat16"),), {"bucket": 16}),                # static_arg
    ((((2, 3), "bfloat16"),), {"bucket": 16}),                   # rebuild
    ((((2, 3), "bfloat16"),), {"frozen_set": ("a",)}),        # static_arg
    ((((2, 3), "bfloat16"),), {"frozen_set": ("b",)}),        # frozen_set
]


def test_trace_probe_gives_the_jax_causes():
    outs = []
    for probe, mon in ((tprobe, tmon), (jprobe, jmon)):
        c0 = {k: v for k, v in mon.all_stats().items()
              if k.startswith("dispatch/retrace_cause")}
        site = probe.site("test/probe/script")
        causes = [site.record(sig, static) for sig, static in SCRIPT]
        snap = probe.snapshot()["test/probe/script"]
        c1 = {k: v - c0.get(k, 0) for k, v in mon.all_stats().items()
              if k.startswith("dispatch/retrace_cause")}
        outs.append((causes, snap, {k: v for k, v in c1.items() if v}))
        probe.reset()
        assert probe.snapshot()["test/probe/script"]["traces"] == 0
    assert outs[0] == outs[1]
    assert outs[0][0] == [None, "shape", "dtype", "structure",
                          "static_arg", "rebuild", "static_arg",
                          "frozen_set"]


def test_sig_of_names_dtypes_as_the_jax_package():
    import torch
    got = tprobe.sig_of([torch.zeros(2, 3, dtype=torch.bfloat16),
                         ((4,), torch.int32), ((1, 2), "bool")])
    assert got == (((2, 3), "bfloat16"), ((4,), "int32"), ((1, 2), "bool"))


def _models():
    paddle.seed(21)
    jcfg = JaxGPTConfig(vocab_size=96, hidden_size=64, num_hidden_layers=2,
                        num_attention_heads=4, intermediate_size=128,
                        max_position_embeddings=64, hidden_dropout_prob=0.0,
                        attention_dropout_prob=0.0)
    jmodel = JaxGPT(jcfg)
    jmodel.eval()
    params = {k: np.asarray(v) for k, v in get_params_tree(jmodel).items()}
    cfg = GPTConfig(**{k: getattr(jcfg, k) for k in (
        "vocab_size", "hidden_size", "num_hidden_layers",
        "num_attention_heads", "intermediate_size",
        "max_position_embeddings", "hidden_dropout_prob",
        "attention_dropout_prob")})
    return jmodel, gpt_from_jax_params(params, cfg, device="cpu").eval()


LAYOUTS = {"fused": dict(kv_layout="paged", attention="fused",
                         block_size=16),
           "paged_gather": dict(kv_layout="paged", attention="gather",
                                block_size=8),
           "dense_gather": dict(kv_layout="dense", attention="gather")}


def _serve(eng):
    outs = [eng.submit(p, max_new_tokens=n).result(timeout=300)
            for p, n in ((np.arange(1, 20), 6), (np.arange(30, 41), 4))]
    stats = eng.stats()
    sites = {k: v for k, v in (tprobe if isinstance(
        eng, GenerationEngine) else jprobe).snapshot().items()
        if k.endswith(f"#{eng._eid}")}
    eng.close()
    return outs, stats, sites


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_model_flops_per_token_tracks_the_jax_engine(layout, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PEAK_FLOPS", "1e12")
    jmodel, tmodel = _models()
    kw = dict(num_slots=4, max_len=64, prefill_budget=16, **LAYOUTS[layout])
    want, jstats, jsites = _serve(JaxEngine(jmodel, **kw))
    got, stats, sites = _serve(GenerationEngine(tmodel, device="cpu", **kw))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    ratio = stats["model_flops_per_token"] / jstats["model_flops_per_token"]
    assert abs(ratio - 1) < FLOPS_TOL, ratio
    for k in ("decode_tokens_per_sec", "serving_flops_per_sec",
              "serving_mfu", "decode_bytes_per_token"):
        assert stats[k] > 0, k
    assert stats["serving_mfu"] == pytest.approx(
        stats["serving_flops_per_sec"] / 1e12)
    # the same buckets under the JAX engine's site names, each built once
    norm = lambda d: sorted(re.sub(r"#\d+$", "", k) for k in d)  # noqa
    assert norm(sites) == norm(jsites) and sites
    assert all(v == {"traces": 1, "causes": {}} for v in sites.values())


def test_fit_observes_flops_per_sec_and_mfu(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PEAK_FLOPS", "1e12")
    pt.seed(0)
    from paddle_tpu_torch.models import GPTForPretraining
    net = GPTForPretraining(GPTConfig.tiny())
    m = Model(net, inputs=["ids", "labels"], device="cpu")
    m.prepare(AdamW(1e-3, parameters=net.parameters()),
              loss=lambda loss, logits: loss)
    logs = []

    class Keep(pt.callbacks.Callback):
        def on_train_batch_end(self, step, l=None):
            logs.append(dict(l or {}))
    n0 = (tmon.stat_histogram("hapi/mfu") or {"count": 0})["count"]
    ids = np.random.RandomState(0).randint(0, 256, (6, 16))
    m.fit(pt.io.TensorDataset([ids, ids]), batch_size=2, log_freq=1,
          verbose=0, callbacks=[Keep()])
    h = tmon.stat_histogram("hapi/mfu")
    assert h["count"] - n0 == 3 and h["max"] > 0
    assert tmon.stat_histogram("hapi/flops_per_sec")["max"] > 0
    assert all("mfu" in log for log in logs)
    flops = treg.gpt_step_cost(GPTConfig.tiny(), 32, 2 * 16 * 17 // 2, 32,
                               train=True)["flops"]
    assert m._step_flops == {(2, 16): flops}
