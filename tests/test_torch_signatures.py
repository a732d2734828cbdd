"""The port's public callables take the JAX package's parameters.

For every module of ``paddle_tpu_torch`` whose path also names a module
of ``paddle_tpu``, each public name that both define (a function or a
class: its constructor and each public method both classes have) is held
by ``inspect.signature`` to one rule: every call that binds to the
reference binds the same way to the port. So the reference's positional
parameters open the port's, with the same names and kinds, in order; its
keyword-only parameters are keyword parameters of the port; a default the
reference has, the port has too, and equal where it is a plain value
(None, a number, a string, or a tuple of them); its ``*args``/``**kwargs``
the port takes as well. The port may add parameters with defaults after
them (``device=``, keyword-only, is the common one) and may give a default
where the reference has none.

The exemptions, each a reference parameter the port leaves out:

* the kernel wrappers' ``block_q``: the ragged attention kernel's row
  block is fixed at 8 on the card (``ops/ragged_paged_attention.py``);
* ``register_op``'s (and its ``OpDef``'s) ``nondiff``/``jit``: the port's
  ops run eagerly under torch autograd, with no jit and no
  non-differentiable marking to choose.

Where the port has no behaviour for a parameter it takes, a value other
than the default raises ``NotImplementedError`` naming its ROADMAP
Queue 1 item, never ``TypeError``; ``test_parameters_without_behaviour_
raise_not_implemented`` calls each of them. The parameters a slice gave
behaviour move to ``test_ported_parameters_have_behaviour``, which holds
what each now does.
"""
import importlib
import inspect
import pkgutil

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt

P = inspect.Parameter
_POSITIONAL = (P.POSITIONAL_ONLY, P.POSITIONAL_OR_KEYWORD)
#: (the port object's module.qualname, reference parameters it leaves out)
EXEMPT = {
    "paddle_tpu_torch.ops.ragged_paged_attention.ragged_paged_attention":
        {"block_q"},
    "paddle_tpu_torch.ops.registry.register_op": {"nondiff", "jit"},
    "paddle_tpu_torch.ops.registry.OpDef": {"nondiff", "jit"},
}

MODULES = ["paddle_tpu_torch"] + sorted(
    m.name for m in pkgutil.walk_packages(pt.__path__, "paddle_tpu_torch."))


def _reference(module_name):
    try:
        return importlib.import_module(
            "paddle_tpu" + module_name[len("paddle_tpu_torch"):])
    except ImportError:
        return None


def _plain(v):
    return v is None or isinstance(v, (bool, int, float, str)) or (
        isinstance(v, tuple) and all(_plain(x) for x in v))


def _default_problem(port, ref):
    if ref.default is P.empty:
        return None                     # the port may give one
    if port.default is P.empty:
        return f"{ref.name}: the reference's default {ref.default!r} is " \
               f"missing"
    a, b = port.default, ref.default
    if _plain(a) and _plain(b) and not (
            a == b and isinstance(a, bool) == isinstance(b, bool)):
        return f"{ref.name}: default {a!r}, the reference's {b!r}"
    return None


def signature_problems(port_fn, ref_fn, exempt=()):
    """What keeps a call that binds to ``ref_fn`` from binding the same
    way to ``port_fn`` (an empty list when nothing does)."""
    try:
        port, ref = inspect.signature(port_fn), inspect.signature(ref_fn)
    except (TypeError, ValueError):
        return []                       # a builtin without a signature
    refs = [r for r in ref.parameters.values() if r.name not in exempt]
    ports = list(port.parameters.values())
    problems = []
    rpos = [r for r in refs if r.kind in _POSITIONAL]
    ppos = [p for p in ports if p.kind in _POSITIONAL]
    for i, r in enumerate(rpos):
        p = ppos[i] if i < len(ppos) else None
        if p is None or (p.name, p.kind) != (r.name, r.kind):
            problems.append(f"positional {i}: {p} where the reference has "
                            f"{r}")
        else:
            problems.append(_default_problem(p, r))
    for r in refs:
        if r.kind == P.KEYWORD_ONLY:
            p = port.parameters.get(r.name)
            if p is None or p.kind not in (P.KEYWORD_ONLY,
                                           P.POSITIONAL_OR_KEYWORD):
                problems.append(f"keyword {r.name} is missing")
            else:
                problems.append(_default_problem(p, r))
        elif r.kind in (P.VAR_POSITIONAL, P.VAR_KEYWORD) and not any(
                p.kind == r.kind for p in ports):
            problems.append(f"{r} is missing")
    names = {r.name for r in ref.parameters.values()}
    for p in ports:
        if p.name not in names and p.default is P.empty \
                and p.kind not in (P.VAR_POSITIONAL, P.VAR_KEYWORD):
            problems.append(f"the port's {p} has no default")
    return [x for x in problems if x]


def _shared(module_name):
    """(label, port callable, reference callable, exemptions) for every
    public name the port module defines and its reference module has."""
    mod, ref = importlib.import_module(module_name), _reference(module_name)
    if ref is None:
        return []
    names = getattr(mod, "__all__", None) or [
        n for n in vars(mod) if not n.startswith("_")]
    out = []
    for n in names:
        obj, robj = getattr(mod, n, None), getattr(ref, n, None)
        if not (callable(obj) and callable(robj)):
            continue
        key = f"{getattr(obj, '__module__', '')}." \
              f"{getattr(obj, '__qualname__', n)}"
        out.append((f"{module_name}.{n}", obj, robj, EXEMPT.get(key, ())))
        if inspect.isclass(obj) and inspect.isclass(robj):
            for m, f in vars(obj).items():
                rf = getattr(robj, m, None)
                if not m.startswith("_") and callable(f) and callable(rf):
                    out.append((f"{module_name}.{n}.{m}", getattr(obj, m),
                                rf, EXEMPT.get(f"{key}.{m}", ())))
    return out


@pytest.mark.parametrize("module_name", MODULES)
def test_shared_names_take_the_reference_parameters(module_name):
    bad = {label: problems for label, obj, robj, exempt in
           _shared(module_name)
           if (problems := signature_problems(obj, robj, exempt))}
    assert not bad, bad


def test_the_sweep_sees_the_repaired_names():
    """The sweep reaches the callables this rule was written for."""
    seen = {label for m in MODULES for label, *_ in _shared(m)}
    for label in ("paddle_tpu_torch.nn.Linear", "paddle_tpu_torch.nn.LayerNorm",
                  "paddle_tpu_torch.nn.functional.cross_entropy",
                  "paddle_tpu_torch.nn.functional.dropout",
                  "paddle_tpu_torch.nn.Dropout",
                  "paddle_tpu_torch.nn.MultiHeadAttention",
                  "paddle_tpu_torch.hapi.Model.train_batch",
                  "paddle_tpu_torch.amp.decorate",
                  "paddle_tpu_torch.optimizer.Optimizer.minimize",
                  "paddle_tpu_torch.serving.GenerationEngine",
                  "paddle_tpu_torch.serving.GenerationEngine.submit",
                  "paddle_tpu_torch.io.DataLoader",
                  "paddle_tpu_torch.matmul"):
        assert label in seen, label


@pytest.mark.parametrize("key", sorted(EXEMPT))
def test_each_exemption_is_still_needed(key):
    """Every exempted parameter is one the reference has and the port
    lacks, so the list cannot outlive its reasons."""
    mod_name, _, name = key.rpartition(".")
    obj = getattr(importlib.import_module(mod_name), name)
    ref = getattr(_reference(mod_name), name)
    port_names = set(inspect.signature(obj).parameters)
    ref_names = set(inspect.signature(ref).parameters)
    for p in EXEMPT[key]:
        assert p in ref_names and p not in port_names, (key, p)


def test_the_rule_catches_what_the_sweep_once_found():
    """The comparison itself: a parameter bound to another name, a lost
    default, a missing keyword."""
    def ref(x, y, weight=None, *, lane="a"):
        pass

    def shifted(x, y, ignore_index=-100, *, lane="a"):
        pass

    def no_lane(x, y, weight=None):
        pass

    def lost_default(x, y, weight, *, lane="a"):
        pass

    def extra(x, y, weight=None, extra=1, *, lane="a", device=None):
        pass

    assert signature_problems(shifted, ref)
    assert signature_problems(no_lane, ref)
    assert signature_problems(lost_default, ref)
    assert signature_problems(extra, ref) == []
    assert signature_problems(ref, ref) == []


def _gpt():
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    pt.seed(0)
    return GPTForPretraining(GPTConfig.tiny())


def _not_ported_calls():
    from paddle_tpu_torch import amp, nn, vision
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.serving import GenerationEngine, PagedKVPool

    def engine(**kw):
        return GenerationEngine(_gpt(), device="cpu", **kw)

    def model():
        net = nn.Linear(4, 2, device="cpu")
        m = Model(net, device="cpu")
        m.prepare(SGD(0.1, parameters=net.parameters()),
                  loss=lambda out, y: out.sum())
        return m

    def minimize(**kw):
        p = torch.nn.Parameter(torch.ones(2))
        SGD(0.1, parameters=[p]).minimize((p * p).sum(), **kw)

    return {
        "pool mesh": lambda: PagedKVPool(1, 1, 1, 16, 8, block_size=8,
                                         mesh=object(), device="cpu"),
        "train_batch update": lambda: model().train_batch(
            [torch.ones(3, 4)], [torch.ones(3, 2)], update=False),
        "evaluate prefetch": lambda: model().evaluate(
            pt.io.TensorDataset([np.ones((2, 4), np.float32),
                                 np.ones((2, 2), np.float32)]),
            prefetch=True),
        "minimize startup_program": lambda: minimize(
            startup_program=object()),
        "minimize parameters": lambda: minimize(parameters=[]),
        "resnet50 pretrained": lambda: vision.models.resnet50(
            pretrained=True),
        "margin_cross_entropy group": lambda:
            nn.functional.margin_cross_entropy(
                torch.zeros(2, 3), torch.zeros(2, dtype=torch.long),
                group=object()),
        "vision datasets": lambda: vision.datasets,
        "decorate is accepted": None,
    }


@pytest.mark.parametrize("what", sorted(_not_ported_calls()))
def test_parameters_without_behaviour_raise_not_implemented(what):
    call = _not_ported_calls()[what]
    if call is None:
        # accepted and, as in the JAX package, without effect
        from paddle_tpu_torch import amp
        net = torch.nn.Linear(2, 2)
        assert amp.decorate(net, level="O2", master_weight=True,
                            save_dtype="float32") is net
        assert net.weight.dtype == torch.bfloat16
        return
    with pytest.raises(NotImplementedError, match="Queue 1 item"):
        call()


def _ported_checks():
    """The parameters that raised ``NotImplementedError`` until their
    slice was ported (ROADMAP Queue 1 item 2, the serving periphery, item
    3, observability, and item 6, the op library and ``nn``: the pools'
    ``return_mask``, ``ctc_loss`` and the conv layers since its second
    part, the ``sequence_*`` functions since its last; item 5's deployment
    slice: ``DataLoader``'s static-mode arguments and ``minimize`` in
    static mode), each with a check of what it does now."""
    from paddle_tpu.hapi.callbacks import ProfilerCallback as JaxCallback
    from paddle_tpu.serving.scheduler import Scheduler as JaxScheduler
    from paddle_tpu_torch.framework import trace_probe
    from paddle_tpu_torch.hapi.callbacks import ProfilerCallback
    from paddle_tpu_torch.models import generation as gen
    from paddle_tpu_torch.serving import GenerationEngine, HostBlockPool
    from paddle_tpu_torch.serving.kv_pool import KVCachePool
    from paddle_tpu_torch.serving.scheduler import Scheduler

    def engine(**kw):
        return GenerationEngine(_gpt(), device="cpu", **kw)

    def lane_weights():
        with engine(lane_weights={"batch": 2.5}) as eng:
            assert eng._sched._lane_weights == {"interactive": 4.0,
                                                "batch": 2.5}
        with pytest.raises(ValueError, match="lane weight"):
            engine(lane_weights={"batch": 0})

    def submit(key, value):
        with engine() as eng:
            h = eng.submit(np.arange(4), max_new_tokens=2, **{key: value})
            assert len(h.result(timeout=60)) == 6
            assert getattr(h, key) == getattr(h.trace, key) == value

    def host_tier():
        with engine(kv_layout="paged", block_size=8,
                    host_tier_bytes=1 << 20) as eng:
            tier = eng._pool.host_tier
            assert isinstance(tier, HostBlockPool)
            assert tier.capacity_bytes == 1 << 20
            assert eng.stats()["host_tier"]["capacity_bytes"] == 1 << 20
        assert not tier._spiller.is_alive()
        with pytest.raises(ValueError, match="kv_layout='paged'"):
            engine(host_tier_bytes=1 << 20)

    def scheduler():
        pool = KVCachePool(1, 1, 1, 16, 8, min_bucket=8, device="cpu")
        sched = Scheduler(pool, lambda *a: 1, lambda *a: None,
                          lane_weights={"batch": 1.0, "bulk": 0.5})
        ref = JaxScheduler(pool, lambda *a: 1, lambda *a: None,
                           lane_weights={"batch": 1.0, "bulk": 0.5})
        try:
            assert sched._lane_weights == ref._lane_weights
        finally:
            sched.close()
            ref.close()

    def profiler_callback():
        kw = dict(start_step=0, stop_step=3, chrome_trace_path="t.json",
                  prometheus_path="p.txt", summary=False, verbose=0)
        got, want = ProfilerCallback(**kw), JaxCallback(**kw)
        for k in kw:
            assert getattr(got, k) == getattr(want, k), k
        for cls in (ProfilerCallback, JaxCallback):
            with pytest.raises(ValueError, match="stop_step > start_step"):
                cls(start_step=2, stop_step=2)

    def debug_logits():
        model = _gpt().eval()
        S, T, bs = 2, 2, 8
        cfg = model.gpt.cfg
        H = cfg.num_attention_heads
        pool = torch.zeros(cfg.num_hidden_layers, 2, 5, H, bs,
                           cfg.hidden_size // H)
        args = (torch.tensor([3, 4], dtype=torch.int32),
                torch.tensor([0, 2], dtype=torch.int32),
                torch.zeros(2, dtype=torch.int32),
                torch.tensor([[1, 0], [2, 0]], dtype=torch.int32),
                torch.zeros(2, dtype=torch.bool), torch.ones(2),
                torch.Generator().manual_seed(0))
        nxt, logits = gen.build_paged_decode_fn(
            model, S, T, bs, debug_logits=True)(pool.clone(), *args)
        plain = gen.build_paged_decode_fn(model, S, T, bs)(pool.clone(),
                                                           *args)
        assert logits.shape == (S, cfg.vocab_size)
        assert logits.dtype == torch.float32
        assert torch.equal(nxt, plain)
        assert torch.equal(nxt[:S].long(), logits.argmax(-1))

    def probes():
        model = _gpt()
        builds = {
            "slot_prefill": lambda p: gen.build_slot_prefill_fn(
                model, 8, 16, probe=p),
            "slot_decode": lambda p: gen.build_slot_decode_fn(
                model, 2, 16, probe=p),
            "paged_prefill": lambda p: gen.build_paged_prefill_fn(
                model, 16, 8, probe=p),
            "paged_decode": lambda p: gen.build_paged_decode_fn(
                model, 2, 2, 8, probe=p),
            "fused": lambda p: gen.build_fused_step_fn(
                model, 2, 8, 2, 16, probe=p),
            "spec": lambda p: gen.build_spec_verify_fn(
                model, 2, 8, 2, 2, 16, probe=p),
            "draft_prefill": lambda p: gen.build_draft_prefill_fn(
                model, 8, 16, probe=p),
            "draft_propose": lambda p: gen.build_draft_propose_fn(
                model, 2, 16, probe=p),
            "draft_scan": lambda p: gen.build_draft_propose_scan_fn(
                model, 2, 16, 2, probe=p)}
        for name, build in builds.items():
            site = trace_probe.site(f"test/probe/{name}")
            build(site)
            assert site.traces == 1 and site.causes == {}, name
            build(site)                  # the same bucket built again
            assert site.causes == {"rebuild": 1}, name
            build(None)                  # no probe: nothing recorded
            assert site.traces == 2, name

    def need_weights():
        from paddle_tpu_torch import nn
        pt.seed(0)
        attn = nn.MultiHeadAttention(8, 2, need_weights=True)
        x = torch.randn(2, 5, 8)
        out, weights = attn(x)
        assert weights.shape == (2, 2, 5, 5)
        torch.testing.assert_close(weights.sum(-1), torch.ones(2, 2, 5))
        attn.need_weights = False
        torch.testing.assert_close(attn(x), out)

    def initializer():
        from paddle_tpu_torch import nn
        init = nn.initializer.Constant(0.5)
        for attr in (nn.ParamAttr(initializer=init), init):
            lin = nn.Linear(4, 8, attr, device="cpu")
            assert lin.weight.shape == (8, 4)
            assert torch.equal(lin.weight, torch.full((8, 4), 0.5))
            assert not lin.bias.any()

    def return_mask():
        from paddle_tpu_torch import nn
        x = torch.arange(16.0).reshape(1, 1, 4, 4)
        out, mask = nn.functional.max_pool2d(x, 2, return_mask=True)
        assert out.flatten().tolist() == [5.0, 7.0, 13.0, 15.0]
        assert mask.dtype == torch.int32
        assert mask.flatten().tolist() == [5, 7, 13, 15]

    def adaptive_mask():
        from paddle_tpu_torch import nn
        out, mask = nn.functional.adaptive_max_pool1d(
            torch.tensor([[[1.0, 3.0, 2.0, 0.0]]]), 2, return_mask=True)
        assert out.tolist() == [[[3.0, 2.0]]]
        assert mask.tolist() == [[[1, 2]]]

    def ctc_loss():
        from paddle_tpu_torch import nn
        # one frame, one label: the loss is -log p(label)
        lp = torch.log(torch.tensor([[[0.25, 0.75]]]))
        loss = nn.functional.ctc_loss(lp, torch.tensor([[1]]),
                                      torch.tensor([1]), torch.tensor([1]),
                                      reduction="none")
        torch.testing.assert_close(loss, -lp[0, :, 1])

    def sequence_pad():
        from paddle_tpu_torch import nn
        out = nn.functional.sequence_pad(
            torch.arange(5.0)[:, None], torch.tensor([2, 3]), pad_value=-1.0,
            maxlen=3)
        assert out[..., 0].tolist() == [[0.0, 1.0, -1.0], [2.0, 3.0, 4.0]]

    def conv2d_layer():
        from paddle_tpu_torch import nn
        conv = nn.Conv2D(2, 3, 3, padding=1, data_format="NHWC")
        assert tuple(conv.weight.shape) == (3, 2, 3, 3)
        assert conv(torch.zeros(1, 5, 5, 2)).shape == (1, 5, 5, 3)

    def data_loader_static():
        batches = [pt.io.DataLoader([1, 2, 3], batch_size=2, **kw)
                   for kw in ({}, dict(feed_list=[object()], places=[
                       pt.CPUPlace()], return_list=False))]
        assert [list(map(torch.Tensor.tolist, (b for b in loader)))
                for loader in batches] == [[[1, 2], [3]]] * 2

    def minimize_static():
        from paddle_tpu_torch import static
        from paddle_tpu_torch.optimizer import SGD
        old = pt.get_device()
        pt.set_device("cpu")
        main = static.Program()
        try:
            with static.program_guard(main):
                x = static.data("x", [None, 2])
                p = torch.nn.Parameter(torch.ones(2))
                loss = (x * p).sum()
                opt = SGD(0.5, parameters=[p])
                assert opt.minimize(loss, startup_program=static.Program()) \
                    == ([], [])
        finally:
            pt.set_device(old)
        assert main._loss is loss and main._optimizer is opt
        static.Executor().run(main, feed={"x": np.ones((1, 2), "float32")},
                              fetch_list=[loss])
        assert p.tolist() == [0.5, 0.5]

    return {
        "max_pool2d return_mask": return_mask,
        "adaptive_max_pool1d return_mask": adaptive_mask,
        "functional ctc_loss": ctc_loss,
        "functional sequence_pad": sequence_pad,
        "layer Conv2D": conv2d_layer,
        "DataLoader feed_list places return_list": data_loader_static,
        "minimize startup_program in static mode": minimize_static,
        "MultiHeadAttention need_weights": need_weights,
        "Linear initializer": initializer,
        "ProfilerCallback": profiler_callback,
        "paged decode debug_logits": debug_logits,
        "builder probe": probes,
        "engine lane_weights": lane_weights,
        "submit tenant": lambda: submit("tenant", "t1"),
        "submit lane": lambda: submit("lane", "batch"),
        "engine host_tier_bytes": host_tier,
        "scheduler lane_weights": scheduler,
    }


@pytest.mark.parametrize("what", sorted(_ported_checks()))
def test_ported_parameters_have_behaviour(what):
    _ported_checks()[what]()
