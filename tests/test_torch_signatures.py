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
* the step builders' ``probe=``: trace probes are ROADMAP Queue 1 item 3;
* ``register_op``'s (and its ``OpDef``'s) ``nondiff``/``jit``: the port's
  ops run eagerly under torch autograd, with no jit and no
  non-differentiable marking to choose.

Where the port has no behaviour for a parameter it takes, a value other
than the default raises ``NotImplementedError`` naming its ROADMAP
Queue 1 item, never ``TypeError``; the last test calls each of them.
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
_BUILDERS = ("build_fused_step_fn", "build_slot_prefill_fn",
             "build_slot_decode_fn", "build_paged_prefill_fn",
             "build_paged_decode_fn")

#: (the port object's module.qualname, reference parameters it leaves out)
EXEMPT = {
    "paddle_tpu_torch.ops.ragged_paged_attention.ragged_paged_attention":
        {"block_q"},
    **{f"paddle_tpu_torch.models.generation.{b}": {"probe"}
       for b in _BUILDERS},
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
    from paddle_tpu_torch import amp, nn
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.hapi.callbacks import ProfilerCallback
    from paddle_tpu_torch.models.generation import build_paged_decode_fn
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.serving import GenerationEngine, PagedKVPool
    from paddle_tpu_torch.serving.scheduler import Scheduler

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

    def submit(**kw):
        with engine() as eng:
            eng.submit(np.arange(4), max_new_tokens=1, **kw)

    return {
        "engine lane_weights": lambda: engine(lane_weights={"batch": 1.0}),
        "submit tenant": lambda: submit(tenant="t1"),
        "submit lane": lambda: submit(lane="batch"),
        "scheduler spec_k": lambda: Scheduler(None, spec_k=4),
        "scheduler recorder": lambda: Scheduler(None, recorder=object()),
        "pool mesh": lambda: PagedKVPool(1, 1, 1, 16, 8, block_size=8,
                                         mesh=object(), device="cpu"),
        "paged decode debug_logits": lambda: build_paged_decode_fn(
            _gpt(), 2, 2, 8, debug_logits=True),
        "train_batch update": lambda: model().train_batch(
            [torch.ones(3, 4)], [torch.ones(3, 2)], update=False),
        "evaluate prefetch": lambda: model().evaluate(
            pt.io.TensorDataset([np.ones((2, 4), np.float32),
                                 np.ones((2, 2), np.float32)]),
            prefetch=True),
        "minimize startup_program": lambda: minimize(
            startup_program=object()),
        "minimize parameters": lambda: minimize(parameters=[]),
        "DataLoader return_list": lambda: pt.io.DataLoader(
            [1, 2], return_list=False),
        "ProfilerCallback": lambda: ProfilerCallback(start_step=0),
        "MultiHeadAttention need_weights": lambda: nn.MultiHeadAttention(
            8, 2, need_weights=True),
        "Linear initializer": lambda: nn.Linear(
            4, 8, nn.ParamAttr(initializer=object())),
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
