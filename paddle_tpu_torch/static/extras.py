"""The legacy surface of ``static`` beyond Program/Executor (counterpart
of ``paddle_tpu/static/extras.py``; reference python/paddle/static/
__init__.py ``__all__``).

Grouping, as in the JAX package:

* Real, over the port's machinery: program state ``save``/``load`` and
  the ``serialize_*`` pairs, ``gradients``, ``create_parameter`` /
  ``create_global_var``, ``py_func`` (a host call recorded as a node of
  the program), the ``accuracy``/``auc`` expressions, ``Print``,
  ``ExponentialMovingAverage``, and the ``CompiledProgram`` /
  ``ParallelExecutor`` facades, which run the program as it is on the
  one card (the strategies' knobs are kept and change nothing).
* Errors as in the JAX package: the IPU family raises ``RuntimeError``
  as a reference build without IPU support does; ``ctr_metric_bundle``
  belongs to the descoped PS/CTR stack.
* ``cuda_places()`` lists the cards torch sees (``[]`` without one, the
  JAX package's answer on its backend); the other device families are
  ``[]``.

Files cross between the packages: ``save`` writes the program's
parameters under its names into ``.pdparams`` (and the optimizer's
slots into ``.pdopt`` as the JAX package's functional state, ``{"step",
"slots": {name: {slot: array}}}``), and ``serialize_persistables``
pickles ``{name: numpy array}``, each in the JAX package's layout: a
``Linear`` weight, which the port stores as ``[out, in]``, is written
``[in, out]`` and read back transposed. ``serialize_program`` gives the
bytes of the port's own ``.pdmodel`` (a ``torch.export`` artifact,
``jit.save``), not the JAX package's StableHLO.
"""
from __future__ import annotations

import contextlib
import io as _pyio
import os
import pickle
import tempfile
import warnings
from typing import Dict, List

import numpy as np
import torch

from ..framework import static_capture as _capture
from ..framework.place import CUDAPlace, to_torch_device
from ..ops.registry import not_ported as _not_ported
from . import _to_numpy

__all__ = [
    "Variable", "BuildStrategy", "ExecutionStrategy", "CompiledProgram",
    "ParallelExecutor", "Scope", "global_scope", "scope_guard",
    "create_parameter", "create_global_var", "gradients", "py_func",
    "save", "load", "save_to_file", "load_from_file",
    "load_program_state", "set_program_state", "serialize_program",
    "deserialize_program", "serialize_persistables",
    "deserialize_persistables", "normalize_program", "accuracy", "auc",
    "exponential_decay", "Print", "ExponentialMovingAverage",
    "WeightNormParamAttr", "cuda_places", "xpu_places", "npu_places",
    "mlu_places", "IpuStrategy", "IpuCompiledProgram", "ipu_shard_guard",
    "set_ipu_shard", "ctr_metric_bundle",
]


def _current_program():
    from . import default_main_program
    return _capture.current or default_main_program()


# --------------------------------------------------------------------------
# aliases + strategy facades
# --------------------------------------------------------------------------

class _VariableMeta(type):
    def __instancecheck__(cls, obj):
        return isinstance(obj, torch.Tensor)


class Variable(metaclass=_VariableMeta):
    """The tensor (reference fluid Variable: one type serves both graph
    modes here); ``Variable(data)`` makes one as ``Tensor(data)`` does."""

    def __new__(cls, *a, **k):
        from ..framework.tensor import Tensor
        return Tensor(*a, **k)


class BuildStrategy:
    """Reference BuildStrategy: pass toggles for the old graph compiler.
    Every knob is recorded and changes nothing, so tuning scripts run
    without edits."""

    def __init__(self):
        self.__dict__["_opts"] = {}

    def __setattr__(self, k, v):
        self._opts[k] = v

    def __getattr__(self, k):
        if k.startswith("_"):
            raise AttributeError(k)
        return self.__dict__["_opts"].get(k)


class ExecutionStrategy(BuildStrategy):
    """Reference ExecutionStrategy (thread counts etc.): recorded, inert."""


def _check_places(places):
    """More places than the machine has would ask for a data-parallel
    run over devices that do not exist: that is multi-device work."""
    if places is None:
        return
    n = len(places) if isinstance(places, (list, tuple)) else 1
    have = torch.cuda.device_count() if torch.cuda.is_available() else 1
    if n > have:
        raise _not_ported(f"a data-parallel program over {n} places (this "
                          f"machine has {have})", 4)


class CompiledProgram:
    """Reference CompiledProgram(program).with_data_parallel(...): wraps
    the program; ``Executor.run`` runs it as it is, on one device."""

    def __init__(self, program, build_strategy=None):
        self._program = program
        self._build_strategy = build_strategy

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, places=None):
        _check_places(places)
        self._build_strategy = build_strategy
        return self


class ParallelExecutor:
    """Legacy fluid ParallelExecutor facade over ``Executor`` on one
    device."""

    def __init__(self, use_cuda=False, loss_name=None, main_program=None,
                 build_strategy=None, exec_strategy=None, scope=None,
                 share_vars_from=None, places=None):
        from . import Executor, default_main_program
        _check_places(places)
        self._program = main_program or default_main_program()
        self._exe = Executor()

    def run(self, fetch_list, feed=None, return_numpy=True):
        return self._exe.run(self._program, feed=feed,
                             fetch_list=fetch_list,
                             return_numpy=return_numpy)


# --------------------------------------------------------------------------
# scope (name -> value view over the current program)
# --------------------------------------------------------------------------

class _VarView:
    def __init__(self, arr):
        self._arr = arr

    def get_tensor(self):
        return self._arr

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self._arr, dtype=dtype)


class Scope:
    """A debugging view: resolves names against the current program's
    parameters and variables, plus vars set locally (the reference Scope
    is the C++ variable table)."""

    def __init__(self):
        self._vars: Dict[str, np.ndarray] = {}

    def var(self, name):
        self._vars.setdefault(name, np.zeros((), np.float32))
        return _VarView(self._vars[name])

    def set(self, name, value):
        self._vars[name] = np.asarray(value)

    def find_var(self, name):
        if name in self._vars:
            return _VarView(self._vars[name])
        prog = _current_program()
        if name in prog._params:
            return _VarView(_to_numpy(prog._params[name]))
        if name in prog._var_names:
            return _VarView(_to_numpy(prog._vars[prog._var_names[name]]))
        return None


_global_scope = Scope()
_scope_stack: List[Scope] = []


def global_scope() -> Scope:
    return _scope_stack[-1] if _scope_stack else _global_scope


class scope_guard:
    def __init__(self, scope):
        self._scope = scope

    def __enter__(self):
        _scope_stack.append(self._scope)
        return self._scope

    def __exit__(self, *a):
        _scope_stack.pop()
        return False


# --------------------------------------------------------------------------
# var/parameter creation + autodiff + host callback
# --------------------------------------------------------------------------

def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """Reference static.create_parameter: a parameter on the current
    place, keyed into the current program's parameter table (by ``name``
    or the attribute's) so that ``minimize()`` and ``save()`` see it."""
    import copy
    from ..nn.layer.layers import ParamAttr, make_parameter
    attr = ParamAttr._to_attr(attr)
    if name and attr is not False and not attr.name:
        attr = copy.copy(attr)
        attr.name = name
    p = make_parameter(shape, attr, dtype, is_bias=is_bias,
                       default_initializer=default_initializer,
                       device=to_torch_device(None))
    _current_program()._add_param(p)
    return p


def create_global_var(shape, value, dtype, persistable=False, name=None,
                      force_cpu=False):
    """A filled tensor the current program reads live (by ``name`` too):
    the ops reading it are recorded."""
    from ..framework.dtypes import convert_dtype
    device = torch.device("cpu") if force_cpu else to_torch_device(None)
    var = torch.full(tuple(int(s) for s in shape), value,
                     dtype=convert_dtype(dtype), device=device)
    prog = _current_program()
    prog._vars[id(var)] = var
    prog._produced.add(id(var))
    if name:
        prog._var_names[name] = id(var)
    return var


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """Reference static.gradients: the gradients of ``targets`` (summed)
    with respect to program PARAMETERS among ``inputs``, as fetchable
    variables (a feed's gradient needs another replay: it raises, as in
    the JAX package)."""
    from . import append_backward
    targets = targets if isinstance(targets, (list, tuple)) else [targets]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    non_params = [x for x in inputs
                  if not isinstance(x, torch.nn.Parameter)]
    if non_params:
        raise NotImplementedError(
            "static.gradients supports gradients w.r.t. Parameters; got "
            f"{len(non_params)} non-parameter input(s). Use "
            "append_backward/fetch of @GRAD vars for parameters, or "
            "autograd.grad in dynamic mode for arbitrary inputs")
    prog = _current_program()
    for p in inputs:
        prog._add_param(p)
    total = targets[0]
    for extra in targets[1:]:
        total = total + extra     # grad of sum == summed grads
    pairs = append_backward(total, parameter_list=list(inputs))
    by_param = {id(p): g for p, g in pairs}
    return [by_param.get(id(p)) for p in inputs]


def _host_op(name, fn, *xs):
    """Run ``fn(*xs)`` and, while a program records, append it as one
    node (the torch calls inside it are part of it, not nodes)."""
    if _capture.current is None or _capture.in_op():
        return fn(*xs)
    with _capture.op_scope():
        out = fn(*xs)
    _capture.record(name, fn, (xs, {}), out)
    return out


def _call_py_func(func, shape, dtype, *xs):
    """``func`` on host numpy copies of ``xs``; the result on the first
    input's device, ``shape`` with its leading dimension following the
    first input's batch."""
    if shape and xs and xs[0].dim() >= 1:
        shape = (xs[0].shape[0],) + tuple(shape[1:])
    arr = _to_numpy(func(*[_to_numpy(x) for x in xs]))
    out = torch.from_numpy(np.ascontiguousarray(arr.reshape(shape)))
    device = xs[0].device if xs else to_torch_device(None)
    return out.to(device=device, dtype=dtype)


def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None):
    """A host Python node inside a program (reference static.nn.py_func
    over the py_func op): ``func`` gets numpy copies of ``x`` and its
    result goes back to the input's device, shaped and typed as the
    template ``out``, with the leading (batch) dimension following the
    input's, so the node replays under any feed size. No gradient flows
    through (as in the reference without ``backward_func``);
    ``backward_func`` raises, as in the JAX package."""
    import functools
    if backward_func is not None:
        raise NotImplementedError(
            "py_func backward_func is not supported; wrap the op with "
            "autograd.PyLayer in dynamic mode instead")
    xs = tuple(x) if isinstance(x, (list, tuple)) else (x,)
    fn = functools.partial(_call_py_func, func, tuple(out.shape), out.dtype)
    return _host_op("py_func", fn, *xs)


# --------------------------------------------------------------------------
# program state persistence + serialization
# --------------------------------------------------------------------------

def _jax_layout(t, transposed):
    """A parameter (or a slot shaped like it) as the JAX package holds
    it: a ``Linear`` weight (``transposed``) back to ``[in, out]``."""
    t = t.detach()
    return t.t() if transposed else t


def _assign(param, value, name, transposed):
    """Copy ``value`` (numpy or torch, the JAX layout) into ``param`` in
    its dtype, in place."""
    if not isinstance(value, torch.Tensor):
        value = torch.from_numpy(np.array(value))
    if transposed:
        value = value.t()
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f"{name}: array {tuple(value.shape)} does not fit "
                         f"the parameter {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(value.to(param.dtype))


def _files_state(program):
    """The program's parameters by name in the JAX layout."""
    tr = program._transposed()
    return {n: _jax_layout(p, id(p) in tr)
            for n, p in program._params.items()}


def load_program_state(model_path, var_list=None) -> Dict[str, np.ndarray]:
    """Reference static.load_program_state: a ``.pdparams`` as ``{name:
    array}`` (the file's layout)."""
    from ..framework.io import load_pdparams
    path = model_path if model_path.endswith(".pdparams") \
        else model_path + ".pdparams"
    return load_pdparams(path)


def set_program_state(program, state_dict) -> None:
    """Set every parameter of ``program`` from ``state_dict`` by name
    (the JAX layout); a missing name raises."""
    missing = [n for n in program._params if n not in state_dict]
    if missing:
        raise ValueError(f"state dict is missing parameters {missing[:5]}"
                         f"{'...' if len(missing) > 5 else ''}")
    tr = program._transposed()
    for name, param in program._params.items():
        _assign(param, state_dict[name], name, id(param) in tr)


def _slot_rows(program):
    """``(program name, optimizer name, param)`` of every parameter of
    ``program`` its optimizer holds."""
    opt = program._optimizer
    names = {id(p): k for k, p in program._params.items()}
    return [(names[id(p)], oname, p) for oname, p in opt._params or ()
            if id(p) in names]


def save(program, model_path, protocol=4) -> None:
    """Reference static.save: the program's parameters into
    ``.pdparams``, and, once its optimizer has stepped, the optimizer's
    state into ``.pdopt``."""
    from ..framework.io import save as _fsave
    _fsave(_files_state(program), model_path + ".pdparams",
           protocol=protocol)
    opt = program._optimizer
    if opt is None or not opt._slots:
        return
    slots, transposed = {}, program._transposed()
    for pname, oname, p in _slot_rows(program):
        own = opt._slots.get(oname)
        if not own:
            continue
        tr = id(p) in transposed
        slots[pname] = {
            s: np.asarray(v, np.int32) if s == "_t0" else
            (v.detach().t() if tr else v.detach())
            for s, v in own.items()}
    _fsave({"step": np.asarray(opt._step_count, np.int32), "slots": slots},
           model_path + ".pdopt", protocol=protocol)


def load(program, model_path, executor=None, var_list=None) -> None:
    """Reference static.load: the parameters from ``.pdparams``, and the
    optimizer's state from ``.pdopt`` when the program has an optimizer
    and the file exists."""
    from ..framework.io import load as _fload
    set_program_state(program, _fload(model_path + ".pdparams"))
    opt_path = model_path + ".pdopt"
    opt = program._optimizer
    if opt is None or not os.path.exists(opt_path):
        return
    state = _fload(opt_path)
    slots, transposed = state.get("slots", {}), program._transposed()
    for pname, oname, p in _slot_rows(program):
        if pname not in slots:
            continue
        tr = id(p) in transposed
        own = {}
        for s, v in slots[pname].items():
            if s == "_t0":
                own[s] = int(v)
                continue
            v = v.t() if tr else v
            own[s] = v.to(p.device).contiguous()
        opt._slots[oname] = own
    opt._step_count = int(state.get("step", 0))


def save_to_file(path, content: bytes) -> None:
    with open(path, "wb") as f:
        f.write(content)


def load_from_file(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def serialize_program(feed_vars, fetch_vars, program=None, **kwargs) -> bytes:
    """The bytes of the port's ``.pdmodel`` for feeds -> fetches
    (``save_inference_model``: a ``torch.export`` artifact holding the
    weights)."""
    from . import save_inference_model
    with tempfile.TemporaryDirectory() as d:
        prefix = os.path.join(d, "prog")
        save_inference_model(prefix, feed_vars, fetch_vars, program=program)
        return load_from_file(prefix + ".pdmodel")


def deserialize_program(data: bytes):
    """bytes of :func:`serialize_program` -> a runnable ``jit.load``ed
    program on the current place."""
    from .. import jit
    with tempfile.TemporaryDirectory() as d:
        prefix = os.path.join(d, "prog")
        save_to_file(prefix + ".pdmodel", data)
        return jit.load(prefix, device=to_torch_device(None))


def serialize_persistables(feed_vars, fetch_vars, program=None,
                           **kwargs) -> bytes:
    """The program's parameters pickled as ``{name: numpy array}`` (the
    JAX layout; bfloat16, which numpy lacks, as ``framework.io``'s
    tagged entry)."""
    from ..framework.io import _to_picklable
    prog = program if program is not None else _current_program()
    return pickle.dumps(_to_picklable(_files_state(prog)), protocol=4)


def deserialize_persistables(program, data: bytes, executor=None) -> None:
    """Set ``program``'s parameters from :func:`serialize_persistables`'
    bytes (either package's); only numpy arrays in builtin containers
    are unpickled."""
    from ..framework.io import RestrictedUnpickler, _from_picklable
    state = _from_picklable(RestrictedUnpickler(_pyio.BytesIO(data)).load())
    set_program_state(program, state)


def normalize_program(program, feed_vars, fetch_vars, **kwargs):
    """Reference normalize_program prunes to the inference graph: the
    ``for_test`` clone (optimizer stripped) is that here."""
    return program.clone(for_test=True)


# --------------------------------------------------------------------------
# metric expressions + debug + EMA + lr compat
# --------------------------------------------------------------------------

def accuracy(input, label, k=1, correct=None, total=None):
    """Top-k accuracy as a recordable expression (reference
    static.accuracy over the accuracy op)."""
    from ..framework.dispatch import call_op
    topk = call_op("topk", input, k=k)[1]              # indices [N, k]
    lab = call_op("reshape", label, shape=[-1, 1])
    eq = call_op("equal", topk, call_op("cast", lab, dtype="int64"))
    hits = call_op("cast", call_op("any", eq, axis=-1), dtype="float32")
    return call_op("mean", hits)


def auc(input, label, curve="ROC", num_thresholds=4095, **kwargs):
    """Batch AUC expression (reference static.auc). ``input`` holds the
    per-class probabilities ``[N, 2]``; the rank-statistic form keeps it
    one expression."""
    from ..framework.dispatch import call_op
    pos_score = call_op("slice", input, axes=[1], starts=[1], ends=[2])
    pos_score = call_op("reshape", pos_score, shape=[-1])
    lab = call_op("cast", call_op("reshape", label, shape=[-1]),
                  dtype="float32")
    order = call_op("argsort", pos_score)
    ranked = call_op("cast", call_op("argsort", order), dtype="float32")
    n_pos = call_op("sum", lab)
    n_neg = call_op("sum", 1.0 - lab)
    pos_rank_sum = call_op("sum", ranked * lab) + n_pos  # 1-based ranks
    return (pos_rank_sum - n_pos * (n_pos + 1.0) / 2.0) / \
        call_op("maximum", n_pos * n_neg,
                call_op("full", shape=[], fill_value=1.0, dtype="float32"))


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """The fluid lr-decay API as the 2.x scheduler (as the reference maps
    it)."""
    from ..optimizer import lr as lr_mod
    if staircase:
        return lr_mod.StepDecay(learning_rate=learning_rate,
                                step_size=decay_steps, gamma=decay_rate)
    return lr_mod.ExponentialDecay(learning_rate=learning_rate,
                                   gamma=decay_rate ** (1.0 / decay_steps))


def _print_identity(message, x):
    print(f"{message}: {_to_numpy(x)}", flush=True)
    return x.view_as(x)


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_layout=True,
          print_tensor_lod=True, print_phase="both"):
    """The identity with a host-side print at every run (reference Print
    op; a recorded node, so a program's replay prints too); the gradient
    passes through."""
    import functools
    return _host_op("print", functools.partial(
        _print_identity, message or "Print"), input)


class ExponentialMovingAverage:
    """EMA over a program's parameters (reference
    static.ExponentialMovingAverage): ``update()`` after each step,
    ``apply()`` a context that swaps the shadow values in and, on exit,
    ``restore()``s the parameters. The program is the one recording at
    construction (else the current one at each call). As in the JAX
    package: no bias correction, ``thres_steps`` ignored, and the shadow
    keeps each parameter's dtype, its scalars rounded to that dtype as
    ``jnp`` rounds a Python scalar."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self.decay = float(decay)
        self._program = _capture.current
        self._shadow: Dict[str, torch.Tensor] = {}
        self._backup: Dict[str, torch.Tensor] = {}

    def _params(self):
        prog = self._program or _current_program()
        return prog._params

    @torch.no_grad()
    def update(self):
        from ..optimizer.optimizer import _weak
        for n, p in self._params().items():
            prev = self._shadow.get(n)
            if prev is None:
                self._shadow[n] = p.detach().clone()
            else:
                prev.copy_(prev * _weak(self.decay, prev)
                           + p * _weak(1 - self.decay, p))

    def apply(self, executor=None, need_restore=True):
        @contextlib.contextmanager
        def ctx():
            params = self._params()
            with torch.no_grad():
                self._backup = {n: p.detach().clone()
                                for n, p in params.items()}
                for n, p in params.items():
                    if n in self._shadow:
                        p.copy_(self._shadow[n])
            try:
                yield self
            finally:
                if need_restore:
                    self.restore()
        return ctx()

    @torch.no_grad()
    def restore(self, executor=None):
        params = self._params()
        for n, t in self._backup.items():
            if n in params:
                params[n].copy_(t)
        self._backup = {}


class WeightNormParamAttr:
    """Accepted for API parity; the weight-norm reparameterization is
    ``nn.utils.weight_norm``'s job in 2.x: constructing this warns and
    gives a plain ``ParamAttr``."""

    def __new__(cls, dim=None, **kwargs):
        from ..nn.layer.layers import ParamAttr
        warnings.warn(
            "WeightNormParamAttr: use paddle.nn.utils.weight_norm for "
            "the reparameterization; treating as plain ParamAttr",
            UserWarning, stacklevel=2)
        kwargs.pop("dim", None)
        return ParamAttr(**kwargs)


# --------------------------------------------------------------------------
# device place lists + IPU family + PS metric bundle
# --------------------------------------------------------------------------

def cuda_places(device_ids=None):
    """A ``CUDAPlace`` for each card torch sees (of ``device_ids`` when
    given); ``[]`` without one."""
    if not torch.cuda.is_available():
        return []
    ids = range(torch.cuda.device_count()) if device_ids is None \
        else device_ids
    return [CUDAPlace(int(i)) for i in ids]


def xpu_places(device_ids=None):
    return []


def npu_places(device_ids=None):
    return []


def mlu_places(device_ids=None):
    return []


def _no_ipu(*a, **k):
    # the reference's behavior when paddle is not compiled with IPU
    # support (python/paddle/device/__init__.py is_compiled_with_ipu)
    raise RuntimeError(
        "IPU support is not available: this build runs on CUDA cards and "
        "the CPU (the reference raises identically unless built with IPU)")


class IpuStrategy:
    def __init__(self, *a, **k):
        _no_ipu()


class IpuCompiledProgram:
    def __init__(self, *a, **k):
        _no_ipu()


def ipu_shard_guard(*a, **k):
    _no_ipu()


def set_ipu_shard(*a, **k):
    _no_ipu()


def ctr_metric_bundle(input, label, ins_tag_weight=None):
    raise NotImplementedError(
        "ctr_metric_bundle belongs to the descoped PS/CTR stack (see "
        "README.md scope decision); use paddle.metric.Auc or "
        "static.auc for AUC over program vars")
