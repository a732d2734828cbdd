"""``static``: the static-graph user API (counterpart of
``paddle_tpu/static/__init__.py``).

Analog of the reference's ``python/paddle/static/`` (Program, Executor,
program_guard, append_backward over ProgramDesc; fluid/executor.py:1109,
fluid/backward.py). As in the JAX package, a "program" is a recorded op
list replayed as a function: here of torch tensors, with torch autograd
as ``append_backward`` and the port's optimizer as the update.

How it works:

- ``enable_static()`` + ``program_guard`` activate op CAPTURE: every
  ``call_op`` appends an ``OpNode`` to the current Program
  (``framework/static_capture.py``), after the AMP casts.
- ``static.data(name, shape)`` creates a feed variable: a tensor of
  zeros (``None`` dims -> 1) on the current place whose identity marks
  where feeds enter the recorded graph.
- Layers and ops run eagerly ONCE at build time, on the placeholders,
  while the recording happens: the build IS the trace.
- ``Executor.run(prog, feed={name: arr}, fetch_list=[vars])`` replays
  the node list on the fed tensors and the live parameters: feeds by
  NAME, fetches by variable identity (or name). With an optimizer
  attached by ``minimize()`` the replay is a train step: the recorded
  loss's ``backward()``, then the optimizer's ``step()`` (Adam/AdamW:
  the fused AdamW kernel on the card) and ``clear_grad()``; the
  parameters are the live ones, so the state persists across runs.

A recorded parameter is keyed by its ``ParamAttr`` name when it has one
(the JAX package keys by ``Parameter.name``), else ``param_<i>`` in
order of first use, so two builds of one network key alike and a
``static.save`` file of one loads into the other. ``minimize(loss,
parameters=, no_grad_set=)`` limits the step to that subset, and the
replay then differentiates only what it steps or fetches.

``save_inference_model``/``load_inference_model`` go through
``jit.save``/``jit.load``. The JAX package's static-analysis pre-flight
of ``Executor.run`` waits on the ``analysis`` port (ROADMAP Queue 1 item
5). ``static.nn`` (control flow and the layer builders) and the legacy
names of ``static/extras.py`` are imported at the end of this module.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..framework import static_capture as _capture
from ..framework.dtypes import convert_dtype
from ..framework.place import to_torch_device

__all__ = ["enable_static", "disable_static", "in_dynamic_mode",
           "InputSpec", "Program", "program_guard", "default_main_program",
           "default_startup_program", "Executor", "data", "name_scope",
           "cpu_places", "device_guard", "save_inference_model",
           "load_inference_model", "append_backward"]

_mode = threading.local()


def enable_static():
    _mode.static = True
    if _capture.current is None:
        _capture.set_current(_default_main)


def disable_static():
    _mode.static = False
    _capture.set_current(None)


def in_dynamic_mode() -> bool:
    return not getattr(_mode, "static", False)


class InputSpec:
    """Shape/dtype declaration for captured functions (reference
    python/paddle/static/input.py). ``dtype`` is kept as a
    ``torch.dtype``; a ``None`` or ``-1`` dimension is dynamic."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = tuple(shape)
        self.dtype = convert_dtype(dtype)
        self.name = name

    @classmethod
    def from_tensor(cls, t, name=None):
        return cls(tuple(t.shape), t.dtype, name)

    def to_aval(self, batch=1):
        """A meta tensor of this spec, ``batch`` in place of each dynamic
        dimension (the counterpart of a ``jax.ShapeDtypeStruct``)."""
        shape = tuple(batch if s in (-1, None) else s for s in self.shape)
        return torch.empty(shape, dtype=self.dtype, device="meta")

    def __repr__(self):
        return f"InputSpec(shape={self.shape}, dtype={self.dtype}, " \
               f"name={self.name})"


class Program:
    """A recorded op graph, replayable as a function of its feeds and
    parameters. Also still accepts a plain callable (legacy
    ``Program(fn)`` ergonomics)."""

    def __init__(self, fn=None, input_specs=None):
        self._fn = fn
        self._input_specs = input_specs
        # --- recorded-graph state ---
        self._nodes: List[_capture.OpNode] = []
        self._feeds: Dict[str, int] = {}          # feed name -> tensor id
        self._vars: Dict[int, torch.Tensor] = {}  # keep-alive + fetch map
        self._var_names: Dict[str, int] = {}      # var name -> tensor id
        self._params: Dict[str, torch.Tensor] = {}   # name -> Parameter
        self._loss: Optional[torch.Tensor] = None
        self._optimizer = None
        self._grad_vars: Dict[int, str] = {}      # grad var id -> param name
        self._declared: Dict[int, tuple] = {}     # feed id -> data() shape
        self._produced: set = set()               # feed and node output ids
        # minimize(parameters=, no_grad_set=): the optimizer's (name,
        # param) pairs a step updates (None: all it holds)
        self._opt_chosen = None

    # -- capture hooks (called via framework/static_capture.py) ----------
    def _record_op(self, op_name, fn, inputs, spec, out_tensors, attrs,
                   torch_function=False):
        for tid, value, _ in inputs:
            if tid is None:
                continue
            self._vars.setdefault(tid, value)
            if isinstance(value, torch.nn.Parameter):
                self._add_param(value)
        out_ids = []
        for t in out_tensors:
            self._vars[id(t)] = t
            self._produced.add(id(t))
            out_ids.append(id(t))
        self._nodes.append(_capture.OpNode(op_name, fn, inputs, out_ids,
                                           attrs, spec, torch_function))

    def _add_param(self, param, name=None) -> str:
        """Key ``param`` in ``_params`` (once): by ``name``, its
        ``ParamAttr`` name, or ``param_<i>``; returns the key."""
        for key, p in self._params.items():
            if p is param:
                return key
        name = name or getattr(param, "_paddle_name", None)
        if name is None:
            i = len(self._params)
            while f"param_{i}" in self._params:
                i += 1
            name = f"param_{i}"
        elif name in self._params:
            raise ValueError(f"two parameters of one program are named "
                             f"{name!r}")
        self._params[name] = param
        return name

    def _transposed(self) -> set:
        """Ids of the parameters the program reads as ``w.t()`` into the
        weight of a ``linear`` op: a ``Linear``'s weight, which the port
        stores ``[out, in]`` and the JAX package ``[in, out]`` (files and
        exports write the JAX layout)."""
        t_of = {}
        for node in self._nodes:
            ts = [(tid, v) for tid, v, _ in node.inputs if tid is not None]
            if node.torch_function and node.op == "t" and len(ts) == 1 \
                    and isinstance(ts[0][1], torch.nn.Parameter):
                t_of[node.out_ids[0]] = ts[0][0]
        out = set()
        for node in self._nodes:
            ts = [tid for tid, _, _ in node.inputs if tid is not None]
            if not node.torch_function and node.op == "linear" and \
                    len(ts) >= 2 and ts[1] in t_of:
                out.add(t_of[ts[1]])
        return out

    def _tracks(self, t) -> bool:
        """Whether ``t`` is a feed, a parameter or a recorded result."""
        return isinstance(t, torch.nn.Parameter) or id(t) in self._produced

    def _add_feed(self, name, tensor, shape=None):
        self._declared[id(tensor)] = tuple(shape if shape is not None
                                           else tensor.shape)
        self._feeds[name] = id(tensor)
        self._produced.add(id(tensor))
        self._vars[id(tensor)] = tensor
        self._var_names[name] = id(tensor)

    # -- program surface -------------------------------------------------
    def __call__(self, *args):
        if self._fn is None:
            raise RuntimeError("empty Program")
        return self._fn(*args)

    def clone(self, for_test=False):
        p = Program(self._fn, self._input_specs)
        p._nodes = list(self._nodes)
        p._feeds = dict(self._feeds)
        p._vars = dict(self._vars)
        p._var_names = dict(self._var_names)
        p._params = dict(self._params)
        p._loss = self._loss
        p._grad_vars = dict(self._grad_vars)
        p._declared = dict(self._declared)
        p._produced = set(self._produced)
        if not for_test:
            p._optimizer = self._optimizer
            p._opt_chosen = self._opt_chosen
        return p

    def list_vars(self):
        return list(self._vars.values())

    @property
    def num_blocks(self):
        return 1

    # -- replay ----------------------------------------------------------
    def _resolve_fetch(self, item) -> int:
        if isinstance(item, torch.Tensor):
            tid = id(item)
            if tid in self._vars or tid in self._grad_vars:
                return tid
            raise KeyError("fetch var is not part of this program")
        if isinstance(item, str):
            if item in self._var_names:
                return self._var_names[item]
            raise KeyError(f"no variable named {item!r} in this program")
        raise TypeError(f"cannot fetch {type(item).__name__}")

    def _forward_env(self, feeds: Dict[str, Any], params=None, nodes=None,
                     _observer=None):
        """Replay ``nodes`` (a :meth:`_plan`: the reference's pruning to
        the fetch targets), else the whole node list; returns
        {tensor_id: tensor}. ``params`` maps a recorded parameter's id to
        the tensor to use in its place (an export passes its own); the
        live parameter otherwise. ``_observer(index, node, leaves)`` is
        called before each node runs, with its resolved operand leaves
        (the calibration hook of ``quantization/passes.py``)."""
        env: Dict[int, Any] = {}
        for name, tid in self._feeds.items():
            if name in feeds:
                env[tid] = feeds[name]
        if params:
            env.update(params)
        for i, node in enumerate(self._nodes if nodes is None else nodes):
            leaves = []
            for tid, value, cast in node.inputs:
                if tid is not None:
                    value = env.get(tid, value)
                    if cast is not None:
                        value = value.to(cast)
                leaves.append(value)
            if _observer is not None:
                _observer(i, node, leaves)
            args, attrs = pytree.tree_unflatten(leaves, node.spec)
            out = node.fn(*args, **attrs)
            flat = [t for t in pytree.tree_leaves(out)
                    if isinstance(t, torch.Tensor)]
            for tid, a in zip(node.out_ids, flat):
                env[tid] = a
        return env

    @staticmethod
    def _writes(node):
        """The ids a node produces: its outputs, or, for an in-place one
        that returns nothing (``x[i] = v``), the tensor it writes."""
        if node.out_ids:
            return node.out_ids
        return [tid for tid, _, _ in node.inputs if tid is not None][:1]

    def _needed_ids(self, roots) -> set:
        """Tensor ids reachable backward from ``roots`` through the node
        list (the reference's graph pruning for fetch targets)."""
        needed = set(roots)
        for node in reversed(self._nodes):
            if any(tid in needed for tid in self._writes(node)):
                needed.update(tid for tid, _, _ in node.inputs
                              if tid is not None)
        return needed

    def _plan(self, roots):
        """``(the nodes roots depend on, in order; the ids they read)``."""
        needed = self._needed_ids(roots)
        return [n for n in self._nodes
                if any(tid in needed for tid in self._writes(n))], needed

    def _feed_tensor(self, name, value):
        """A fed value as a tensor on its placeholder's device, in the
        declared dtype."""
        ph = self._vars[self._feeds[name]]
        if not isinstance(value, torch.Tensor):
            value = torch.as_tensor(np.asarray(value))
        return value.to(device=ph.device, dtype=ph.dtype)

    def _execute(self, feed: Dict[str, Any], fetch_ids: Sequence[int],
                 return_numpy: bool = True, update: bool = True):
        """One Executor.run: the replay, plus a train step when an
        optimizer is attached. The step's gradients add to each stepped
        parameter's ``.grad``; ``update=False`` stops there (the
        gradients accumulate over runs, as ``train_batch(update=False)``
        asks), else the optimizer steps and clears them."""
        train = self._optimizer is not None and self._loss is not None
        want_grads = [tid for tid in fetch_ids if tid in self._grad_vars]
        need_grad = train or bool(want_grads)

        # a feed the requested computation depends on must actually be
        # fed: the zero build-time placeholder would silently return
        # garbage (the reference Executor raises too)
        roots = [t for t in fetch_ids if t not in self._grad_vars]
        if need_grad and self._loss is not None:
            roots.append(id(self._loss))
        nodes, needed = self._plan(roots)
        missing = [name for name, tid in self._feeds.items()
                   if tid in needed and name not in feed]
        if missing:
            raise ValueError(
                f"feed is missing declared variable(s) {missing} required "
                f"by the requested fetch targets")
        feeds = {k: self._feed_tensor(k, v) for k, v in feed.items()
                 if k in self._feeds}
        with torch.enable_grad() if need_grad else torch.no_grad():
            env = self._forward_env(feeds, nodes=nodes)
            if need_grad:
                if self._loss is None:
                    raise RuntimeError("gradients need append_backward(loss)"
                                       " or minimize(loss) first")
                keys = {id(p): k for k, p in self._params.items()}
                stepped = [(n, p) for n, p in self._stepped()
                           if id(p) in keys] if train else []
                names = {self._grad_vars[t] for t in want_grads}
                names.update(keys[id(p)] for _, p in stepped)
                names = [n for n in self._params if n in names]
                grads = dict(zip(names, torch.autograd.grad(
                    env[id(self._loss)].float(),
                    [self._params[n] for n in names], allow_unused=True)))
                for tid in want_grads:
                    pname = self._grad_vars[tid]
                    g = grads[pname]
                    env[tid] = torch.zeros_like(self._params[pname]) \
                        if g is None else g
                for _, p in stepped:
                    g = grads[keys[id(p)]]
                    if g is not None:
                        p.grad = g if p.grad is None else p.grad + g
                if train and update:
                    self._optimizer.step(self._opt_chosen)
                    for _, p in stepped:
                        p.grad = None
        # a fetched variable no node produced (a global var) is read live
        fetched = [env.get(tid, self._vars.get(tid)).detach()
                   for tid in fetch_ids]
        if return_numpy:
            return [_to_numpy(v) for v in fetched]
        return fetched

    def _stepped(self):
        """The ``(name, param)`` pairs a train step updates: the subset
        ``minimize`` chose, else every parameter the optimizer holds."""
        if self._opt_chosen is not None:
            return self._opt_chosen
        return self._optimizer._params or []


_default_main = Program()
_default_startup = Program()


def default_main_program():
    return _default_main


def default_startup_program():
    return _default_startup


class program_guard:
    """Route capture into ``main_program`` (reference
    fluid/framework.py program_guard)."""

    def __init__(self, main_program, startup_program=None):
        self.main = main_program
        self._prev = None

    def __enter__(self):
        self._prev = _capture.current
        _capture.set_current(self.main)
        return self.main

    def __exit__(self, *a):
        _capture.set_current(self._prev)
        return False


def data(name, shape, dtype="float32", lod_level=0):
    """Declare a feed variable in the current program (reference
    static/input.py data): a placeholder tensor of zeros on the current
    place, ``None``/``-1`` dims at 1."""
    prog = _capture.current or _default_main
    var = torch.zeros(tuple(1 if s in (-1, None) else int(s) for s in shape),
                      dtype=convert_dtype(dtype), device=to_torch_device(None))
    prog._add_feed(name, var, shape)
    return var


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None):
    """Register gradient computation for ``loss`` (reference
    fluid/backward.py append_backward). Returns ``[(param, grad_var)]``;
    each grad var (named ``<param name>@GRAD``) is fetchable through
    ``Executor.run``."""
    prog = _capture.current or _default_main
    prog._loss = loss
    out = []
    wanted = list(parameter_list or ())
    for pname, param in prog._params.items():
        if wanted and pname not in wanted and not any(
                w is param for w in wanted):
            continue
        gvar = torch.zeros_like(param, requires_grad=False)
        prog._grad_vars[id(gvar)] = pname
        prog._vars[id(gvar)] = gvar
        prog._var_names[pname + "@GRAD"] = id(gvar)
        out.append((param, gvar))
    return out


def name_scope(prefix=None):
    return contextlib.nullcontext()


def cpu_places(device_count=None):
    from ..framework.place import CPUPlace
    return [CPUPlace()]


def device_guard(device=None):
    return contextlib.nullcontext()


def _to_numpy(o):
    if isinstance(o, torch.Tensor):
        o = o.detach().cpu()
        return (o.float() if o.dtype == torch.bfloat16 else o).numpy()
    return np.asarray(o)


class Executor:
    """Feed/fetch-by-name executor over recorded Programs (reference
    Executor.run fluid/executor.py:1109): the replay runs the recorded
    ops eagerly on the fed tensors. A ``CompiledProgram`` runs its
    program."""

    def __init__(self, place=None):
        self.place = place

    def run(self, program=None, feed=None, fetch_list=None,
            return_numpy=True):
        return self._run(program, feed, fetch_list, return_numpy)

    def _run(self, program, feed, fetch_list, return_numpy, update=True):
        """``run``; ``update=False`` accumulates a train step's gradients
        without the optimizer's step (``Program._execute``)."""
        if program is None:
            program = _default_main
        program = getattr(program, "_program", program)  # CompiledProgram
        if callable(program) and not isinstance(program, Program):
            out = program(**(feed or {}))
            if fetch_list:
                return [_to_numpy(o) for o in
                        (out if isinstance(out, (list, tuple)) else [out])]
            return out
        if not isinstance(program, Program):
            raise TypeError("Executor.run needs a Program or callable")
        if program._nodes:
            # pause capture during replay: executing the program must not
            # append to it
            with _capture.paused():
                fetch_ids = [program._resolve_fetch(f)
                             for f in (fetch_list or [])]
                return program._execute(feed or {}, fetch_ids,
                                        return_numpy, update)
        if program._fn is not None:
            out = program(**(feed or {})) if feed else program()
            if fetch_list:
                return [_to_numpy(o) for o in
                        (out if isinstance(out, (list, tuple)) else [out])]
            return out
        # startup program / empty main: parameters were initialised
        # eagerly at layer construction: nothing to do
        return []


class _Replay(torch.nn.Module):
    """A recorded program pruned to ``feed_names`` -> ``fetch_ids`` as a
    module, its parameters registered so that ``torch.export`` lifts
    them."""

    def __init__(self, program, feed_names, fetch_ids):
        super().__init__()
        self._program = program
        self._feed_names = feed_names
        self._fetch_ids = fetch_ids
        self._ids = [id(p) for p in program._params.values()]
        self.params = torch.nn.ParameterList(program._params.values())

    def forward(self, *arrays):
        env = self._program._forward_env(
            dict(zip(self._feed_names, arrays)),
            dict(zip(self._ids, self.params)),
            self._program._plan(self._fetch_ids)[0])
        outs = [env[i] for i in self._fetch_ids]
        return outs[0] if len(outs) == 1 else tuple(outs)


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor=None,
                         program=None, **kwargs):
    """Reference: static.save_inference_model (fluid/io.py), here through
    ``jit.save``. ``fetch_vars`` may be a Layer or a callable producing
    the fetches from the feeds; with a RECORDED ``program``, the replay
    pruned to feeds -> fetches is what exports."""
    from .. import jit as _jit
    feed_list = (feed_vars if isinstance(feed_vars, (list, tuple))
                 else [feed_vars])
    specs = [v if isinstance(v, InputSpec) else InputSpec.from_tensor(v)
             for v in feed_list]
    if isinstance(program, Program) and program._nodes:
        fetch_list = (fetch_vars if isinstance(fetch_vars, (list, tuple))
                      else [fetch_vars])
        fetch_ids = [program._resolve_fetch(v) for v in fetch_list]
        id2name = {tid: n for n, tid in program._feeds.items()}
        feed_names = []
        for v in feed_list:
            tid = id(v) if isinstance(v, torch.Tensor) else \
                program._var_names.get(getattr(v, "name", None) or v)
            if tid not in id2name:
                raise ValueError(
                    "feed_vars must be this program's declared "
                    "static.data variables")
            feed_names.append(id2name[tid])
        # a dimension declared None in static.data stays dynamic
        specs = [InputSpec(program._declared[program._feeds[n]], s.dtype, n)
                 for s, n in zip(specs, feed_names)]
        prev = _capture.current
        _capture.set_current(None)
        try:
            return _jit.save(_Replay(program, feed_names, fetch_ids),
                             path_prefix, input_spec=specs)
        finally:
            _capture.set_current(prev)
    target = program if program is not None else fetch_vars
    return _jit.save(target, path_prefix, input_spec=specs)


def load_inference_model(path_prefix, executor=None, **kwargs):
    """Returns ``(predictor, feed_names, fetch_names)``, the reference
    signature ``(program, feed_target_names, fetch_targets)``; the
    predictor runs on the executor's place (the card by default)."""
    from .. import jit as _jit
    place = getattr(executor, "place", None)
    device = to_torch_device(place) if place is not None else None
    layer = _jit.load(path_prefix, device=device)
    return layer, layer.input_names, None


from .extras import *  # noqa: E402,F401,F403  (legacy/compat surface)
from . import extras as _extras  # noqa: E402
from . import nn  # noqa: E402,F401  (control flow and layer builders)
__all__ += _extras.__all__
