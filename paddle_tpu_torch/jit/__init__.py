"""``jit``: to_static, save, load (counterpart of
``paddle_tpu/jit/__init__.py``).

Reference analogs: ``@to_static`` + ProgramTranslator
(python/paddle/fluid/dygraph/jit.py:163, dygraph_to_static/), the C++ jit
Layer/serializer (paddle/fluid/jit/layer.h, serializer.cc) and
``save_inference_model`` round trips (python/paddle/fluid/io.py).

``torch.export`` takes the place of ``jax.export``: it runs the port's
Python (``call_op``, the layers) once on fake tensors and records the
aten ops and the kernels' custom ops (``paddle_tpu_torch::
fused_layer_norm``, ``::flash_attention_fwd``) that ran. The body is
first rewritten by :mod:`.dy2static`, so a tensor-dependent ``if`` or
``while`` becomes ``torch.cond`` / ``while_loop``. Captures run under
``static_capture.export_scope()``, where the kernel overrides hold on
any device, so the graph launches the kernels wherever it runs.

* ``to_static`` wraps a callable (or a Layer's forward) in a
  :class:`StaticFunction` that captures the converted body once per
  input signature and runs the captured program, reading the live
  parameters on every call (an optimizer step never leaves stale weights
  baked in). It runs the eager tape instead while parameters need
  gradients, as the JAX one does.
* ``save`` writes three files at ``path``: ``.pdmodel`` (the
  ``torch.export`` artifact, parameters included, stored on the CPU),
  ``.pdiparams`` (the state dict, ``framework/io.py``'s format) and
  ``.meta.json`` (``format_version``, ``platforms``, ``input_specs``). A
  ``None``/``-1`` dimension of an ``InputSpec`` is exported dynamic (the
  dynamic batch); a dimension the trace has to fix raises rather than
  being exported static.
* ``load`` needs the port's op library and no model code: it reads the
  artifact and moves it to the device asked for (the card unless the
  caller asks for the CPU), so an artifact saved on either device runs on
  the other.
"""
from __future__ import annotations

import json
import os
from typing import List

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .._device import resolve_device
from ..framework import io as _io
from ..framework import static_capture as _capture
from ..framework.place import to_torch_device
from ..ops import flash_attention as _flash  # noqa: F401  (custom ops)
from ..ops import layer_norm as _layer_norm  # noqa: F401  (custom ops)
from ..static import InputSpec

__all__ = ["to_static", "save", "load", "TranslatedLayer", "not_to_static",
           "TracedLayer", "set_code_level", "set_verbosity",
           "ProgramTranslator", "enable_to_static", "ignore_module"]

_FORMAT_VERSION = 1

#: the devices an artifact runs on (it is stored on the CPU and moved)
_PLATFORMS = ("cpu", "cuda")

_TENSOR = object()     # a tensor's place in a capture's argument template


class _Capture(torch.nn.Module):
    """What ``torch.export`` traces: ``fn`` on the tensors it is given,
    the non-tensor arguments fixed from ``template``; ``layer`` (when
    there is one) is a submodule, so its parameters and buffers are
    lifted to inputs of the graph, under the prefix ``layer.``."""

    def __init__(self, fn, layer, template):
        super().__init__()
        if layer is not None:
            self.layer = layer
        self._fn = fn
        self._template = template

    def forward(self, *tensors):
        it = iter(tensors)
        return self._fn(*[next(it) if a is _TENSOR else a
                          for a in self._template])


def _export(capture, examples, dynamic_shapes=None):
    """``torch.export`` of ``capture`` on ``examples``, without autograd,
    with the kernel overrides on and no static program recording.
    TorchDynamo traces the branches of ``torch.cond``/``while_loop`` and
    caches what it compiled under the branch function's code, so a later
    export of the same function would reuse a compile made at this
    trace's shapes (a dynamic dimension fixed): an export whose graph
    holds such an op, or that fails, empties that cache after it."""
    clean = False
    try:
        with torch.no_grad(), _capture.paused(), _capture.export_scope():
            ep = torch.export.export(
                capture, tuple(examples),
                dynamic_shapes=None if dynamic_shapes is None
                else {"tensors": dynamic_shapes})
        clean = not any(isinstance(n.target, torch._ops.HigherOrderOperator)
                        for n in ep.graph.nodes)
        return ep
    finally:
        if not clean:
            torch._dynamo.reset()


def _moved(ep, device):
    """``ep`` on ``device``: its weights, constants and every device the
    graph names (an ``arange``'s, a ``to``'s). ``move_to_device_pass``
    edits the graph but leaves each module's generated code as it was,
    so every graph module is recompiled after it."""
    from torch.export.passes import move_to_device_pass
    ep = move_to_device_pass(ep, torch.device(device))
    for m in ep.graph_module.modules():
        if isinstance(m, torch.fx.GraphModule):
            m.recompile()
    return ep


class _Program:
    """An ``ExportedProgram`` run on real tensors: its lifted parameters,
    buffers and constants come from ``state()`` (a name -> tensor
    mapping, read at every call) and ``ep.constants``; the user outputs
    are put back in the structure the traced function returned."""

    def __init__(self, ep, state):
        from torch.export.graph_signature import InputKind, OutputKind
        self.ep = ep
        self._state = state
        sig = ep.graph_signature
        self._inputs = []
        for spec in sig.input_specs:
            if spec.kind == InputKind.USER_INPUT:
                self._inputs.append(None)
            elif spec.kind in (InputKind.PARAMETER, InputKind.BUFFER,
                               InputKind.CONSTANT_TENSOR):
                self._inputs.append(spec.target)
            else:
                raise NotImplementedError(
                    f"an exported program with a {spec.kind} input is not "
                    f"supported")
        self._user = [s.kind == OutputKind.USER_OUTPUT
                      for s in sig.output_specs]

    def __call__(self, *tensors):
        state, it = self._state(), iter(tensors)
        consts = self.ep.constants
        flat = [next(it) if t is None else
                state[t] if t in state else consts[t] for t in self._inputs]
        outs = self.ep.graph_module(*flat)
        user = [o for o, keep in zip(outs, self._user) if keep]
        return pytree.tree_unflatten(user, self.ep.call_spec.out_spec)


def _signature(args):
    """The capture key of ``args``: each tensor's shape, dtype and device;
    every other value itself (its ``repr`` when it cannot be hashed)."""
    key = []
    for a in args:
        if isinstance(a, torch.Tensor):
            key.append(("T", tuple(a.shape), a.dtype, a.device))
        else:
            try:
                hash(a)
                key.append(("V", type(a), a))
            except TypeError:
                key.append(("R", type(a), repr(a)))
    return tuple(key)


class StaticFunction:
    """The ``@to_static`` wrapper: eager-looking call, captured body
    (reference: dygraph_to_static/program_translator.py StaticFunction).

    The converted body is captured by ``torch.export`` once per input
    signature (each tensor's shape, dtype and device, every other
    argument's value) and the captured program runs; a Layer-bound one
    passes the layer's live parameters and buffers to the program at
    every call. Whenever gradients are enabled on the parameters it runs
    the original body on the tape instead, so training through a
    to_static model stays correct, as the JAX package's does."""

    def __init__(self, function, input_spec=None, layer=None):
        self._fn = function
        self._layer = layer
        self.input_spec = list(input_spec) if input_spec else None
        self._programs = {}
        self._conv = None
        self.__name__ = getattr(function, "__name__", "forward")

    def _converted_fn(self):
        """The dy2static-rewritten body: tensor-dependent if/while become
        ``torch.cond`` / ``while_loop`` (reference: the dygraph_to_static
        AST pipeline; here in dy2static.py)."""
        if self._conv is None:
            from .dy2static import convert_to_static
            self._conv = convert_to_static(self._fn)
        return self._conv

    def _get_compiled(self, args=None):
        """The captured program for ``args`` (the latest one without
        them), capturing it at the first call of a signature."""
        if args is None:
            if not self._programs:
                raise RuntimeError(
                    f"{self.__name__} has not been called yet: a program "
                    f"is captured per input signature")
            return next(reversed(self._programs.values()))
        key = _signature(args)
        prog = self._programs.get(key)
        if prog is None:
            template = [_TENSOR if isinstance(a, torch.Tensor) else a
                        for a in args]
            capture = _Capture(self._converted_fn(), self._layer, template)
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            try:
                ep = _export(capture, tensors)
            except Exception as e:   # the trace's errors, by torch version
                from .dy2static import Dy2StaticError, explain_trace_error
                if isinstance(e, Dy2StaticError):
                    raise
                raise explain_trace_error(e, self._fn) from e

            def state(capture=capture):
                return {**dict(capture.named_parameters()),
                        **dict(capture.named_buffers())}

            prog = self._programs[key] = _Program(ep, state)
        return prog

    def _needs_eager(self):
        if not _translator_enabled():
            return True
        if self._layer is None:
            return False
        return torch.is_grad_enabled() and any(
            p.requires_grad for p in self._layer.parameters())

    def __call__(self, *args):
        if self._needs_eager():
            return self._fn(*args)  # training: run on the tape
        prog = self._get_compiled(args)
        return prog(*[a for a in args if isinstance(a, torch.Tensor)])

    # reference-parity introspection hooks
    @property
    def concrete_program(self):
        """The ``torch.export.ExportedProgram`` of the latest signature."""
        return self._get_compiled().ep


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, **kwargs):
    """Decorator/wrapper converting a dygraph callable into a
    :class:`StaticFunction` (reference fluid/dygraph/jit.py:163). On a
    Layer it replaces the layer's ``forward`` and returns the layer."""

    def deco(fn):
        from ..nn.layer.layers import Layer
        if isinstance(fn, Layer):
            sf = StaticFunction(fn.forward, input_spec, layer=fn)
            fn.forward = sf
            return fn
        return StaticFunction(fn, input_spec)

    if function is not None:
        return deco(function)
    return deco


def not_to_static(fn):
    """Marker no-op (reference jit.not_to_static): everything traces."""
    return fn


class ProgramTranslator:
    """Global to_static switch (reference:
    dygraph_to_static/program_translator.py ProgramTranslator). Singleton;
    ``enable(False)`` makes every StaticFunction run its original dygraph
    body."""

    _instance = None
    _enabled = True

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    @classmethod
    def get_instance(cls):
        return cls()

    def enable(self, enable_to_static: bool):
        type(self)._enabled = bool(enable_to_static)

    @property
    def enable_to_static(self):
        return type(self)._enabled


def enable_to_static(enable: bool = True):
    """Reference: paddle.jit.enable_to_static."""
    ProgramTranslator().enable(enable)


def ignore_module(modules):
    """Reference parity no-op: modules are never AST-converted here; only
    the decorated function itself is rewritten."""
    return modules


def _translator_enabled():
    return ProgramTranslator._enabled


def _resolve_specs(input_spec, example_inputs=None):
    specs = []
    for s in (input_spec or []):
        if isinstance(s, InputSpec):
            specs.append(s)
        elif isinstance(s, torch.Tensor):
            specs.append(InputSpec.from_tensor(s))
        else:
            a = np.asarray(s)
            specs.append(InputSpec(a.shape, str(a.dtype)))
    return specs


def _dynamic(d):
    return d is None or d == -1


def _export_dims(specs):
    """``dynamic_shapes`` for ``torch.export``: a ``None``/``-1``
    dimension is ``Dim.AUTO`` (dynamic, related to the others as the
    trace finds: BERT's two ``[None, 128]`` inputs share one batch), any
    other ``Dim.STATIC``."""
    from torch.export import Dim
    return tuple(tuple(Dim.AUTO if _dynamic(d) else Dim.STATIC
                       for d in s.shape) for s in specs)


def _check_dynamic(ep, specs):
    """Raise unless every ``None``/``-1`` dimension of ``specs`` stayed
    symbolic in ``ep`` (a guard in the traced code can fix one)."""
    from torch.export.graph_signature import InputKind
    from torch.fx.experimental.symbolic_shapes import is_concrete_int
    vals = [n.meta["val"] for n in ep.graph.nodes if n.op == "placeholder"]
    kinds = [s.kind for s in ep.graph_signature.input_specs]
    users = [v for v, k in zip(vals, kinds) if k == InputKind.USER_INPUT]
    fixed = [(i, j) for i, (s, v) in enumerate(zip(specs, users))
             for j, d in enumerate(s.shape)
             if _dynamic(d) and is_concrete_int(v.shape[j])]
    if fixed:
        raise ValueError(
            f"jit.save: dimension(s) {fixed} (input, axis) of the input "
            f"specs are None/-1 but the traced code fixes them (a guard "
            f"on the size, or an op that needs a static size there)")


def _examples(specs, device):
    """Zeros shaped like ``specs``, a ``None``/``-1`` dimension at 2 (1
    would be specialized by the trace)."""
    return [torch.zeros([2 if _dynamic(d) else int(d) for d in s.shape],
                        dtype=s.dtype, device=device) for s in specs]


def _device_of(layer):
    for t in list(layer.parameters()) + list(layer.buffers()):
        return t.device
    return to_torch_device(None)


def save(layer, path, input_spec=None, **configs):
    """Export ``layer`` (or a StaticFunction / plain callable) for
    inference. Reference: jit.save -> program + params
    (fluid/dygraph/jit.py, fluid/jit/serializer.cc). The trace runs on
    the device of the layer's parameters (the current place for a plain
    callable), in eval mode, under whatever ``amp.auto_cast`` the caller
    holds (its casts are recorded)."""
    from ..nn.layer.layers import Layer
    from .dy2static import convert_to_static

    module = None
    if isinstance(layer, Layer):
        was_training = layer.training
        layer.eval()
        fn = layer.forward
        if isinstance(fn, StaticFunction):
            if input_spec is None:
                input_spec = fn.input_spec
            fn = fn._converted_fn()
        else:
            fn = convert_to_static(fn)
        module, device = layer, _device_of(layer)
        state = layer.state_dict()
    elif isinstance(layer, StaticFunction):
        was_training = None
        fn = layer._converted_fn()
        input_spec = input_spec or layer.input_spec
        if layer._layer is not None:
            module = layer._layer
        device = _device_of(module) if module is not None \
            else to_torch_device(None)
        state = {}
    else:
        was_training = None
        fn = convert_to_static(layer)
        device = to_torch_device(None)
        state = {}
    try:
        if not input_spec:
            raise ValueError(
                "jit.save needs input_spec=[InputSpec(shape, dtype), ...] "
                "(or example Tensors) to trace the export")
        specs = _resolve_specs(input_spec)
        capture = _Capture(fn, module, [_TENSOR] * len(specs))
        ep = _export(capture, _examples(specs, device),
                     _export_dims(specs))
        _check_dynamic(ep, specs)
        if device.type != "cpu":
            ep = _moved(ep, "cpu")

        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                    exist_ok=True)
        with open(path + ".pdmodel", "wb") as f:
            torch.export.save(ep, f)
        _io.save(state, path + ".pdiparams")
        meta = {
            "format_version": _FORMAT_VERSION,
            "platforms": list(_PLATFORMS),
            "input_specs": [{"shape": [None if _dynamic(d) else int(d)
                                       for d in s.shape],
                             "dtype": str(s.dtype).replace("torch.", ""),
                             "name": s.name} for s in specs],
        }
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)
    finally:
        if was_training:
            layer.train()
    return path


class TranslatedLayer:
    """A loaded inference program (reference: TranslatedLayer of
    jit.load / the C++ jit::Layer). Callable on tensors or arrays (moved
    to its device); no Python model code is involved: the program's
    aten ops and the kernels' custom ops run as recorded."""

    def __init__(self, exported, state, meta, device=None):
        self._exported = exported
        self._state = state
        self._meta = meta
        self.device = torch.device(device) if device is not None \
            else torch.device("cpu")
        weights = dict(exported.state_dict)
        self._program = _Program(exported, lambda: weights)
        self.training = False

    def __call__(self, *args):
        specs = self.input_specs
        ins = []
        for i, a in enumerate(args):
            if not isinstance(a, torch.Tensor):
                a = torch.as_tensor(np.asarray(a))
            if i < len(specs) and specs[i].get("dtype"):
                a = a.to(getattr(torch, specs[i]["dtype"]))
            ins.append(a.to(self.device))
        with torch.no_grad():
            return self._program(*ins)

    forward = __call__

    def state_dict(self):
        return self._state

    def eval(self):
        self.training = False
        return self

    @property
    def input_specs(self) -> List[dict]:
        return self._meta.get("input_specs", [])

    @property
    def input_names(self) -> List[str]:
        return [s.get("name") or f"input_{i}"
                for i, s in enumerate(self.input_specs)]

    @property
    def platforms(self):
        return tuple(self._meta.get("platforms", ()))


def load(path, *, device=None, **configs) -> TranslatedLayer:
    """Load a ``jit.save`` artifact into a runnable predictor on
    ``device`` (``None``: the card, which raises without one; pass
    ``"cpu"`` for the CPU)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        resolve_device(None)            # raises, naming the CPU option
    with open(path + ".pdmodel", "rb") as f:
        ep = torch.export.load(f)
    if dev.type != "cpu":
        ep = _moved(ep, dev)
    state = {}
    if os.path.exists(path + ".pdiparams"):
        state = _io.load(path + ".pdiparams")
    meta = {}
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    return TranslatedLayer(ep, state, meta, dev)


# --------------------------------------------------------------------------
# dy2static logging knobs + legacy TracedLayer (reference jit/api.py)
# --------------------------------------------------------------------------

def set_verbosity(level=0, also_to_stdout=False):
    """Reference jit.set_verbosity: dy2static transform log level."""
    import logging
    logger = logging.getLogger("paddle_tpu_torch.dy2static")
    logger.setLevel(max(logging.DEBUG,
                        logging.WARNING - 10 * int(level)))
    if also_to_stdout and not logger.handlers:
        import sys
        logger.addHandler(logging.StreamHandler(sys.stdout))


def set_code_level(level=100, also_to_stdout=False):
    """Reference jit.set_code_level: log the transformed code. The AST
    converter (jit/dy2static.py) logs its rewritten source at DEBUG; this
    lowers the logger to show it."""
    set_verbosity(3 if level else 0, also_to_stdout)


class TracedLayer:
    """Legacy trace API (reference fluid/dygraph/jit.py TracedLayer):
    ``TracedLayer.trace(layer, inputs)`` -> (outputs, traced); the traced
    object runs the layer and exports via ``save_inference_model``."""

    def __init__(self, layer, example_inputs):
        self._layer = layer
        self._examples = list(example_inputs)

    @classmethod
    def trace(cls, layer, inputs):
        traced = cls(layer, inputs)
        outputs = traced(*inputs)
        return outputs, traced

    def __call__(self, *inputs):
        return self._layer(*inputs)

    def save_inference_model(self, path, feed=None, fetch=None, **kwargs):
        if feed is not None or fetch is not None:
            import warnings
            warnings.warn(
                "TracedLayer.save_inference_model feed=/fetch= subsetting "
                "is not supported; exporting the FULL traced signature",
                UserWarning, stacklevel=2)
        specs = [InputSpec.from_tensor(t) for t in self._examples]
        was_training = self._layer.training
        self._layer.eval()
        try:
            return save(self._layer, path, input_spec=specs)
        finally:
            self._layer.train() if was_training else self._layer.eval()
