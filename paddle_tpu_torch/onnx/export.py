"""ONNX export of captured inference graphs (counterpart of
``paddle_tpu/onnx/export.py``).

Reference: python/paddle/onnx/export.py -> paddle2onnx (op-by-op mapping
of a traced Program to ONNX). The graph comes from the static-capture
recorder that powers ``static`` (``framework/static_capture.py``): the
layer runs once on placeholders while a ``Program`` records, and the
ModelProto is written by the protobuf writer in ``proto.py`` (no onnx
package needed).

The recorded node list holds two kinds of node. A ``call_op`` node
carries the registry op's name and arguments, which bind to the op's
plain signature: the tensors become the ONNX node's inputs, in that
order, and the rest its attributes, as the JAX exporter's handlers read
them. A torch-function node (``framework/static_capture.py`` records
the torch functions called outside an op: a residual ``x + y``, a
``w.t()``) is mapped by the function's name (``add``/``__add__`` ->
``Add``, ...). ``Linear`` stores its weight as ``[out, in]`` and hands
the ``linear`` op its transpose: the ``t`` node over such a parameter
folds into the initializer, which holds the weight ``[in, out]`` as the
JAX exporter writes it. Initializers are named by the layer's
structured parameter names, then the program's.

Coverage, as the JAX exporter's: the inference op set of the vision zoo
and MLPs (conv/BN/pools/linear/activations/reshape family/elementwise).
An unmapped op raises ``OnnxExportError`` naming it, as paddle2onnx does
for an unsupported op.
"""
from __future__ import annotations

import inspect
from typing import Dict

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..framework.dtypes import dtype_name
from .proto import DTYPE_MAP, Graph, Model, Node, TensorProto, ValueInfo

__all__ = ["export"]


class OnnxExportError(NotImplementedError):
    pass


def _pair(v):
    if isinstance(v, (list, tuple)):
        return [int(v[0]), int(v[1])]
    return [int(v), int(v)]


def _pads4(padding):
    if isinstance(padding, str):
        raise OnnxExportError(
            f"string padding {padding!r} is not supported in ONNX export")
    ph, pw = _pair(padding)
    return [ph, pw, ph, pw]


class _Emitter:
    def __init__(self, graph: Graph):
        self.graph = graph
        self._tmp = 0

    def fresh(self, hint="t"):
        self._tmp += 1
        return f"{hint}_{self._tmp}"

    def node(self, op_type, inputs, outputs, **attrs):
        self.graph.nodes.append(
            Node(op_type, inputs, outputs,
                 name=self.fresh(op_type.lower()), attrs=attrs or None))

    def const(self, array, hint="const"):
        name = self.fresh(hint)
        self.graph.initializers.append(
            TensorProto(name, np.asarray(array)))
        return name


def _nchw_only(attrs, op):
    df = attrs.get("data_format", "NCHW")
    if not str(df).startswith("NC"):
        raise OnnxExportError(
            f"{op}: ONNX export supports channel-first only, got {df!r}")


# each handler: (emitter, in_names, out_names, attrs, in_values) -> None

def _op_linear(e, ins, outs, attrs, vals):
    if len(ins) >= 3:  # x, w, b
        tmp = e.fresh("matmul")
        e.node("MatMul", [ins[0], ins[1]], [tmp])
        e.node("Add", [tmp, ins[2]], [outs[0]])
    else:
        e.node("MatMul", [ins[0], ins[1]], [outs[0]])


def _op_conv2d(e, ins, outs, attrs, vals):
    _nchw_only(attrs, "conv2d")
    e.node("Conv", ins[:3] if len(ins) >= 3 else ins[:2], [outs[0]],
           strides=_pair(attrs.get("stride", 1)),
           pads=_pads4(attrs.get("padding", 0)),
           dilations=_pair(attrs.get("dilation", 1)),
           group=int(attrs.get("groups", 1)))


def _op_batch_norm(e, ins, outs, attrs, vals):
    if attrs.get("training"):
        raise OnnxExportError(
            "batch_norm in training mode cannot export; call model.eval()")
    _nchw_only(attrs, "batch_norm")
    # ours: (x, mean, var, weight, bias) -> onnx: (X, scale, B, mean, var)
    x, mean, var = ins[0], ins[1], ins[2]
    scale = ins[3] if len(ins) > 3 else e.const(
        np.ones(1, np.float32), "bn_scale")
    bias = ins[4] if len(ins) > 4 else e.const(
        np.zeros(1, np.float32), "bn_bias")
    e.node("BatchNormalization", [x, scale, bias, mean, var], [outs[0]],
           epsilon=float(attrs.get("epsilon", 1e-5)),
           momentum=float(attrs.get("momentum", 0.9)))


def _op_max_pool2d(e, ins, outs, attrs, vals):
    _nchw_only(attrs, "max_pool2d")
    k = _pair(attrs.get("kernel_size"))
    e.node("MaxPool", [ins[0]], [outs[0]],
           kernel_shape=k,
           strides=_pair(attrs.get("stride") or k),
           pads=_pads4(attrs.get("padding", 0)),
           ceil_mode=int(bool(attrs.get("ceil_mode", False))))


def _op_avg_pool2d(e, ins, outs, attrs, vals):
    _nchw_only(attrs, "avg_pool2d")
    k = _pair(attrs.get("kernel_size"))
    e.node("AveragePool", [ins[0]], [outs[0]],
           kernel_shape=k,
           strides=_pair(attrs.get("stride") or k),
           pads=_pads4(attrs.get("padding", 0)),
           ceil_mode=int(bool(attrs.get("ceil_mode", False))),
           count_include_pad=int(not attrs.get("exclusive", True)))


def _op_adaptive_avg_pool2d(e, ins, outs, attrs, vals):
    _nchw_only(attrs, "adaptive_avg_pool2d")
    size = attrs.get("output_size")
    size = _pair(size) if not isinstance(size, int) else [size, size]
    if size != [1, 1]:
        raise OnnxExportError(
            f"adaptive_avg_pool2d: only output_size (1,1) maps to ONNX "
            f"(GlobalAveragePool), got {size}")
    e.node("GlobalAveragePool", [ins[0]], [outs[0]])


def _op_flatten(e, ins, outs, attrs, vals):
    start = int(attrs.get("start_axis", 0))
    stop = int(attrs.get("stop_axis", -1))
    if stop != -1:
        raise OnnxExportError(
            f"flatten(stop_axis={stop}) has no direct ONNX mapping")
    if start == 1:
        # ONNX Flatten collapses ALL leading dims into one: the same as
        # paddle's flatten only for start_axis == 1
        e.node("Flatten", [ins[0]], [outs[0]], axis=1)
    elif start == 0:
        shape_name = e.const(np.asarray([-1], np.int64), "shape")
        e.node("Reshape", [ins[0], shape_name], [outs[0]])
    else:
        raise OnnxExportError(
            f"flatten(start_axis={start}) has no ONNX mapping "
            "(Flatten collapses all leading dims)")


def _op_reshape(e, ins, outs, attrs, vals):
    dims = [int(d) for d in attrs.get("shape")]
    # the graph was traced at batch 1: a leading 1 is (almost always) the
    # collapsed batch placeholder. ONNX's 0 ("copy the input's dim")
    # keeps the Reshape right at any batch; -1 means infer in both
    if dims and dims[0] == 1:
        dims[0] = 0
    shape_name = e.const(np.asarray(dims, np.int64), "shape")
    e.node("Reshape", [ins[0], shape_name], [outs[0]])


def _op_transpose(e, ins, outs, attrs, vals):
    e.node("Transpose", [ins[0]], [outs[0]],
           perm=[int(p) for p in attrs.get("perm")])


def _swap_last2_perm(ndim):
    perm = list(range(ndim))
    perm[-1], perm[-2] = perm[-2], perm[-1]
    return perm


def _op_matmul(e, ins, outs, attrs, vals):
    x, y = ins[0], ins[1]
    # transpose_x/y swap only the LAST TWO axes: an explicit perm from
    # the traced rank (a bare Transpose reverses every dim)
    if attrs.get("transpose_x"):
        t = e.fresh("tx")
        e.node("Transpose", [x], [t], perm=_swap_last2_perm(vals[0].dim()))
        x = t
    if attrs.get("transpose_y"):
        t = e.fresh("ty")
        e.node("Transpose", [y], [t], perm=_swap_last2_perm(vals[1].dim()))
        y = t
    e.node("MatMul", [x, y], [outs[0]])


def _op_softmax(e, ins, outs, attrs, vals):
    e.node("Softmax", [ins[0]], [outs[0]],
           axis=int(attrs.get("axis", -1)))


def _op_mean(e, ins, outs, attrs, vals):
    axis = attrs.get("axis")
    kw = {"keepdims": int(bool(attrs.get("keepdim", False)))}
    if axis is not None:
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        kw["axes"] = [int(a) for a in axes]
    e.node("ReduceMean", [ins[0]], [outs[0]], **kw)


def _op_scale(e, ins, outs, attrs, vals):
    cur = ins[0]
    s = float(attrs.get("scale", 1.0))
    b = float(attrs.get("bias", 0.0))
    bias_after = bool(attrs.get("bias_after_scale", True))

    def mul(x):
        if s == 1.0:
            return x
        tmp = e.fresh("scaled")
        e.node("Mul", [x, e.const(np.float32(s))], [tmp])
        return tmp

    def add(x):
        if b == 0.0:
            return x
        tmp = e.fresh("shifted")
        e.node("Add", [x, e.const(np.float32(b))], [tmp])
        return tmp

    # reference semantics: x*s + b when bias_after_scale else (x + b)*s
    cur = add(mul(cur)) if bias_after else mul(add(cur))
    e.node("Identity", [cur], [outs[0]])


def _op_gelu(e, ins, outs, attrs, vals):
    if attrs.get("approximate"):
        raise OnnxExportError("gelu(approximate=True) has no mapping here "
                              "(the erf form is exported)")
    # 0.5 * x * (1 + erf(x / sqrt(2))): the opset < 20 decomposition
    x = ins[0]
    div = e.fresh("gelu_div")
    e.node("Div", [x, e.const(np.float32(np.sqrt(2.0)))], [div])
    erf = e.fresh("gelu_erf")
    e.node("Erf", [div], [erf])
    one = e.fresh("gelu_1p")
    e.node("Add", [erf, e.const(np.float32(1.0))], [one])
    halfx = e.fresh("gelu_halfx")
    e.node("Mul", [x, e.const(np.float32(0.5))], [halfx])
    e.node("Mul", [halfx, one], [outs[0]])


def _op_embedding(e, ins, outs, attrs, vals):
    # embedding(ids, weight), as F.embedding(x, weight)
    if attrs.get("padding_idx") not in (None, -1):
        raise OnnxExportError(
            "embedding with padding_idx has no direct ONNX mapping")
    e.node("Gather", [ins[1], ins[0]], [outs[0]], axis=0)


def _op_relu6(e, ins, outs, attrs, vals):
    e.node("Clip",
           [ins[0], e.const(np.float32(0.0)), e.const(np.float32(6.0))],
           [outs[0]])


def _op_layer_norm(e, ins, outs, attrs, vals):
    if attrs.get("begin_norm_axis") not in (None, vals[0].dim() - 1):
        raise OnnxExportError("layer_norm over more than the last axis")
    # opset 17 LayerNormalization(X, Scale, B)
    e.node("LayerNormalization", ins[:3], [outs[0]],
           epsilon=float(attrs.get("epsilon", 1e-5)), axis=-1)


def _op_concat(e, ins, outs, attrs, vals):
    e.node("Concat", ins, [outs[0]], axis=int(attrs.get("axis", 0)))


def _simple(op_type):
    def f(e, ins, outs, attrs, vals):
        e.node(op_type, ins, [outs[0]])
    return f


#: the registry ops, keyed by op name (the JAX exporter's table)
_HANDLERS = {
    "linear": _op_linear,
    "conv2d": _op_conv2d,
    "batch_norm": _op_batch_norm,
    "max_pool2d": _op_max_pool2d,
    "avg_pool2d": _op_avg_pool2d,
    "adaptive_avg_pool2d": _op_adaptive_avg_pool2d,
    "flatten": _op_flatten,
    "reshape": _op_reshape,
    "transpose": _op_transpose,
    "matmul": _op_matmul,
    "softmax": _op_softmax,
    "mean": _op_mean,
    "scale": _op_scale,
    "gelu": _op_gelu,
    "embedding": _op_embedding,
    "layer_norm": _op_layer_norm,
    "relu": _simple("Relu"),
    "relu6": _op_relu6,
    "sigmoid": _simple("Sigmoid"),
    "tanh": _simple("Tanh"),
    "exp": _simple("Exp"),
    "sqrt": _simple("Sqrt"),
    "add": _simple("Add"),
    "subtract": _simple("Sub"),
    "multiply": _simple("Mul"),
    "divide": _simple("Div"),
    "pow": _simple("Pow"),
    "maximum": _simple("Max"),
    "minimum": _simple("Min"),
    "concat": _op_concat,
}

#: torch functions the recorder records outside ops, by ``__name__``:
#: the ONNX op and whether the operands come swapped (``__rsub__``)
_TORCH_BINARY = {
    "add": ("Add", False), "__add__": ("Add", False),
    "__radd__": ("Add", True), "sub": ("Sub", False),
    "__sub__": ("Sub", False), "__rsub__": ("Sub", True),
    "mul": ("Mul", False), "__mul__": ("Mul", False),
    "__rmul__": ("Mul", True), "div": ("Div", False),
    "__truediv__": ("Div", False), "__rtruediv__": ("Div", True),
    "matmul": ("MatMul", False), "__matmul__": ("MatMul", False),
    "__rmatmul__": ("MatMul", True), "pow": ("Pow", False),
    "__pow__": ("Pow", False), "maximum": ("Max", False),
    "minimum": ("Min", False),
}
_TORCH_UNARY = {
    "relu": "Relu", "tanh": "Tanh", "sigmoid": "Sigmoid", "exp": "Exp",
    "sqrt": "Sqrt", "neg": "Neg", "__neg__": "Neg", "erf": "Erf",
    "contiguous": "Identity", "clone": "Identity", "detach": "Identity",
}


def _torch_node(e, name, args, kwargs, ins, outs, vals):
    """A torch-function node: ``args`` holds ``_In`` markers for the
    tensor operands (``ins`` their names, ``vals`` their values)."""
    if name in _TORCH_BINARY:
        op, swap = _TORCH_BINARY[name]
        operands = []
        for a in args[:2]:
            if isinstance(a, _In):
                operands.append(ins[a.i])
            else:  # a Python scalar beside a tensor
                dtype = vals[0].dtype
                operands.append(e.const(np.asarray(
                    a, np.float32 if dtype.is_floating_point else
                    np.int64)))
        e.node(op, operands[::-1] if swap else operands, [outs[0]])
    elif name in _TORCH_UNARY:
        e.node(_TORCH_UNARY[name], [ins[0]], [outs[0]])
    elif name == "t":
        e.node("Transpose", [ins[0]], [outs[0]], perm=[1, 0])
    elif name in ("reshape", "view"):
        shape = args[1:] if len(args) > 2 else args[1]
        _op_reshape(e, ins, outs, {"shape": list(shape)}, vals)
    elif name == "flatten":
        start = args[1] if len(args) > 1 else kwargs.get("start_dim", 0)
        stop = args[2] if len(args) > 2 else kwargs.get("end_dim", -1)
        _op_flatten(e, ins, outs, {"start_axis": start, "stop_axis": stop},
                    vals)
    else:
        raise OnnxExportError(
            f"torch function {name!r} has no ONNX mapping (paddle2onnx "
            f"analog would list it as unsupported)")


class _In:
    """Marks the ``i``-th tensor operand of a node in its arguments."""

    def __init__(self, i):
        self.i = i


def _args(node):
    """The node's ``(args, kwargs)`` with each tensor as an ``_In``, and
    the tensors' ``(tensor_id, value, cast)`` leaves in order."""
    leaves, tensors = [], []
    for tid, value, cast in node.inputs:
        if tid is None:
            leaves.append(value)
        else:
            leaves.append(_In(len(tensors)))
            tensors.append((tid, value, cast))
    args, kwargs = pytree.tree_unflatten(leaves, node.spec)
    return args, kwargs, tensors


def _op_attrs(name, args, kwargs):
    """The registry op's arguments bound to its plain signature: the
    non-tensor ones (``None`` left out) by parameter name."""
    from ..ops.registry import get_op
    try:
        sig = inspect.signature(get_op(name).fn)
    except ValueError:      # a builtin body (torch.relu): keywords only
        return {k: v for k, v in kwargs.items() if v is not None}
    bound = sig.bind(*args, **kwargs)
    attrs = {}
    for key, value in bound.arguments.items():
        kind = bound.signature.parameters[key].kind
        if kind == inspect.Parameter.VAR_KEYWORD:
            attrs.update(value)
        elif value is not None and not pytree.tree_any(
                lambda v: isinstance(v, _In), value):
            attrs[key] = value
    return attrs


def _structured_names(layer) -> Dict[int, str]:
    if not isinstance(layer, torch.nn.Module):
        return {}
    return {id(p): n for n, p in layer.named_parameters()}


def _device_of(layer):
    from ..framework.place import to_torch_device
    if isinstance(layer, torch.nn.Module):
        for p in layer.parameters():
            return p.device
    return to_torch_device(None)


def export(layer, path, input_spec=None, opset_version=17, **configs):
    """Trace ``layer`` through the static-capture recorder (once, in eval
    mode, on its parameters' device) and write ``path + '.onnx'``.
    ``input_spec``: ``[InputSpec(shape, dtype)]``; a ``None`` leading dim
    becomes the symbolic batch dimension. Returns the written path."""
    from ..framework import static_capture as _capture
    from ..static import InputSpec, Program, program_guard

    if not input_spec:
        raise ValueError(
            "onnx.export needs input_spec=[InputSpec(shape, dtype), ...]")
    was_training = getattr(layer, "training", False)
    if hasattr(layer, "eval"):
        layer.eval()
    device = _device_of(layer)
    try:
        prog = Program()
        with program_guard(prog), torch.no_grad():
            for i, spec in enumerate(input_spec):
                if isinstance(spec, torch.Tensor):
                    spec = InputSpec.from_tensor(spec)
                shape = list(spec.shape)
                # the capture runs dynamic dims at 1 and only dim 0 is
                # exported symbolic: a dynamic dim anywhere else would be
                # silently frozen at 1
                if any(d in (None, -1) for d in shape[1:]):
                    raise OnnxExportError(
                        f"input {i}: only the leading (batch) dim may be "
                        f"dynamic in ONNX export, got shape {shape}")
                var = torch.zeros([1 if d in (None, -1) else int(d)
                                   for d in shape], dtype=spec.dtype,
                                  device=device)
                prog._add_feed(spec.name or f"x{i}", var, shape)
            feeds = [prog._vars[tid] for tid in prog._feeds.values()]
            out = layer(*feeds)
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        with _capture.paused():
            graph = _graph(layer, prog, outs)
        model = Model(graph, opset=opset_version,
                      producer="paddle-tpu-torch")
        out_path = path if path.endswith(".onnx") else path + ".onnx"
        with open(out_path, "wb") as f:
            f.write(model.encode())
        return out_path
    finally:
        if was_training and hasattr(layer, "train"):
            layer.train()


def _graph(layer, prog, outs) -> Graph:
    from ..static.extras import _jax_layout
    transposed = prog._transposed()
    graph = Graph(type(layer).__name__)
    e = _Emitter(graph)
    names: Dict[int, str] = {}
    for fname, tid in prog._feeds.items():
        names[tid] = fname
    structured = _structured_names(layer)
    stored: Dict[int, str] = {}   # transposed-stored params: [out, in]
    for pname, p in prog._params.items():
        name = structured.get(id(p), pname)
        if id(p) in transposed:
            stored[id(p)] = name
        else:
            names[id(p)] = name
        graph.initializers.append(TensorProto(
            name, _jax_layout(p, id(p) in transposed).cpu().numpy()))

    def name_of(tid, value, cast):
        if tid in stored and tid not in names:
            # a transposed-stored weight read as stored: transpose back
            names[tid] = e.fresh("stored")
            e.node("Transpose", [stored[tid]], [names[tid]], perm=[1, 0])
        if tid not in names:
            # a captured constant (a buffer, a literal): an initializer
            arr = value.detach().cpu()
            if arr.dtype == torch.bfloat16:
                raise OnnxExportError("a bfloat16 constant cannot export")
            names[tid] = e.const(arr.numpy(), "c")
        name = names[tid]
        if cast is not None:
            code = DTYPE_MAP[dtype_name(cast)]
            casted = e.fresh("cast")
            e.node("Cast", [name], [casted], to=code)
            name = casted
        return name

    for node in prog._nodes:
        args, kwargs, tensors = _args(node)
        vals = [value for _, value, _ in tensors]
        if node.torch_function and node.op == "t" and tensors and \
                tensors[0][0] in stored:
            # Linear's weight.t(): the JAX-layout initializer itself
            names.setdefault(node.out_ids[0], stored[tensors[0][0]])
            continue
        ins = [name_of(*leaf) for leaf in tensors]
        out_names = []
        for tid in node.out_ids:
            names.setdefault(tid, e.fresh("t"))
            out_names.append(names[tid])
        if node.torch_function:
            _torch_node(e, node.op, args, kwargs, ins, out_names, vals)
        elif node.op in _HANDLERS:
            _HANDLERS[node.op](e, ins, out_names,
                               _op_attrs(node.op, args, kwargs), vals)
        else:
            raise OnnxExportError(
                f"op {node.op!r} has no ONNX mapping (paddle2onnx analog "
                f"would list it as unsupported)")

    for fname, tid in prog._feeds.items():
        t = prog._vars[tid]
        shape = [("batch" if i == 0 and s == 1 else s)
                 for i, s in enumerate(t.shape)]
        # dim 0 is exported symbolic so that any batch size runs
        graph.inputs.append(ValueInfo(fname, dtype_name(t.dtype), shape))
    for i, t in enumerate(outs):
        if id(t) not in names:
            raise OnnxExportError(
                f"model output {i} was not produced by a captured op")
        shape = ["batch" if j == 0 else s for j, s in enumerate(t.shape)]
        graph.outputs.append(
            ValueInfo(names[id(t)], dtype_name(t.dtype), shape))
    return graph
