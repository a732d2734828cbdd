"""Program-level quantization over the recorded static graph
(counterpart of ``paddle_tpu/quantization/passes.py``).

A ``static.Program`` replays its recorded node list, so "inserting a
quant/dequant op" is wrapping a node's function: the wrapped function
fake-quantizes the node's weight per output channel and its activation
per tensor, then runs the op. Calibration replays the program eagerly
with an observer that reads each quantizable node's activation abs-max
(or a percentile of it), one replay a feed.

Finding the weight: the port's ``Linear`` stores ``[out, in]`` and hands
``weight.t()`` to the ``linear`` op, and the recorder takes that ``t``
as a node of its own. So a ``linear`` node's weight operand is the
output of a ``t`` node of a parameter, not the parameter: the pass
resolves it through the ``t`` node. The operand it quantizes is then the
``[in, out]`` one the op reads, whose last axis is the output channel,
as in the JAX package.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

__all__ = ["QuantizationTransformPass", "PostTrainingQuantizationProgram",
           "calibrate_program"]

# ops whose (activation, weight) operands take the quant/dequant
# simulation; the value is the weight operand's output-channel axis
_QUANTIZABLE = {"conv2d": 0, "linear": -1, "matmul": -1}


def _transposed_params(program) -> set:
    """Ids of the recorded ``t`` outputs of parameters."""
    out = set()
    for node in program._nodes:
        ts = [v for tid, v, _ in node.inputs if tid is not None]
        if node.torch_function and node.op == "t" and len(ts) == 1 \
                and isinstance(ts[0], torch.nn.Parameter):
            out.update(node.out_ids)
    return out


def _weight_and_act_indices(node, t_params=frozenset()):
    """The leaf indices of the weight (a parameter of rank >= 2, or a
    ``t`` of one) and of the activation (the first other tensor operand)
    of a recorded node."""
    widx = aidx = None
    for j, (tid, value, _) in enumerate(node.inputs):
        if tid is None:
            continue
        is_param = isinstance(value, torch.nn.Parameter) or tid in t_params
        if is_param and widx is None and (
                tid in t_params or value.dim() >= 2):
            widx = j
        elif not is_param and aidx is None:
            aidx = j
    return widx, aidx


def _fake_quant_sim(x, scale, bits):
    """Symmetric quant -> dequant with a straight-through gradient."""
    qmax = float(2 ** (bits - 1) - 1)
    s = torch.clamp_min(torch.as_tensor(scale, device=x.device).to(x.dtype),
                        1e-8)
    q = torch.round(torch.minimum(torch.maximum(x, -s), s) / s * qmax) \
        * s / qmax
    return x + (q - x).detach()


def _quant_weight_sim(w, axis, bits):
    """Per-output-channel symmetric quant -> dequant of a weight."""
    qmax = float(2 ** (bits - 1) - 1)
    axes = tuple(i for i in range(w.dim()) if i != axis % w.dim())
    scale = w.abs().amax(dim=axes, keepdim=True)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.round(torch.minimum(torch.maximum(w, -scale), scale) / scale
                    * qmax)
    return (q * scale / qmax).to(w.dtype)


class QuantizationTransformPass:
    """Rewrite a Program so that every quantizable node runs the int8
    simulation.

    With ``act_scales`` (node index -> float, from calibration) the
    activation quantizer uses frozen scales (the PTQ program); without,
    the scale is the live tensor's abs-max (QAT on a static program).
    """

    def __init__(self, weight_bits: int = 8, activation_bits: int = 8,
                 quantizable_op_type: Sequence[str] = tuple(_QUANTIZABLE)):
        unknown = set(quantizable_op_type) - set(_QUANTIZABLE)
        if unknown:
            raise ValueError(f"cannot quantize op types {sorted(unknown)}; "
                             f"supported: {sorted(_QUANTIZABLE)}")
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.op_types = set(quantizable_op_type)

    def _wrap(self, node, act_scale: Optional[float], t_params=frozenset()):
        from ..framework import static_capture as _capture

        widx, aidx = _weight_and_act_indices(node, t_params)
        axis = _QUANTIZABLE[node.op]
        inner, wbits, abits = node.fn, self.weight_bits, self.activation_bits

        def quantized_fn(*args, **attrs):
            leaves, spec = pytree.tree_flatten((tuple(args), dict(attrs)))
            if widx is not None:
                leaves[widx] = _quant_weight_sim(leaves[widx], axis, wbits)
            if aidx is not None:
                x = leaves[aidx]
                s = x.abs().amax() if act_scale is None else act_scale
                leaves[aidx] = _fake_quant_sim(x, s, abits)
            args, attrs = pytree.tree_unflatten(leaves, spec)
            return inner(*args, **attrs)

        attrs = dict(node.attrs)
        attrs["quantized"] = {"weight_bits": wbits, "act_bits": abits,
                              "act_scale": act_scale, "channel_axis": axis,
                              "weight_operand": widx}
        return _capture.OpNode(node.op, quantized_fn, node.inputs,
                               node.out_ids, attrs, node.spec,
                               node.torch_function)

    def _quantizable(self, node):
        return node.op in self.op_types and not node.torch_function

    def apply(self, program, act_scales: Optional[Dict[int, float]] = None):
        """A for-test clone of ``program`` with the quantizable nodes
        rewritten; the original is untouched."""
        act_scales = act_scales or {}
        t_params = _transposed_params(program)
        out = program.clone(for_test=True)
        out._nodes = [
            self._wrap(n, act_scales.get(i), t_params)
            if self._quantizable(n) else n
            for i, n in enumerate(program._nodes)]
        quantized = [i for i, n in enumerate(program._nodes)
                     if self._quantizable(n)]
        out._quant_info = {"nodes": quantized,
                           "weight_bits": self.weight_bits,
                           "act_bits": self.activation_bits,
                           "act_scales": dict(act_scales)}
        return out


def calibrate_program(program, feed_list: Iterable[Dict[str, np.ndarray]],
                      quantizable_op_type: Sequence[str] =
                      tuple(_QUANTIZABLE),
                      algo: str = "abs_max",
                      percentile: float = 99.99) -> Dict[int, float]:
    """Replay ``program`` over the calibration feeds, recording an
    activation scale per quantizable node: ``abs_max`` (the largest over
    every batch) or ``percentile`` (that percentile of ``|x|`` a batch,
    the largest over the batches)."""
    if algo not in ("abs_max", "percentile"):
        raise ValueError(f"unknown calibration algo {algo!r}")
    from ..framework import static_capture as _capture
    op_types = set(quantizable_op_type)
    t_params = _transposed_params(program)
    scales: Dict[int, float] = {}

    def observer(i, node, ins):
        if node.op not in op_types or node.torch_function:
            return
        _, aidx = _weight_and_act_indices(node, t_params)
        if aidx is None:
            return
        x = ins[aidx].detach().abs()
        cur = float(np.percentile(x.float().cpu().numpy(), percentile)) \
            if algo == "percentile" else float(x.amax())
        scales[i] = max(scales.get(i, 0.0), cur)

    with torch.no_grad(), _capture.paused():
        for feed in feed_list:
            feeds = {k: program._feed_tensor(k, v) for k, v in feed.items()
                     if k in program._feeds}
            program._forward_env(feeds, _observer=observer)
    return scales


class PostTrainingQuantizationProgram:
    """Program PTQ: calibrate, transform, and return the quantized
    inference program. ``feed_list`` is an iterable of Executor-style
    feed dicts covering the program's ``static.data`` inputs."""

    def __init__(self, program, feed_list,
                 weight_bits: int = 8, activation_bits: int = 8,
                 quantizable_op_type: Sequence[str] = tuple(_QUANTIZABLE),
                 algo: str = "abs_max", percentile: float = 99.99):
        self.program = program
        self.feed_list = list(feed_list)
        if not self.feed_list:
            raise ValueError("PTQ needs at least one calibration feed")
        self.pass_ = QuantizationTransformPass(
            weight_bits, activation_bits, quantizable_op_type)
        self.quantizable_op_type = quantizable_op_type
        self.algo = algo
        self.percentile = percentile
        self.scales: Dict[int, float] = {}

    def quantize(self):
        self.scales = calibrate_program(
            self.program, self.feed_list, self.quantizable_op_type,
            self.algo, self.percentile)
        return self.pass_.apply(self.program, self.scales)
