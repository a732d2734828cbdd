"""``quantization`` (counterpart of ``paddle_tpu/quantization/
__init__.py``): quantization-aware training, post-training quantization
and the int8-weight inference layers.

Fake quantization is the straight-through estimator ``x + (q -
x).detach()``, computed in the input's dtype in the JAX package's order
(clip, divide, times ``qmax``, round half to even, times the scale,
divided by ``qmax``). The observers keep their state on the device: the
moving average is a ``torch.where`` into a float32 buffer, with no read
to the host, so a QAT step syncs no more than a float one.
``PostTrainingQuantization.collect`` reads one float per layer and batch,
as the JAX package does: calibration is not a training step.

The inference layers are weight-only, as in the JAX package: int8
weights with per-output-channel float32 scales, dequantized into the
compute dtype at each forward; activations stay float. A ``Linear``'s
weight is ``[out, in]`` in the port (``[in, out]`` in the JAX package),
so its int8 weight is ``[out, in]`` and its scale ``[out, 1]``, marked
as the weight is (``nn.layer.layers.jax_perm``); ``convert`` carries them
as the JAX ``[in, out]`` and ``[1, out]`` arrays. The int8 tensors are
parameters without a gradient (``requires_grad=False``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..framework.dispatch import call_op
from ..nn.layer.layers import port_axis
from ..nn.layer.layers import Layer

__all__ = ["fake_quant", "FakeQuantAbsMax", "MovingAverageAbsMaxScale",
           "QuantizedLinear", "QuantizedConv2D", "ImperativeQuantAware",
           "PostTrainingQuantization", "QuantizationTransformPass",
           "PostTrainingQuantizationProgram", "calibrate_program"]

from .passes import (PostTrainingQuantizationProgram,  # noqa: E402
                     QuantizationTransformPass, calibrate_program)


def _qmax(bits):
    return float(2 ** (bits - 1) - 1)


def fake_quant(x, scale, bits: int = 8):
    """Symmetric per-tensor fake quantization with a straight-through
    gradient: ``round(clip(x, +-s) / s * qmax) * s / qmax`` with ``s``
    the scale in ``x``'s dtype, floored at 1e-8."""
    qmax = _qmax(bits)
    s = torch.as_tensor(scale, device=x.device)
    s = torch.clamp_min(s.to(x.dtype), 1e-8)
    q = torch.minimum(torch.maximum(x, -s), s) / s * qmax
    q = torch.round(q) * s / qmax
    return x + (q - x).detach()


class FakeQuantAbsMax(Layer):
    """Weight quantizer: the scale is the abs-max of the current tensor."""

    def __init__(self, bits: int = 8):
        super().__init__()
        self.bits = bits

    def forward(self, x):
        scale = call_op("max", call_op("abs", x))
        return fake_quant(x, scale, self.bits)


class MovingAverageAbsMaxScale(Layer):
    """Activation observer: an exponential moving average of the abs-max
    in ``scale_state`` (float32, ``[1]``; 0 until the first batch, which
    it takes as it is). In training it updates the state and
    fake-quantizes with it; in eval it applies the frozen state."""

    def __init__(self, bits: int = 8, momentum: float = 0.9):
        super().__init__()
        self.bits = bits
        self.momentum = momentum
        self.register_buffer("scale_state", torch.zeros(1))

    def forward(self, x):
        cur = x.detach().abs().amax().float()
        state = self.scale_state.reshape(())
        if self.training:
            new = torch.where(state == 0, cur,
                              self.momentum * state
                              + (1 - self.momentum) * cur)
            self.scale_state = new.reshape(1)
            scale = new
        else:
            scale = torch.where(state == 0, cur, state)
        return fake_quant(x, scale, self.bits)


class QuantizedLinear(Layer):
    """A ``Linear`` (``inner``) with fake-quantized weights and
    activations."""

    def __init__(self, inner, weight_bits=8, activation_bits=8):
        super().__init__()
        self.inner = inner
        self.weight_quant = FakeQuantAbsMax(weight_bits)
        self.act_quant = MovingAverageAbsMaxScale(activation_bits)

    def forward(self, x):
        from ..nn import functional as F
        x = self.act_quant(x)
        w = self.weight_quant(self.inner.weight)
        return F.linear(x, w.t(), self.inner.bias)


class QuantizedConv2D(Layer):
    """A ``Conv2D`` (``inner``) with fake-quantized weights and
    activations, in the inner layer's ``data_format`` (the JAX layer
    drops it and runs NCHW: ROADMAP Queue 3)."""

    def __init__(self, inner, weight_bits=8, activation_bits=8):
        super().__init__()
        self.inner = inner
        self.weight_quant = FakeQuantAbsMax(weight_bits)
        self.act_quant = MovingAverageAbsMaxScale(activation_bits)

    def forward(self, x):
        x = self.act_quant(x)
        w = self.weight_quant(self.inner.weight)
        return call_op("conv2d", x, w, self.inner.bias,
                       stride=self.inner._stride,
                       padding=self.inner._padding,
                       dilation=self.inner._dilation,
                       groups=self.inner._groups,
                       data_format=self.inner._data_format)


def _swap(layer, frozen):
    """Replace every sublayer for which ``frozen(sub)`` gives a layer, in
    place (keeping its position), and recurse into the others."""
    for name, sub in list(layer._modules.items()):
        new = frozen(sub)
        if new is not None:
            layer._modules[name] = new
        elif sub is not None:
            _swap(sub, frozen)


class ImperativeQuantAware:
    """Quantization-aware training: ``quantize(model)`` swaps the
    quantizable sublayers in place; train as usual;
    ``save_quantized_model`` freezes the weights to int8 and exports
    through ``jit.save``."""

    def __init__(self, weight_bits=8, activation_bits=8,
                 quantizable_layer_type=("Linear", "Conv2D")):
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.types = set(quantizable_layer_type)

    def quantize(self, model: Layer) -> Layer:
        from ..nn import Conv2D, Linear

        def frozen(sub):
            if isinstance(sub, Linear) and "Linear" in self.types:
                return QuantizedLinear(sub, self.weight_bits,
                                       self.activation_bits)
            if isinstance(sub, Conv2D) and "Conv2D" in self.types:
                return QuantizedConv2D(sub, self.weight_bits,
                                       self.activation_bits)
            return None

        _swap(model, frozen)
        return model

    def save_quantized_model(self, model, path, input_spec=None):
        """:func:`convert_to_int8`, then ``jit.save`` of the frozen model
        in eval mode; returns it."""
        from .. import jit
        model = convert_to_int8(model)
        model.eval()
        jit.save(model, path, input_spec=input_spec)
        return model


def _device_of(model):
    for t in model.parameters():
        return t.device
    return torch.device("cpu")


class PostTrainingQuantization:
    """Post-training quantization: run calibration batches through the
    model recording each ``Linear``/``Conv2D`` input's abs-max, then
    freeze those scales into quantized layers."""

    def __init__(self, model: Layer, weight_bits=8, activation_bits=8):
        self.model = model
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self._scales: Dict[str, float] = {}

    def collect(self, batches) -> Dict[str, float]:
        """Feed the calibration batches in eval mode; returns
        ``{layer name: activation scale}`` (the largest abs-max over
        the batches)."""
        from ..nn import Conv2D, Linear

        records: Dict[str, float] = {}
        hooks = []
        for name, sub in self.model.named_sublayers():
            if isinstance(sub, (Linear, Conv2D)):
                def mk(nm):
                    def hook(layer, inputs):
                        cur = float(inputs[0].detach().abs().amax())
                        records[nm] = max(records.get(nm, 0.0), cur)
                        return None
                    return hook
                hooks.append(sub.register_forward_pre_hook(mk(name)))
        self.model.eval()
        device = _device_of(self.model)
        try:
            with torch.no_grad():
                for batch in batches:
                    self.model(batch if isinstance(batch, torch.Tensor)
                               else torch.as_tensor(np.asarray(batch),
                                                    device=device))
        finally:
            for h in hooks:
                h.remove()
        self._scales = records
        return dict(records)

    def quantize(self) -> Layer:
        """Swap the quantizable layers, their observers starting from the
        calibrated scales; returns the model in eval mode."""
        qat = ImperativeQuantAware(self.weight_bits, self.activation_bits)
        name_map = dict(self._scales)
        originals = {id(sub): nm for nm, sub in
                     self.model.named_sublayers()}
        qat.quantize(self.model)
        for _, sub in self.model.named_sublayers():
            if isinstance(sub, (QuantizedLinear, QuantizedConv2D)):
                nm = originals.get(id(sub.inner))
                if nm in name_map and name_map[nm] > 0:
                    sub.act_quant.scale_state = torch.full(
                        (1,), name_map[nm], dtype=torch.float32,
                        device=sub.act_quant.scale_state.device)
        self.model.eval()
        return self.model


# ---------------------------------------------------------------------------
# the int8-weight inference layers
# ---------------------------------------------------------------------------

def quantize_weight(w, bits=8, channel_axis=-1):
    """``w`` -> (int8 values, float32 per-channel scales of ``w``'s rank),
    computed in ``w``'s dtype. ``channel_axis`` is an axis of the JAX
    layout: a ``Linear``'s weight (marked) is per output channel at -1,
    its axis 0 here."""
    keep = port_axis(w, channel_axis)
    w = torch.as_tensor(w).detach()
    qmax = _qmax(bits)
    axes = tuple(i for i in range(w.dim()) if i != keep)
    scale = (w.abs().amax(dim=axes, keepdim=True) if axes
             else w.abs()) / qmax
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(w / scale), -qmax - 1, qmax).to(torch.int8)
    return q, scale.float()


class QuantizedInferenceLinear(Layer):
    """A frozen int8-weight linear: ``weight_int8`` ``[out, in]`` and
    ``weight_scale`` ``[out, 1]`` (float32 per output channel), the
    weight dequantized to the float layer's dtype at each forward."""

    _jax_perms = {"weight_int8": (1, 0), "weight_scale": (1, 0)}

    def __init__(self, float_linear, weight_bits=8):
        super().__init__()
        w = float_linear.weight
        q, scale = quantize_weight(w.detach().float(), weight_bits,
                                   channel_axis=port_axis(w, -1))
        self.weight_int8 = torch.nn.Parameter(q, requires_grad=False)
        self.weight_scale = torch.nn.Parameter(scale, requires_grad=False)
        self._mark_layouts()
        self.bias = float_linear.bias
        self._compute_dtype = w.dtype

    def forward(self, x):
        from ..nn import functional as F
        w = (self.weight_int8.float() * self.weight_scale).to(
            self._compute_dtype)
        return F.linear(x, w.t(), self.bias)


class QuantizedInferenceConv2D(Layer):
    """A frozen int8-weight ``Conv2D``: ``weight_int8`` OIHW and
    ``weight_scale`` ``[out, 1, 1, 1]``."""

    def __init__(self, float_conv, weight_bits=8):
        super().__init__()
        w = float_conv.weight
        q, scale = quantize_weight(w.detach().float(), weight_bits,
                                   channel_axis=0)
        self.weight_int8 = torch.nn.Parameter(q, requires_grad=False)
        self.weight_scale = torch.nn.Parameter(scale, requires_grad=False)
        self.bias = float_conv.bias
        self._inner = float_conv
        self._compute_dtype = w.dtype

    def forward(self, x):
        w = (self.weight_int8.float() * self.weight_scale).to(
            self._compute_dtype)
        c = self._inner
        return call_op("conv2d", x, w, self.bias, stride=c._stride,
                       padding=c._padding, dilation=c._dilation,
                       groups=c._groups, data_format=c._data_format)


def convert_to_int8(model: Layer, weight_bits=8) -> Layer:
    """Replace the QAT-wrapped (or plain) ``Linear``/``Conv2D`` sublayers
    with frozen int8-weight inference layers, in place."""
    from ..nn import Conv2D, Linear

    def frozen(sub):
        if isinstance(sub, QuantizedLinear):
            return QuantizedInferenceLinear(sub.inner, weight_bits)
        if isinstance(sub, QuantizedConv2D):
            return QuantizedInferenceConv2D(sub.inner, weight_bits)
        if isinstance(sub, Linear):
            return QuantizedInferenceLinear(sub, weight_bits)
        if isinstance(sub, Conv2D) and not sub._transpose:
            return QuantizedInferenceConv2D(sub, weight_bits)
        return None

    _swap(model, frozen)
    return model
