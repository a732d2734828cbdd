"""The port's convolution and pooling layers, ``CTCLoss``,
``HSigmoidLoss``, ``Fold``, ``PixelUnshuffle`` and ``ChannelShuffle``
against the JAX package's, class by class, in each ``data_format`` the
class takes.

As in ``test_torch_nn_layers.py``: the same layer is built in both
packages, the JAX layer's state is carried across with
``convert.layer_from_jax`` (the key sets equal; conv weights keep their
``[out, in / groups, *k]`` layout, ``[in, out / groups, *k]`` for the
transposed ones, with no transpose), the same numpy inputs and cotangent
go through both: every output (a pool's mask exactly, with its int32
dtype), the float inputs' gradients and every parameter's gradient within
atol 1e-5 + rtol 1e-4 (float32 in both, the same arithmetic in another
order).
"""
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
import paddle_tpu_torch as pt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import layer_from_jax, layer_to_numpy
from test_torch_nn_layers import (ATOL, RTOL, _ints, _jax_state, _rand,
                                  run_jax, run_port)


@pytest.fixture(autouse=True)
def cpu_default():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


def _cl(a):
    """A channel-first array moved to channel-last."""
    return np.ascontiguousarray(np.moveaxis(a, 1, -1))


def _unpool_index(seed, n, c, spatial, size):
    """Distinct flat indices into ``size`` positions, a channel each."""
    rs = np.random.RandomState(seed)
    length = int(np.prod(spatial))
    return np.stack([rs.permutation(size)[:length] for _ in range(n * c)]
                    ).reshape((n, c) + spatial).astype(np.int32)


X1, X2, X3 = _rand(1, 2, 4, 9), _rand(2, 2, 4, 7, 6), _rand(3, 1, 2, 5, 4, 6)

# name -> (constructor over the package's nn, inputs)
CASES = {
    "Conv1D": (lambda m: m.Conv1D(4, 6, 3, stride=2, padding=1), [X1]),
    "Conv1D NLC": (lambda m: m.Conv1D(4, 6, 3, padding="SAME", dilation=2,
                                      groups=2, data_format="NLC"),
                   [_cl(X1)]),
    "Conv2D": (lambda m: m.Conv2D(4, 6, 3, stride=2, padding=[1, 0],
                                  groups=2), [X2]),
    "Conv2D NHWC": (lambda m: m.Conv2D(4, 5, (3, 2), padding="SAME",
                                       bias_attr=False, data_format="NHWC"),
                    [_cl(X2)]),
    "Conv3D": (lambda m: m.Conv3D(2, 3, 2, padding=1), [X3]),
    "Conv3D NDHWC": (lambda m: m.Conv3D(2, 4, 3, stride=(1, 2, 1),
                                        padding="VALID",
                                        data_format="NDHWC"), [_cl(X3)]),
    "Conv1DTranspose": (lambda m: m.Conv1DTranspose(
        4, 3, 3, stride=2, padding=1, output_padding=1), [X1]),
    "Conv1DTranspose NLC": (lambda m: m.Conv1DTranspose(
        4, 6, 3, groups=2, dilation=2, data_format="NLC"), [_cl(X1)]),
    "Conv2DTranspose": (lambda m: m.Conv2DTranspose(4, 6, 3, stride=2,
                                                    padding=1, groups=2),
                        [X2]),
    "Conv2DTranspose NHWC": (lambda m: m.Conv2DTranspose(
        4, 3, 2, stride=2, padding="SAME", data_format="NHWC"), [_cl(X2)]),
    "Conv3DTranspose": (lambda m: m.Conv3DTranspose(2, 3, 2, stride=2),
                        [X3]),
    "Conv3DTranspose NDHWC": (lambda m: m.Conv3DTranspose(
        2, 2, 3, padding=1, bias_attr=False, data_format="NDHWC"),
        [_cl(X3)]),
    "MaxPool1D": (lambda m: m.MaxPool1D(3, stride=2, padding=1), [X1]),
    "MaxPool1D mask": (lambda m: m.MaxPool1D(2, return_mask=True), [X1]),
    "MaxPool2D": (lambda m: m.MaxPool2D(3, stride=2, padding=1,
                                        ceil_mode=True), [X2]),
    "MaxPool2D NHWC": (lambda m: m.MaxPool2D(2, data_format="NHWC"),
                       [_cl(X2)]),
    "MaxPool2D mask": (lambda m: m.MaxPool2D(3, stride=2, padding=1,
                                             return_mask=True), [X2]),
    "MaxPool3D": (lambda m: m.MaxPool3D(2, padding=1), [X3]),
    "MaxPool3D NDHWC": (lambda m: m.MaxPool3D(2, data_format="NDHWC"),
                        [_cl(X3)]),
    "MaxPool3D mask": (lambda m: m.MaxPool3D(2, stride=1, return_mask=True,
                                             ceil_mode=True), [X3]),
    "AvgPool1D": (lambda m: m.AvgPool1D(3, stride=2, padding=1), [X1]),
    "AvgPool2D": (lambda m: m.AvgPool2D(3, stride=2, padding=1), [X2]),
    "AvgPool2D NHWC": (lambda m: m.AvgPool2D(2, ceil_mode=True,
                                             data_format="NHWC"), [_cl(X2)]),
    "AvgPool3D": (lambda m: m.AvgPool3D(2, stride=1, padding=1), [X3]),
    "AdaptiveAvgPool1D": (lambda m: m.AdaptiveAvgPool1D(4), [X1]),
    "AdaptiveAvgPool2D": (lambda m: m.AdaptiveAvgPool2D((3, 4)), [X2]),
    "AdaptiveAvgPool2D NHWC": (lambda m: m.AdaptiveAvgPool2D(
        1, data_format="NHWC"), [_cl(X2)]),
    "AdaptiveAvgPool3D": (lambda m: m.AdaptiveAvgPool3D((2, 3, None)),
                          [X3]),
    "AdaptiveAvgPool3D NDHWC": (lambda m: m.AdaptiveAvgPool3D(
        2, data_format="NDHWC"), [_cl(X3)]),
    "AdaptiveMaxPool1D": (lambda m: m.AdaptiveMaxPool1D(4), [X1]),
    "AdaptiveMaxPool1D mask": (lambda m: m.AdaptiveMaxPool1D(
        3, return_mask=True), [X1]),
    "AdaptiveMaxPool2D": (lambda m: m.AdaptiveMaxPool2D((3, 4)), [X2]),
    "AdaptiveMaxPool2D mask": (lambda m: m.AdaptiveMaxPool2D(
        (1, 3), return_mask=True), [X2]),
    "AdaptiveMaxPool3D": (lambda m: m.AdaptiveMaxPool3D((2, 3, 4)), [X3]),
    "AdaptiveMaxPool3D mask": (lambda m: m.AdaptiveMaxPool3D(
        (5, 2, 3), return_mask=True), [X3]),
    "MaxUnPool1D": (lambda m: m.MaxUnPool1D(2), [
        _rand(4, 2, 3, 4), _unpool_index(5, 2, 3, (4,), 8)]),
    "MaxUnPool2D": (lambda m: m.MaxUnPool2D(2, output_size=(7, 7)), [
        _rand(6, 2, 3, 3, 3), _unpool_index(7, 2, 3, (3, 3), 49)]),
    "MaxUnPool3D": (lambda m: m.MaxUnPool3D(2, stride=2), [
        _rand(8, 1, 2, 2, 2, 2), _unpool_index(9, 1, 2, (2, 2, 2), 64)]),
    "CTCLoss": (lambda m: m.CTCLoss(blank=0), [
        _rand(10, 6, 3, 5), np.array([[1, 2, 2], [3, 1, 0], [4, 4, 1]],
                                     np.int32),
        np.array([6, 5, 4], np.int64), np.array([3, 2, 1], np.int64)]),
    "CTCLoss sum": (lambda m: m.CTCLoss(blank=4, reduction="sum"), [
        _rand(11, 5, 2, 5), np.array([[0, 1], [2, 2]], np.int32),
        np.array([5, 4], np.int64), np.array([2, 2], np.int64)]),
    "HSigmoidLoss": (lambda m: m.HSigmoidLoss(6, 5),
                     [_rand(12, 4, 6), _ints(13, 5, 4)]),
    "Fold": (lambda m: m.Fold((5, 5), 2, strides=2, paddings=[1, 0, 0, 1]),
             [_rand(14, 2, 8, 9)]),
    "PixelUnshuffle": (lambda m: m.PixelUnshuffle(2), [_rand(15, 2, 3, 4,
                                                             6)]),
    "PixelUnshuffle NHWC": (lambda m: m.PixelUnshuffle(
        2, data_format="NHWC"), [_rand(16, 2, 4, 6, 3)]),
    "ChannelShuffle": (lambda m: m.ChannelShuffle(3), [_rand(17, 2, 6, 3,
                                                             3)]),
    "ChannelShuffle NHWC": (lambda m: m.ChannelShuffle(
        2, data_format="NHWC"), [_rand(18, 2, 3, 3, 6)]),
}

#: the 26 classes this slice ports, each with at least one case above
CLASSES = (
    "Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
    "Conv3DTranspose", "MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D",
    "AvgPool2D", "AvgPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
    "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
    "AdaptiveMaxPool3D", "MaxUnPool1D", "MaxUnPool2D", "MaxUnPool3D",
    "CTCLoss", "HSigmoidLoss", "Fold", "PixelUnshuffle", "ChannelShuffle")


def test_every_class_has_a_case():
    assert len(CLASSES) == 26
    assert {name.split()[0] for name in CASES} == set(CLASSES)


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_matches_jax(case):
    make, inputs = CASES[case]
    jl, tl = make(jnn), make(tnn)
    state = _jax_state(jl)
    assert set(tl.state_dict()) == set(state)
    layer_from_jax(tl, state)
    for k, v in layer_to_numpy(tl).items():
        np.testing.assert_array_equal(v, state[k], err_msg=k)
    with torch.no_grad():
        out = tl(*[torch.from_numpy(a) for a in inputs])
    out = out[0] if isinstance(out, (list, tuple)) else out
    cot = _rand(99, *out.shape)
    j_outs, j_grads, j_pgrads = run_jax(jl, inputs, cot)
    t_outs, t_grads, t_pgrads = run_port(tl, inputs, cot)
    assert len(t_outs) == len(j_outs)
    for a, b in zip(t_outs, j_outs):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL)
    for a, b in zip(t_grads, j_grads):
        if b is not None:
            np.testing.assert_allclose(np.zeros_like(b) if a is None else a,
                                       b, atol=ATOL, rtol=RTOL)
    assert set(t_pgrads) == set(j_pgrads)
    for k in j_pgrads:
        np.testing.assert_allclose(t_pgrads[k], j_pgrads[k], atol=ATOL,
                                   rtol=RTOL, err_msg=k)


def test_weights_are_drawn_as_the_jax_layers_draw_them():
    """The default initializers: a conv weight from ``XavierUniform`` over
    the reference layout's fans (the bound ``sqrt(6 / (fan_in +
    fan_out))`` holds and the variance is ``2 / (fan_in + fan_out)``, the
    JAX draw's), the bias zeros; the same seed draws the same weights, and
    an explicit initializer is taken as in the JAX layer."""
    pt.seed(3)
    a = tnn.Conv2D(16, 32, 3)
    pt.seed(3)
    b = tnn.Conv2D(16, 32, 3)
    assert torch.equal(a.weight, b.weight) and not a.bias.any()
    fan_in, fan_out = 16 * 9, 32 * 9
    bound = (6.0 / (fan_in + fan_out)) ** 0.5
    w = a.weight.detach().numpy()
    j = jnn.Conv2D(16, 32, 3).weight.numpy()
    assert w.shape == j.shape == (32, 16, 3, 3)
    assert np.abs(w).max() <= bound and np.abs(j).max() <= bound
    assert abs(w.var() - 2.0 / (fan_in + fan_out)) < 0.1 * w.var()
    t = tnn.Conv1DTranspose(4, 6, 3, groups=2)
    assert tuple(t.weight.shape) == tuple(
        jnn.Conv1DTranspose(4, 6, 3, groups=2).weight.shape) == (4, 3, 3)
    c = tnn.Conv2D(2, 3, 1, weight_attr=tnn.initializer.Constant(0.5),
                   bias_attr=False)
    assert c.bias is None and torch.equal(c.weight, torch.full((3, 2, 1, 1),
                                                               0.5))
