"""The port's ``nn`` layers against the JAX package's, class by class.

Each case builds the same layer in both packages, carries the JAX
layer's state across with ``convert.layer_from_jax`` (the key sets must
be equal, and ``layer_to_numpy`` gives the JAX state back), runs the same
numpy inputs through both and back-propagates the same cotangent: the
outputs, the float inputs' gradients and every parameter's gradient
(``Linear`` weights compared in the JAX ``[in, out]`` layout) agree
within atol 1e-5 + rtol 1e-4 (float32, the same arithmetic in another
order). BatchNorm layers run in training mode and their running
statistics are compared too (``nn.Transformer`` itself:
``test_torch_transformer.py``; the initializers:
``test_torch_nn_initializer.py``).
"""
import copy

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
import paddle_tpu_torch as pt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import layer_from_jax, layer_to_numpy

ATOL, RTOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def cpu_default():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


def _rand(seed, *shape):
    return np.asarray(np.random.RandomState(seed).randn(*shape), np.float32)


def _jax_state(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


def run_jax(layer, inputs, cot):
    xs = [paddle.to_tensor(a, stop_gradient=a.dtype.kind != "f")
          for a in inputs]
    out = layer(*xs)
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    loss = paddle.sum(outs[0] * paddle.to_tensor(cot))
    loss.backward()
    grads = [x.grad.numpy() if a.dtype.kind == "f" and x.grad is not None
             else None for x, a in zip(xs, inputs)]
    pgrads = {n: p.grad.numpy() for n, p in layer.named_parameters()
              if p.grad is not None}
    return [o.numpy() for o in outs], grads, pgrads


def run_port(layer, inputs, cot):
    xs = [torch.tensor(a, requires_grad=a.dtype.kind == "f")
          for a in inputs]
    out = layer(*xs)
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    (outs[0] * torch.from_numpy(cot)).sum().backward()
    grads = [x.grad.numpy() if x.grad is not None else None for x in xs]
    linear = {f"{n}.weight" if n else "weight"
              for n, m in layer.named_modules() if isinstance(m, tnn.Linear)}
    pgrads = {n: (p.grad.numpy().T if n in linear else p.grad.numpy())
              for n, p in layer.named_parameters() if p.grad is not None}
    return [o.detach().numpy() for o in outs], grads, pgrads


def _ints(seed, hi, *shape):
    return np.random.RandomState(seed).randint(0, hi, shape).astype(np.int64)


IMG = (2, 4, 6, 6)

# name -> (constructor over the package's nn, inputs, training mode)
CASES = {
    # activations
    **{name: (lambda m, n=name: getattr(m, n)(), [_rand(1, 3, 4, 2, 2)],
              False)
       for name in ("ReLU", "ReLU6", "GELU", "Sigmoid", "Tanh", "Softmax",
                    "LogSoftmax", "LeakyReLU", "ELU", "CELU", "SELU",
                    "Silu", "Swish", "Mish", "Hardsigmoid", "Hardswish",
                    "Hardtanh", "Hardshrink", "Softshrink", "Softplus",
                    "Softsign", "Tanhshrink", "ThresholdedReLU",
                    "LogSigmoid", "GLU", "Softmax2D")},
    "Maxout": (lambda m: m.Maxout(2), [_rand(2, 2, 4, 3)], False),
    "PReLU": (lambda m: m.PReLU(4, 0.1), [_rand(3, 2, 4, 3)], False),
    "RReLU eval": (lambda m: m.RReLU(0.1, 0.3), [_rand(4, 3, 4)], False),
    # common
    "Identity": (lambda m: m.Identity(), [_rand(5, 3, 4)], False),
    "Linear": (lambda m: m.Linear(4, 6), [_rand(6, 3, 4)], True),
    "Linear no bias": (lambda m: m.Linear(4, 6, bias_attr=False),
                       [_rand(7, 2, 3, 4)], True),
    "Embedding": (lambda m: m.Embedding(10, 4, padding_idx=2),
                  [_ints(8, 10, 3, 5)], True),
    "Dropout eval": (lambda m: m.Dropout(0.3), [_rand(9, 3, 4)], False),
    "Dropout downscale eval": (
        lambda m: m.Dropout(0.3, mode="downscale_in_infer"),
        [_rand(10, 3, 4)], False),
    "Dropout2D eval": (lambda m: m.Dropout2D(0.3), [_rand(11, *IMG)], False),
    "Dropout3D eval": (lambda m: m.Dropout3D(0.3), [_rand(12, 1, 2, 3, 3, 3)],
                       False),
    "AlphaDropout eval": (lambda m: m.AlphaDropout(0.3), [_rand(13, 3, 4)],
                          False),
    "Flatten": (lambda m: m.Flatten(), [_rand(14, *IMG)], False),
    "Pad1D": (lambda m: m.Pad1D([1, 2], mode="reflect"),
              [_rand(15, 2, 3, 5)], False),
    "Pad2D": (lambda m: m.Pad2D([1, 0, 2, 1], value=0.5), [_rand(16, *IMG)],
              False),
    "Pad3D": (lambda m: m.Pad3D([1, 1, 0, 1, 1, 0], mode="replicate"),
              [_rand(17, 1, 2, 3, 3, 3)], False),
    "Upsample": (lambda m: m.Upsample(size=(4, 9), mode="bilinear"),
                 [_rand(18, *IMG)], False),
    "UpsamplingBilinear2D": (lambda m: m.UpsamplingBilinear2D(
        scale_factor=[2, 2]), [_rand(19, *IMG)], False),
    "UpsamplingNearest2D": (lambda m: m.UpsamplingNearest2D(size=(9, 4)),
                            [_rand(20, *IMG)], False),
    "CosineSimilarity": (lambda m: m.CosineSimilarity(axis=1),
                         [_rand(21, 3, 4), _rand(22, 3, 4)], False),
    "PixelShuffle": (lambda m: m.PixelShuffle(2), [_rand(23, 2, 8, 3, 3)],
                     False),
    "Unfold": (lambda m: m.Unfold(3, strides=2, paddings=1),
               [_rand(24, *IMG)], False),
    "Bilinear": (lambda m: m.Bilinear(3, 5, 4),
                 [_rand(25, 2, 3), _rand(26, 2, 5)], False),
    "ZeroPad2D": (lambda m: m.ZeroPad2D([1, 2, 0, 1]), [_rand(27, *IMG)],
                  False),
    "PairwiseDistance": (lambda m: m.PairwiseDistance(3.0),
                         [_rand(28, 3, 4), _rand(29, 3, 4)], False),
    # containers
    "Sequential": (lambda m: m.Sequential(m.Linear(4, 8), m.ReLU(),
                                          m.Linear(8, 3)),
                   [_rand(30, 5, 4)], True),
    "LayerList": (lambda m: _Stack(m, m.LayerList(
        [m.Linear(4, 4), m.Tanh(), m.Linear(4, 2)])), [_rand(31, 3, 4)],
        True),
    "LayerDict": (lambda m: _Stack(m, m.LayerDict(
        {"a": m.Linear(4, 3), "b": m.Sigmoid()})), [_rand(32, 3, 4)], True),
    # norms
    "LayerNorm": (lambda m: m.LayerNorm(4), [_rand(33, 3, 5, 4)], True),
    "LayerNorm no bias": (lambda m: m.LayerNorm(4, bias_attr=False),
                          [_rand(34, 3, 5, 4)], True),
    "BatchNorm1D": (lambda m: m.BatchNorm1D(4, momentum=0.8),
                    [_rand(35, 3, 4, 5)], True),
    "BatchNorm2D": (lambda m: m.BatchNorm2D(4), [_rand(36, *IMG)], True),
    "BatchNorm3D": (lambda m: m.BatchNorm3D(2), [_rand(37, 2, 2, 3, 3, 3)],
                    True),
    "BatchNorm eval": (lambda m: m.BatchNorm(4, act="relu"),
                       [_rand(38, *IMG)], False),
    "GroupNorm": (lambda m: m.GroupNorm(2, 4), [_rand(39, *IMG)], True),
    "InstanceNorm1D": (lambda m: m.InstanceNorm1D(4), [_rand(40, 3, 4, 5)],
                       True),
    "InstanceNorm2D": (lambda m: m.InstanceNorm2D(4), [_rand(41, *IMG)],
                       True),
    "InstanceNorm3D": (lambda m: m.InstanceNorm3D(2),
                       [_rand(42, 2, 2, 3, 3, 3)], True),
    "RMSNorm": (lambda m: m.RMSNorm(4), [_rand(43, 3, 5, 4)], True),
    "LocalResponseNorm": (lambda m: m.LocalResponseNorm(3, alpha=0.1),
                          [_rand(44, *IMG)], False),
    "SpectralNorm": (lambda m: m.SpectralNorm([4, 6], power_iters=2),
                     [_rand(45, 4, 6)], False),
    # losses
    "CrossEntropyLoss": (lambda m: m.CrossEntropyLoss(label_smoothing=0.1),
                         [_rand(46, 5, 7), _ints(47, 7, 5)], True),
    "MSELoss": (lambda m: m.MSELoss(), [_rand(48, 3, 4), _rand(49, 3, 4)],
                True),
    "L1Loss": (lambda m: m.L1Loss("sum"), [_rand(50, 3, 4),
                                           _rand(51, 3, 4)], True),
    "NLLLoss": (lambda m: m.NLLLoss(), [np.log(np.random.RandomState(52)
                                               .dirichlet(np.ones(5), 4)
                                               .astype(np.float32)),
                                        _ints(53, 5, 4)], True),
    "BCELoss": (lambda m: m.BCELoss(),
                [np.random.RandomState(54).uniform(0.1, 0.9, (3, 4))
                 .astype(np.float32),
                 (np.random.RandomState(55).rand(3, 4) < 0.5)
                 .astype(np.float32)], True),
    "BCEWithLogitsLoss": (lambda m: m.BCEWithLogitsLoss(),
                          [_rand(56, 3, 4),
                           (np.random.RandomState(57).rand(3, 4) < 0.5)
                           .astype(np.float32)], True),
    "KLDivLoss": (lambda m: m.KLDivLoss("batchmean"),
                  [np.log(np.random.RandomState(58).dirichlet(np.ones(4), 3)
                          .astype(np.float32)),
                   np.random.RandomState(59).dirichlet(np.ones(4), 3)
                   .astype(np.float32)], True),
    "SmoothL1Loss": (lambda m: m.SmoothL1Loss(delta=0.5),
                     [_rand(60, 3, 4), _rand(61, 3, 4)], True),
    "HuberLoss": (lambda m: m.HuberLoss(delta=0.5),
                  [_rand(62, 3, 4), _rand(63, 3, 4)], True),
    "MarginRankingLoss": (lambda m: m.MarginRankingLoss(0.1),
                          [_rand(64, 6), _rand(65, 6),
                           np.sign(_rand(66, 6))], True),
    "HingeEmbeddingLoss": (lambda m: m.HingeEmbeddingLoss(0.5),
                           [_rand(67, 6), np.sign(_rand(68, 6))], True),
    "SigmoidFocalLoss": (lambda m: m.SigmoidFocalLoss(),
                         [_rand(69, 3, 4),
                          (np.random.RandomState(70).rand(3, 4) < 0.5)
                          .astype(np.float32)], True),
    "CosineEmbeddingLoss": (lambda m: m.CosineEmbeddingLoss(0.2),
                            [_rand(71, 4, 5), _rand(72, 4, 5),
                             np.array([1, -1, 1, -1], np.float32)], True),
    "TripletMarginLoss": (lambda m: m.TripletMarginLoss(swap=True),
                          [_rand(73, 4, 5), _rand(74, 4, 5),
                           _rand(75, 4, 5)], True),
    "TripletMarginWithDistanceLoss": (
        lambda m: m.TripletMarginWithDistanceLoss(margin=0.5),
        [_rand(76, 4, 5), _rand(77, 4, 5), _rand(78, 4, 5)], True),
    "MultiLabelSoftMarginLoss": (
        lambda m: m.MultiLabelSoftMarginLoss(),
        [_rand(79, 3, 4), (np.random.RandomState(80).rand(3, 4) < 0.5)
         .astype(np.float32)], True),
    # attention
    "MultiHeadAttention": (lambda m: m.MultiHeadAttention(8, 2),
                           [_rand(81, 2, 5, 8)], True),
    "MultiHeadAttention cross kdim": (
        lambda m: m.MultiHeadAttention(8, 2, kdim=6, vdim=4),
        [_rand(82, 2, 5, 8), _rand(83, 2, 3, 6), _rand(84, 2, 3, 4)], True),
    "TransformerEncoderLayer": (
        lambda m: m.TransformerEncoderLayer(8, 2, 16, dropout=0.0),
        [_rand(85, 2, 5, 8)], True),
    "TransformerEncoderLayer pre-norm gelu": (
        lambda m: m.TransformerEncoderLayer(8, 2, 16, dropout=0.0,
                                            activation="gelu",
                                            normalize_before=True),
        [_rand(86, 2, 5, 8)], True),
    "TransformerDecoderLayer": (
        lambda m: m.TransformerDecoderLayer(8, 2, 16, dropout=0.0),
        [_rand(87, 2, 5, 8), _rand(88, 2, 3, 8)], True),
    "TransformerEncoder": (
        lambda m: m.TransformerEncoder(m.TransformerEncoderLayer(
            8, 2, 16, dropout=0.0), 2, m.LayerNorm(8)),
        [_rand(89, 2, 5, 8)], True),
    "TransformerDecoder": (
        lambda m: m.TransformerDecoder(m.TransformerDecoderLayer(
            8, 2, 16, dropout=0.0, normalize_before=True), 2),
        [_rand(90, 2, 5, 8), _rand(91, 2, 3, 8)], True),
    "ParameterList": (lambda m: _Affine(m), [_rand(94, 3, 4)], True),
}


class _Affine:
    """A layer holding a ``ParameterList`` (``x * p0 + p1``), built over
    either package's ``nn``."""

    def __new__(cls, m):
        class Affine(m.Layer):
            def __init__(self):
                super().__init__()
                self.params = m.ParameterList([
                    self.create_parameter([4]),
                    self.create_parameter([4], is_bias=True)])

            def forward(self, x):
                return x * self.params[0] + self.params[1]

        return Affine()


class _Stack:
    """A layer that runs a container's children in order (for LayerList
    and LayerDict), built over either package's ``nn.Layer``."""

    def __new__(cls, m, container):
        class Stack(m.Layer):
            def __init__(self):
                super().__init__()
                self.body = container

            def forward(self, x):
                layers = container.values() if hasattr(container, "values") \
                    else container
                for layer in layers:
                    x = layer(x)
                return x

        return Stack()


def _pair(case):
    make, inputs, training = CASES[case]
    jl, tl = make(jnn), make(tnn)
    if not training:
        jl.eval()
        tl.eval()
    state = _jax_state(jl)
    assert set(tl.state_dict()) == set(state)
    layer_from_jax(tl, state)
    back = layer_to_numpy(tl)
    assert set(back) == set(state)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    return jl, tl, inputs


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_matches_jax(case):
    jl, tl, inputs = _pair(case)
    with torch.no_grad():
        tout = copy.deepcopy(tl)(*[torch.from_numpy(a) for a in inputs])
    tout = tout[0] if isinstance(tout, (list, tuple)) else tout
    if not tout.requires_grad and case == "SpectralNorm":
        # the op carries no gradient in either package (nondiff in JAX)
        assert not tl(*[torch.from_numpy(a) for a in inputs]).requires_grad
        np.testing.assert_allclose(
            tout.numpy(), jl(*[paddle.to_tensor(a) for a in inputs]).numpy(),
            atol=ATOL, rtol=RTOL)
        return
    cot = _rand(99, *tout.shape)
    (j_outs, j_grads, j_pgrads) = run_jax(jl, inputs, cot)
    (t_outs, t_grads, t_pgrads) = run_port(tl, inputs, cot)
    for a, b in zip(t_outs, j_outs):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL)
    for a, b in zip(t_grads, j_grads):
        if b is not None:
            # a label autograd does not reach has JAX's zero gradient
            np.testing.assert_allclose(np.zeros_like(b) if a is None else a,
                                       b, atol=ATOL, rtol=RTOL)
    assert set(t_pgrads) == set(j_pgrads)
    for k in j_pgrads:
        np.testing.assert_allclose(t_pgrads[k], j_pgrads[k], atol=ATOL,
                                   rtol=RTOL, err_msg=k)
    # the running statistics a training BatchNorm wrote
    after = _jax_state(jl)
    for k, v in layer_to_numpy(tl).items():
        np.testing.assert_allclose(v, after[k], atol=ATOL, rtol=RTOL,
                                   err_msg=k)


def test_layer_from_jax_rejects_other_keys():
    t = tnn.Linear(4, 3)
    with pytest.raises(KeyError, match="missing"):
        layer_from_jax(t, {"weight": np.zeros((4, 3), np.float32)})
    with pytest.raises(KeyError, match="unexpected"):
        layer_from_jax(t, {"weight": np.zeros((4, 3), np.float32),
                           "bias": np.zeros(3, np.float32),
                           "extra": np.zeros(1, np.float32)})
    with pytest.raises(ValueError, match="transpose"):
        layer_from_jax(t, {"weight": np.zeros((3, 4), np.float32),
                           "bias": np.zeros(3, np.float32)})


def test_layer_methods_match_the_jax_layer():
    """``named_sublayers``, ``state_dict(include_sublayers=False)``,
    ``set_state_dict``'s missing/unexpected keys, ``full_name``,
    ``astype``, ``register_buffer(persistable=False)``, the post hook."""
    def build(m):
        net = m.Sequential(m.Linear(4, 3), m.BatchNorm1D(3))
        net.register_buffer("scratch", None, persistable=False)
        return net

    j, t = build(jnn), build(tnn)
    assert [n for n, _ in t.named_sublayers(include_self=True)] == \
        [n for n, _ in j.named_sublayers(include_self=True)]
    assert list(t.state_dict(include_sublayers=False)) == \
        list(j.state_dict(include_sublayers=False))
    assert t.full_name() == j.full_name() == "sequential"
    state = {"0.weight": np.ones((4, 3), np.float32), "extra": np.ones(1)}
    jm, ju = j.set_state_dict(state)
    tm, tu = t.set_state_dict({"0.weight": np.ones((3, 4), np.float32),
                               "extra": np.ones(1)})
    assert sorted(tm) == sorted(jm) and tu == ju == ["extra"]
    seen = []
    t.register_forward_post_hook(lambda layer, inp, out: seen.append(
        out.shape) or out * 0)
    assert not t(torch.ones(2, 4)).any() and seen == [(2, 3)]
    assert t.astype("float64")[0].weight.dtype == torch.float64
    assert t.to(dtype="float16")[1]._mean.dtype == torch.float16
    t.clear_gradients()
    assert len(t.sublayers()) == 2


def _deferred():
    from paddle_tpu_torch.nn import _DEFERRED as layers
    return [(f"nn.{n}", item) for n, item in sorted(layers.items())]


@pytest.mark.parametrize("name, item", _deferred())
def test_a_deferred_name_raises_naming_its_item(name, item):
    """Every JAX ``nn`` name the port leaves for a later
    slice exists in the JAX package and raises ``NotImplementedError``
    naming its ROADMAP Queue 1 item when reached."""
    import importlib
    mod_name, _, attr = name.rpartition(".")
    assert hasattr(importlib.import_module(f"paddle_tpu.{mod_name}"), attr)
    port = importlib.import_module(f"paddle_tpu_torch.{mod_name}")
    with pytest.raises(NotImplementedError, match=f"Queue 1 item {item}"):
        getattr(port, attr)
