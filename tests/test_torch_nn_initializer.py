"""The port's ``nn.initializer`` against the JAX package's: the fans,
the deterministic initializers bit for bit, the random ones in their
samples' statistics (mean, standard deviation and extremes within 3% of
the JAX sample's spread: the two generators' streams differ), the gains,
and the order in which ``create_parameter`` picks an initializer."""
import numpy as np
import pytest
import torch

from paddle_tpu.nn import initializer as jinit
import paddle_tpu_torch as pt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import initializer as tinit


@pytest.fixture(autouse=True)
def cpu_default():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


@pytest.mark.parametrize("name, args", [
    ("XavierUniform", ()), ("XavierNormal", ()), ("KaimingUniform", ()),
    ("KaimingNormal", ()), ("Normal", (0.5, 2.0)), ("Uniform", (-2.0, 3.0)),
    ("TruncatedNormal", (1.0, 0.5)), ("Orthogonal", (1.5,)),
    ("XavierUniform", (None, None, 2.0)), ("KaimingNormal", (50,)),
])
def test_initializer_statistics_match_jax(name, args):
    """Samples from both packages' initializer at a conv weight's shape
    ``[64, 32, 3, 3]`` (fans 288 and 576): mean, standard deviation and
    extremes within 3% of the JAX sample's (the streams differ)."""
    shape = (64, 32, 3, 3)
    pt.seed(0)
    got = getattr(tinit, name)(*args)(shape, "float32").numpy()
    want = np.asarray(getattr(jinit, name)(*args)(shape, "float32"))
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = want.std()
    assert abs(got.mean() - want.mean()) < 0.03 * scale
    assert abs(got.std() - want.std()) < 0.03 * scale
    if name in ("Uniform", "XavierUniform", "KaimingUniform",
                "TruncatedNormal"):
        assert abs(got.max() - want.max()) < 0.03 * scale
        assert abs(got.min() - want.min()) < 0.03 * scale
    if name == "Orthogonal":
        flat = got.reshape(64, -1)
        np.testing.assert_allclose(flat @ flat.T, 2.25 * np.eye(64),
                                   atol=1e-4)


@pytest.mark.parametrize("shape", [(), (7,), (5, 9), (8, 4, 3), (6, 2, 3, 5)])
def test_fans_and_deterministic_initializers_match_jax(shape):
    from paddle_tpu.nn.initializer import _fan_in_out as jax_fans
    assert tinit._fan_in_out(shape) == jax_fans(shape)
    for name, args in (("Constant", (0.7,)), ("Assign",
                                               (np.arange(int(np.prod(
                                                   shape)), dtype=np.float32
                                               ).reshape(shape),)),
                       ("Dirac", ()), ("Bilinear", ())):
        if name == "Dirac" and len(shape) < 3 or \
                name == "Bilinear" and len(shape) != 4:
            continue
        got = getattr(tinit, name)(*args)(shape, "float32").numpy()
        want = np.asarray(getattr(jinit, name)(*args)(shape, "float32"))
        np.testing.assert_array_equal(got, want)
    for nl in ("sigmoid", "tanh", "relu", "selu", "conv2d"):
        assert tinit.calculate_gain(nl) == jinit.calculate_gain(nl)
    assert tinit.calculate_gain("leaky_relu", 0.2) == \
        jinit.calculate_gain("leaky_relu", 0.2)


def test_param_attr_initializers_and_the_global_default():
    """An initializer in a ``ParamAttr`` or bare as ``weight_attr`` wins;
    without one, ``set_global_initializer``'s; then the layer's own."""
    lin = tnn.Linear(3, 2, tnn.ParamAttr(initializer=tinit.Constant(2.0)),
                     tinit.Constant(-1.0))
    assert torch.equal(lin.weight, torch.full((2, 3), 2.0))
    assert torch.equal(lin.bias, torch.full((2,), -1.0))
    tinit.set_global_initializer(tinit.Constant(0.25), tinit.Constant(0.5))
    try:
        glob = tnn.LayerNorm(4)
        assert torch.equal(glob.weight, torch.full((4,), 0.25))
        assert torch.equal(glob.bias, torch.full((4,), 0.5))
        p = pt.create_parameter([2, 2], is_bias=True)
        assert torch.equal(p, torch.full((2, 2), 0.5))
    finally:
        tinit.set_global_initializer(None, None)
    assert torch.equal(tnn.LayerNorm(4).weight, torch.ones(4))
