"""The port's vision zoo (``paddle_tpu_torch/vision/models``) against the
JAX package's, on the CPU: each family built in both packages from the
same weights (``convert.layer_from_jax``, BatchNorm's running statistics
included), then one batch of 2 through both, in eval mode (BatchNorm on
its running statistics, dropout off): the logits, and the gradients of a
random cotangent of them in the input and in every parameter, each
within ``TOL`` of its tensor's largest magnitude (float32 in both, the
same arithmetic in another order).

The JAX networks draw their weights from numpy (``_NumpyInit``, through
the package's ``set_global_initializer``), since its own initializers
compile one program a parameter shape; the port's take them through
``convert.layer_from_jax``. Input sizes are
``tests/test_vision_zoo_forward.py``'s or smaller: AlexNet keeps 224 (its
classifier reads a fixed 6 x 6 map); InceptionV3 takes 75 (its smallest:
the reference's 299 only sizes the stem's maps); GoogLeNet is held in
training mode with its dropout off, so that its two auxiliary heads run
(it has no BatchNorm). VGG and SqueezeNet are here; the MobileNets (NCHW
and NHWC, the one layout knob of these families) and ShuffleNetV2 in
``test_torch_vision_zoo_mobile.py``; DenseNet and GoogLeNet in
``test_torch_vision_zoo_deep.py``; InceptionV3 and AlexNet in
``test_torch_vision_zoo_large.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn import initializer as jinit
from paddle_tpu.nn.layer.layers import (functional_call, get_buffers_tree,
                                        get_params_tree)
from paddle_tpu.vision import models as jm
from paddle_tpu_torch.convert import _linear_keys, layer_from_jax
from paddle_tpu_torch.nn.layer.common import Dropout
from paddle_tpu_torch.vision import models as tm

#: float32 in both packages, the same arithmetic in another order
TOL = 1e-4

#: (constructor, kwargs, input side, NHWC)
CASES = [
    ("vgg11", {"batch_norm": True}, 32, False),
    ("squeezenet1_1", {}, 64, False),
]


class _NumpyInit:
    """A JAX initializer drawing on the host from numpy (He-scaled
    weights, 1-D parameters near 1 or, for biases, near 0): building a
    network with it compiles no initializer, the cost of the JAX zoo's
    own construction."""

    def __init__(self, rs, is_bias):
        self.rs, self.is_bias = rs, is_bias

    def __call__(self, shape, dtype):
        if len(shape) == 1:
            v = self.rs.randn(*shape) * 0.1 + (0.0 if self.is_bias else 1.0)
        else:
            fan_in = shape[0] if len(shape) == 2 else np.prod(shape[1:])
            v = self.rs.randn(*shape) * np.sqrt(2.0 / fan_in)
        return jnp.asarray(v.astype(np.float32), dtype)


def build_pair(name, kwargs, seed=0):
    """The JAX network, its weights drawn by :class:`_NumpyInit`, and the
    port's with those weights."""
    rs = np.random.RandomState(seed)
    jinit.set_global_initializer(_NumpyInit(rs, False), _NumpyInit(rs, True))
    try:
        jax_net = getattr(jm, name)(num_classes=7, **kwargs)
    finally:
        jinit.set_global_initializer(None, None)
    port = getattr(tm, name)(num_classes=7, **kwargs)
    layer_from_jax(port, {k: np.asarray(v._data)
                          for k, v in jax_net.state_dict().items()})
    return jax_net, port


def _max_rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _jax_outputs_and_grads(jax_net, xin, cot):
    """The JAX network's outputs and the gradients of ``sum(out * cot)``
    in the input and every parameter, through the package's functional
    bridge under one ``jax.jit`` (the package's own jitted training path:
    one compile of the network, where the eager tape compiles each op)."""
    params, buffers = get_params_tree(jax_net), get_buffers_tree(jax_net)

    def f(params, x):
        out, _ = functional_call(jax_net, params, buffers, x)
        outs = out if isinstance(out, (list, tuple)) else [out]
        return [o._data for o in outs]

    outs, vjp = jax.vjp(jax.jit(f), params, jnp.asarray(xin))
    g_params, g_x = jax.jit(vjp)([jnp.asarray(c) for c in cot])
    return [np.asarray(o) for o in outs] + [np.asarray(g_x)], \
        {k: np.asarray(v) for k, v in g_params.items()}


def hold(jax_net, port, x, cot, training=False, nhwc=False):
    """Run both on ``x`` (NCHW numpy; moved to NHWC for ``nhwc``) and
    hold the outputs, the input's gradient and every parameter's to
    ``TOL``. Returns the number of tensors compared."""
    for net in (jax_net, port):
        net.train() if training else net.eval()
    xin = np.ascontiguousarray(x.transpose(0, 2, 3, 1)) if nhwc else x
    want, want_g = _jax_outputs_and_grads(jax_net, xin, cot)

    xp = torch.tensor(xin, requires_grad=True)
    got_outs = port(xp)
    got_outs = list(got_outs) if isinstance(got_outs, (list, tuple)) \
        else [got_outs]
    sum((o * torch.from_numpy(c)).sum()
        for o, c in zip(got_outs, cot)).backward()
    got = [o.detach().numpy() for o in got_outs] + [xp.grad.numpy()]
    linear = _linear_keys(port)
    got_g = {n: p.grad.numpy().T if n in linear else p.grad.numpy()
             for n, p in port.named_parameters()}
    assert set(got_g) == set(want_g)
    bad = {f"output {i}": _max_rel(g, w)
           for i, (g, w) in enumerate(zip(got, want))
           if g.shape != w.shape or _max_rel(g, w) > TOL}
    bad.update({k: _max_rel(got_g[k], want_g[k]) for k in want_g
                if _max_rel(got_g[k], want_g[k]) > TOL})
    assert not bad, bad
    return len(got) + len(got_g)


def inputs(hw, n_out=1, seed=1):
    rs = np.random.RandomState(seed)
    x = rs.randn(2, 3, hw, hw).astype(np.float32)
    return x, [rs.randn(2, 7).astype(np.float32) for _ in range(n_out)]


@pytest.mark.parametrize("name, kwargs, hw, nhwc", CASES,
                         ids=[c[0] for c in CASES])
def test_family_matches_jax(name, kwargs, hw, nhwc):
    jax_net, port = build_pair(name, kwargs)
    x, cot = inputs(hw)
    assert hold(jax_net, port, x, cot) > 4
    if nhwc:
        jax_nhwc, port_nhwc = build_pair(name, dict(kwargs,
                                                    data_format="NHWC"))
        hold(jax_nhwc, port_nhwc, x, cot, nhwc=True)


def test_every_constructor_is_the_jax_ones():
    """The nine families' 25 constructors (with ResNet's 13 and LeNet the
    zoo's ``__all__``) and their classes are the JAX package's names."""
    names = [n for n in tm.__all__ if n[0].islower()
             and not n.startswith(("resnet", "resnext", "wide_"))]
    assert len(names) == 25 and set(tm.__all__) <= set(dir(jm))
    for name in tm.__all__:
        assert getattr(tm, name).__name__ == getattr(jm, name).__name__


def test_dropout_trains_and_the_data_format_is_checked():
    net = tm.mobilenet_v2(num_classes=5, scale=0.25)
    assert any(isinstance(m, Dropout) for m in net.modules())
    with pytest.raises(ValueError, match="data_format"):
        tm.mobilenet_v1(data_format="NCWH")
    x = torch.randn(2, 3, 32, 32)
    net.train()
    net(x).sum().backward()
    assert all(p.grad is not None for p in net.parameters())
