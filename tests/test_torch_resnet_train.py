"""The ResNet family's training step against the JAX package's on the CPU
(the networks, helpers and the 32 x 32 checks: ``test_torch_resnet.py``).

Batch 2 at 64 x 64, in training mode: resnet18 in NCHW and the narrowed
ResNet-50 in NHWC (each network's other layout is held at 32 x 32 in
eval mode there; one layout each keeps this file near a minute). As built (ReLU): the logits, the loss, every BatchNorm's running
statistics after one forward within ``TOL`` of each tensor's largest
value. With every ReLU of both networks swapped for GELU: the logits, the
loss, the input's and every parameter's gradient and the parameters after
one ``Momentum(0.1, 0.9)`` step within ``GRAD_TOL``. ReLU's kink turns
float32 rounding into gradient differences: a BatchNorm over 8 values a
channel (the last stage's 2 x 2 maps) puts some pre-activations within
rounding of 0, and the narrowed ResNet-50's gradients then differ by up to
0.19 of their largest value (layer4.0's downsample weight), while the JAX
package's NCHW and NHWC forms agree to 1.4e-4 (XLA runs both in one
layout). With GELU the largest difference measured is 3.4e-4, in the
weight gradients of the first stage's BatchNorms: each sums 512 products
of either sign. The JAX optimizers key their state by parameter name,
which every parameter of these networks has of its own.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import layer_to_numpy
from test_torch_resnet import (NETS, TOL, _batch, _jax_step, _pair,  # noqa
                               _port_step, _rel, _stats, cpu_default)

#: gradients and the updated parameters of the GELU networks
GRAD_TOL = 1e-3


def _gelu(net, nn):
    for layer in [net] + list(net.sublayers()):
        if hasattr(layer, "relu"):
            layer.relu = nn.GELU()


@pytest.mark.parametrize("net, df", [("resnet18", "NCHW"),
                                     ("resnet50_w16", "NHWC")])
def test_train_step_matches_jax_at_64(net, df):
    x, y = _batch(df, 64)
    jax_net, port_net = _pair(net, df)
    jax_net.train()
    port_net.train()
    want_logits = jax_net(paddle.to_tensor(x))
    want_loss = float(jnn.CrossEntropyLoss()(
        want_logits, paddle.to_tensor(y)).numpy())
    got_logits = port_net(torch.from_numpy(x))
    got_loss = tnn.CrossEntropyLoss()(got_logits, torch.from_numpy(y))
    assert _rel(got_logits.detach().numpy(), want_logits.numpy()) <= TOL
    assert abs(got_loss.item() - want_loss) <= TOL * abs(want_loss)
    want = {k: np.asarray(v.numpy()) for k, v in jax_net.state_dict().items()}
    got = layer_to_numpy(port_net)
    bad = {k: _rel(got[k], want[k]) for k in _stats(want)
           if not _rel(got[k], want[k]) <= TOL}
    assert not bad, bad

    jax_net, port_net = _pair(net, df)
    _gelu(jax_net, jnn)
    _gelu(port_net, tnn)
    g_logits, g_loss, g_dx, g_grads, g_state = _port_step(port_net, x, y,
                                                          True)
    w_logits, w_loss, w_dx, w_grads, w_state = _jax_step(jax_net, x, y, True)
    assert set(g_grads) == set(w_grads)
    pairs = [("logits", g_logits, w_logits), ("d input", g_dx, w_dx)] + \
        [(f"grad {k}", g_grads[k], w_grads[k]) for k in w_grads] + \
        [(f"state {k}", g_state[k], w_state[k]) for k in w_state]
    bad = {name: _rel(a, b) for name, a, b in pairs
           if not _rel(a, b) <= GRAD_TOL}
    assert abs(g_loss - w_loss) <= TOL * abs(w_loss)
    assert not bad, bad
