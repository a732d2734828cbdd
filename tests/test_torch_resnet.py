"""The port's ResNet family against the JAX package's on the CPU.

Two small networks: ``resnet18(num_classes=10)`` (``width`` does not
change a ``BasicBlock`` network's channels) and ``ResNet(BottleneckBlock,
50, width=16, num_classes=10)`` (narrowed bottlenecks), each in NCHW and
in NHWC, built in both packages from the same weights
(``convert.layer_from_jax``, key sets equal, BatchNorm's running
statistics included). One step of each (resnet18 here, the narrowed
ResNet-50 in ``test_torch_resnet_bottleneck.py``): the logits, the loss, every
parameter's gradient and the input's, the parameters after one
``Momentum(0.1, 0.9)`` step, and the running statistics, each within
``TOL`` of its tensor's largest value; the 13 constructors' shapes; the
names of the JAX ``vision`` that wait for a later slice.

BatchNorm in training normalizes by the batch's statistics, and at batch 2
and 32 x 32 the last stage's maps are 1 x 1: each of its BatchNorms sees
two values a channel, and where the two lie within ~sqrt(epsilon) of each
other the normalized output turns float32 rounding into differences of
up to 0.1 of the logits (measured: 2.5e-3 of resnet18's logits, 9.9e-2 of
the narrowed ResNet-50's; the JAX package's own NCHW and NHWC forms of the
same network differ by as much, 2.3e-3 and 0.106). So at 32 x 32 the step
is held in eval mode (BatchNorm on its running statistics, well
conditioned), and in training mode the running statistics of every
BatchNorm before the last stage. The training step is held at 64 x 64
(2 x 2 maps in the last stage) in ``test_torch_resnet_train.py``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.optimizer import Momentum as JaxMomentum
from paddle_tpu.vision.models import ResNet as JaxResNet
from paddle_tpu.vision.models import resnet18 as jax_resnet18
from paddle_tpu.vision.models.resnet import BottleneckBlock as JaxBottleneck
import paddle_tpu_torch as pt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import vision
from paddle_tpu_torch.convert import layer_from_jax, layer_to_numpy
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.vision.models import ResNet, resnet18
from paddle_tpu_torch.vision.models.resnet import BottleneckBlock

#: float32 in both packages, the same arithmetic in another order
TOL = 1e-4
NETS = {
    "resnet18": (lambda df: jax_resnet18(num_classes=10, data_format=df),
                 lambda df: resnet18(num_classes=10, data_format=df)),
    "resnet50_w16": (
        lambda df: JaxResNet(JaxBottleneck, 50, width=16, num_classes=10,
                             data_format=df),
        lambda df: ResNet(BottleneckBlock, 50, width=16, num_classes=10,
                          data_format=df)),
}


@pytest.fixture(autouse=True)
def cpu_default():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


def _pair(net, df):
    paddle.seed(0)
    jax_net, port_net = NETS[net][0](df), NETS[net][1](df)
    state = {k: np.asarray(v.numpy()) for k, v in jax_net.state_dict().items()}
    assert set(port_net.state_dict()) == set(state)
    layer_from_jax(port_net, state)
    return jax_net, port_net


def _batch(df, hw, seed=1):
    rs = np.random.RandomState(seed)
    x = rs.randn(2, 3, hw, hw).astype(np.float32)
    if df == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    return x, rs.randint(0, 10, (2, 1)).astype(np.int64)


def _jax_step(net, x, y, training):
    net.train() if training else net.eval()
    xt = paddle.to_tensor(x, stop_gradient=False)
    logits = net(xt)
    loss = jnn.CrossEntropyLoss()(logits, paddle.to_tensor(y))
    loss.backward()
    grads = {n: p.grad.numpy() for n, p in net.named_parameters()}
    opt = JaxMomentum(learning_rate=0.1, momentum=0.9,
                      parameters=net.parameters())
    opt.step()
    state = {k: np.asarray(v.numpy()) for k, v in net.state_dict().items()}
    return logits.numpy(), float(loss.numpy()), xt.grad.numpy(), grads, \
        state


def _port_step(net, x, y, training):
    net.train() if training else net.eval()
    xt = torch.tensor(x, requires_grad=True)
    logits = net(xt)
    loss = tnn.CrossEntropyLoss()(logits, torch.from_numpy(y))
    loss.backward()
    grads = {n: p.grad.numpy().T if n == "fc.weight" else p.grad.numpy()
             for n, p in net.named_parameters()}
    Momentum(learning_rate=0.1, momentum=0.9,
             parameters=net.parameters()).step()
    return logits.detach().numpy(), loss.item(), xt.grad.numpy(), grads, \
        layer_to_numpy(net)


def _rel(got, want):
    return float(np.abs(got - want).max()) / max(
        float(np.abs(want).max()), 1e-30)


def _hold(got, want, keys=None):
    """Every compared tensor within ``TOL`` of its largest value."""
    g_logits, g_loss, g_dx, g_grads, g_state = got
    w_logits, w_loss, w_dx, w_grads, w_state = want
    bad = {}
    pairs = [("logits", g_logits, w_logits), ("d input", g_dx, w_dx)] + \
        [(f"grad {k}", g_grads[k], w_grads[k]) for k in w_grads] + \
        [(f"state {k}", g_state[k], w_state[k]) for k in w_state
         if keys is None or k in keys]
    for name, a, b in pairs:
        if not _rel(a, b) <= TOL:
            bad[name] = _rel(a, b)
    if not abs(g_loss - w_loss) <= TOL * abs(w_loss):
        bad["loss"] = (g_loss, w_loss)
    assert set(g_grads) == set(w_grads)
    assert not bad, bad


def _stats(state):
    return {k for k in state if k.endswith(("_mean", "_variance"))}


def check_step_at_32(net, df):
    """Batch 2 at 32 x 32. With BatchNorm on its running statistics: the
    logits, the loss, every gradient and one Momentum step. In training
    mode: the running statistics of every BatchNorm before the last stage
    after one forward (see the module docstring for the last stage)."""
    jax_net, port_net = _pair(net, df)
    x, y = _batch(df, 32)
    _hold(_port_step(port_net, x, y, False), _jax_step(jax_net, x, y, False))
    jax_net.train()
    port_net.train()
    jax_net(paddle.to_tensor(x))
    with torch.no_grad():
        port_net(torch.from_numpy(x))
    want = {k: np.asarray(v.numpy()) for k, v in jax_net.state_dict().items()}
    got = layer_to_numpy(port_net)
    keys = {k for k in _stats(want) if not k.startswith("layer4")}
    assert len(keys) > 10
    bad = {k: _rel(got[k], want[k]) for k in keys
           if not _rel(got[k], want[k]) <= TOL}
    assert not bad, bad


@pytest.mark.parametrize("df", ["NCHW", "NHWC"])
def test_resnet18_step_matches_jax_at_32(df):
    check_step_at_32("resnet18", df)


def test_the_constructors_build_the_reference_shapes():
    """resnet34 and the grouped resnext50_32x4d have the JAX networks'
    state keys and shapes (the other constructors differ from these and
    the networks above only in depth and width), and each of the 13 raises
    naming item 5 at ``pretrained=True``."""
    from paddle_tpu.vision import models as jm
    from paddle_tpu_torch.vision import models as tm
    for name in ("resnet34", "resnext50_32x4d"):
        j = getattr(jm, name)(num_classes=7)
        t = getattr(tm, name)(num_classes=7)
        want = {k: tuple(v.shape) for k, v in j.state_dict().items()}
        got = {k: tuple(v.shape[::-1]) if k == "fc.weight" else
               tuple(v.shape) for k, v in t.state_dict().items()}
        assert got == want, name
    for name in tm.__all__[1:]:
        with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
            getattr(tm, name)(pretrained=True)


def test_the_rest_of_vision_raises_naming_item_5():
    from paddle_tpu import vision as jv
    from paddle_tpu.vision import models as jm
    for port, ref in ((vision, jv), (vision.models, jm)):
        for name in (n for n in dir(ref) if not n.startswith("_")):
            if name in vars(port):
                continue
            with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
                getattr(port, name)
