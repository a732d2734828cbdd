"""The port's DenseNet and GoogLeNet against the JAX package's, on the
CPU, as ``test_torch_vision_zoo.py`` holds the other families (the same
weights, logits and every gradient within ``TOL`` of each tensor's
largest magnitude): DenseNet-121 in eval mode; GoogLeNet in training
mode with its dropout off, so that its main and two auxiliary heads are
all compared.
"""
from paddle_tpu.nn import Dropout as JaxDropout
from paddle_tpu_torch.nn.layer.common import Dropout

from test_torch_vision_zoo import build_pair, hold, inputs


def test_densenet121_matches_jax():
    jax_net, port = build_pair("densenet121", {})
    x, cot = inputs(32)
    assert hold(jax_net, port, x, cot) > 4


def test_googlenet_with_its_auxiliary_heads_matches_jax():
    jax_net, port = build_pair("googlenet", {})
    for net, drop in ((jax_net, JaxDropout), (port, Dropout)):
        layers = [m for m in (net.sublayers() if hasattr(net, "sublayers")
                              else net.modules()) if isinstance(m, drop)]
        assert len(layers) == 3
        for m in layers:
            m.p = 0.0
    x, cot = inputs(64, n_out=3)
    assert hold(jax_net, port, x, cot, training=True) > 6
