"""The port's InceptionV3 and AlexNet against the JAX package's, on the
CPU, as ``test_torch_vision_zoo.py`` holds the other families (the same
weights, eval mode, logits and every gradient within ``TOL`` of each
tensor's largest magnitude): InceptionV3 at 75 x 75 (its smallest input),
AlexNet at 224 x 224 (its classifier reads a fixed 6 x 6 map).
"""
import pytest

from test_torch_vision_zoo import build_pair, hold, inputs


@pytest.mark.parametrize("name, hw", [("inception_v3", 75),
                                      ("alexnet", 224)])
def test_family_matches_jax(name, hw):
    jax_net, port = build_pair(name, {})
    x, cot = inputs(hw)
    assert hold(jax_net, port, x, cot) > 4
