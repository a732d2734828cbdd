"""The port's MobileNet V1/V2/V3 and ShuffleNetV2 against the JAX
package's, on the CPU, as ``test_torch_vision_zoo.py`` holds the other
families (the same weights, eval mode, logits and every gradient within
``TOL`` of each tensor's largest magnitude). MobileNetV2 runs in NCHW and
in NHWC; each family at a narrow ``scale`` or its smallest width (one
member a family: the others differ only in widths and block counts).
"""
import pytest

from test_torch_vision_zoo import build_pair, hold, inputs

#: (constructor, kwargs, input side, NHWC)
CASES = [
    ("mobilenet_v1", {"scale": 0.25}, 32, False),
    ("mobilenet_v2", {"scale": 0.5}, 32, True),
    ("mobilenet_v3_small", {"scale": 0.5}, 32, False),
    ("shufflenet_v2_x0_25", {}, 32, False),
]


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
