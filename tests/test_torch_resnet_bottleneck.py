"""The narrowed ResNet-50 (``ResNet(BottleneckBlock, 50, width=16,
num_classes=10)``) against the JAX package's at batch 2 and 32 x 32, in
NCHW and in NHWC: the checks and their tolerance are
``test_torch_resnet.py``'s (split off so that each file runs in about a
minute on one worker)."""
import pytest

from test_torch_resnet import check_step_at_32, cpu_default  # noqa: F401


@pytest.mark.parametrize("df", ["NCHW", "NHWC"])
def test_resnet50_w16_step_matches_jax_at_32(df):
    check_step_at_32("resnet50_w16", df)
