"""The vision model zoo (counterpart of ``paddle_tpu/vision/models``):
the ResNet family and LeNet. The other models raise
``NotImplementedError`` naming ROADMAP Queue 1 item 5."""
from ...ops.registry import not_ported as _not_ported
from .resnet import (  # noqa: F401
    BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34, resnet50,
    resnet101, resnet152, resnext50_32x4d, resnext50_64x4d,
    resnext101_32x4d, resnext101_64x4d, resnext152_32x4d, resnext152_64x4d,
    wide_resnet50_2, wide_resnet101_2,
)
from . import lenet, resnet  # noqa: F401
from .lenet import LeNet  # noqa: F401

__all__ = ["ResNet", "resnet18", "resnet34", "resnet50", "resnet101",
           "resnet152", "resnext50_32x4d", "resnext50_64x4d",
           "resnext101_32x4d", "resnext101_64x4d", "resnext152_32x4d",
           "resnext152_64x4d", "wide_resnet50_2", "wide_resnet101_2"]

_DEFERRED = frozenset((
    "VGG", "vgg", "vgg11", "vgg13", "vgg16", "vgg19",
    "MobileNetV1", "MobileNetV2", "mobilenet", "mobilenet_v1",
    "mobilenet_v2", "MobileNetV3Large", "MobileNetV3Small", "mobilenetv3",
    "mobilenet_v3_large", "mobilenet_v3_small", "AlexNet", "alexnet",
    "SqueezeNet", "squeezenet", "squeezenet1_0", "squeezenet1_1",
    "DenseNet", "densenet", "densenet121", "densenet161", "densenet169",
    "densenet201", "densenet264", "GoogLeNet", "googlenet", "InceptionV3",
    "inceptionv3", "inception_v3", "ShuffleNetV2", "shufflenetv2",
    "shufflenet_v2_swish", "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
    "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
    "shufflenet_v2_x2_0"))


def __getattr__(name):
    if name in _DEFERRED:
        raise _not_ported(f"vision.models.{name}", 5)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
