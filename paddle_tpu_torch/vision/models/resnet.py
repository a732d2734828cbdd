"""The ResNet family (counterpart of
``paddle_tpu/vision/models/resnet.py``): ``BasicBlock``,
``BottleneckBlock``, ``ResNet`` and its 13 constructors.

Every model takes ``data_format="NCHW"`` (the default) or ``"NHWC"``; the
convolution weights stay ``[out, in, kh, kw]`` in both, so one state
serves both layouts and crosses to and from the JAX package unchanged
(``convert.layer_from_jax``). In NHWC the activations stay channel-last
from layer to layer; each convolution and pool gives cuDNN its input as
the NCHW view of the same memory (``torch.channels_last``) and returns
the NHWC view of its output. ``pretrained=`` loads the reference's
``.pdparams`` from a path, or (``True``) the published file from the
local weights cache (``utils.pretrained``).
"""
from __future__ import annotations

import functools

from ... import nn

__all__ = ["ResNet", "resnet18", "resnet34", "resnet50", "resnet101",
           "resnet152", "resnext50_32x4d", "resnext50_64x4d",
           "resnext101_32x4d", "resnext101_64x4d", "resnext152_32x4d",
           "resnext152_64x4d", "wide_resnet50_2", "wide_resnet101_2"]


class BasicBlock(nn.Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW"):
        super().__init__()
        if norm_layer is None:
            # the default norm takes the layout; a custom norm_layer keeps
            # the reference's norm_layer(planes) call
            norm_layer = functools.partial(nn.BatchNorm2D,
                                           data_format=data_format)
        df = {"data_format": data_format}
        self.conv1 = nn.Conv2D(inplanes, planes, 3, stride=stride,
                               padding=1, bias_attr=False, **df)
        self.bn1 = norm_layer(planes)
        self.relu = nn.ReLU()
        self.conv2 = nn.Conv2D(planes, planes, 3, padding=1,
                               bias_attr=False, **df)
        self.bn2 = norm_layer(planes)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW"):
        super().__init__()
        if norm_layer is None:
            norm_layer = functools.partial(nn.BatchNorm2D,
                                           data_format=data_format)
        width = int(planes * (base_width / 64.0)) * groups
        df = {"data_format": data_format}
        self.conv1 = nn.Conv2D(inplanes, width, 1, bias_attr=False, **df)
        self.bn1 = norm_layer(width)
        self.conv2 = nn.Conv2D(width, width, 3, padding=dilation,
                               stride=stride, groups=groups,
                               dilation=dilation, bias_attr=False, **df)
        self.bn2 = norm_layer(width)
        self.conv3 = nn.Conv2D(width, planes * self.expansion, 1,
                               bias_attr=False, **df)
        self.bn3 = norm_layer(planes * self.expansion)
        self.relu = nn.ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Layer):
    """ResNet of ``depth`` 18, 34, 50, 101 or 152 over ``block``;
    ``width`` is the bottleneck's base width (64: ResNet; 128: wide;
    with ``groups``: ResNeXt). ``num_classes=0`` leaves out the head,
    ``with_pool=False`` the global pool."""

    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, data_format="NCHW"):
        super().__init__()
        if data_format not in ("NCHW", "NHWC"):
            raise ValueError(f"data_format must be NCHW or NHWC, "
                             f"got {data_format!r}")
        self.data_format = data_format
        layer_cfg = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                     101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
        layers = layer_cfg[depth]
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.inplanes = 64
        self.dilation = 1
        df = {"data_format": data_format}
        self.conv1 = nn.Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                               bias_attr=False, **df)
        self.bn1 = nn.BatchNorm2D(self.inplanes, **df)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(3, stride=2, padding=1, **df)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1),
                                                data_format=data_format)
        if num_classes > 0:
            self.fc = nn.Linear(512 * block.expansion, num_classes)
        self.flatten = nn.Flatten()

    def _make_layer(self, block, planes, blocks, stride=1):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2D(self.inplanes, planes * block.expansion, 1,
                          stride=stride, bias_attr=False,
                          data_format=self.data_format),
                nn.BatchNorm2D(planes * block.expansion,
                               data_format=self.data_format),
            )
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width,
                        data_format=self.data_format)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width,
                                data_format=self.data_format))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(self.flatten(x))
        return x


# reference resnet.py:25-62: the published files' names, resolved in the
# local weights cache (utils/pretrained.py); weights stay OIHW, so one file
# serves the NCHW and NHWC models
model_urls = {
    "resnet18": ("https://paddle-hapi.bj.bcebos.com/models/resnet18.pdparams",
                 "cf548f46534aa3560945be4b95cd11c4"),
    "resnet34": ("https://paddle-hapi.bj.bcebos.com/models/resnet34.pdparams",
                 "8d2275cf8706028345f78ac0e1d31969"),
    "resnet50": ("https://paddle-hapi.bj.bcebos.com/models/resnet50.pdparams",
                 "ca6f485ee1ab0492d38f323885b0ad80"),
    "resnet101": (
        "https://paddle-hapi.bj.bcebos.com/models/resnet101.pdparams",
        "02f35f034ca3858e1e54d4036443c92d"),
    "resnet152": (
        "https://paddle-hapi.bj.bcebos.com/models/resnet152.pdparams",
        "7ad16a2f1e7333859ff986138630fd7a"),
    "wide_resnet50_2": (
        "https://paddle-hapi.bj.bcebos.com/models/wide_resnet50_2.pdparams",
        "0282f804d73debdab289bd9fea3fa6dc"),
    "wide_resnet101_2": (
        "https://paddle-hapi.bj.bcebos.com/models/wide_resnet101_2.pdparams",
        "d4360a2d23657f059216f5d5a1a9ac93"),
    "resnext50_32x4d": (
        "https://paddle-hapi.bj.bcebos.com/models/resnext50_32x4d.pdparams",
        "dc47483169be7d6f018fcbb7baf8775d"),
    "resnext50_64x4d": (
        "https://paddle-hapi.bj.bcebos.com/models/resnext50_64x4d.pdparams",
        "063d4b483e12b06388529450ad7576db"),
    "resnext101_32x4d": (
        "https://paddle-hapi.bj.bcebos.com/models/resnext101_32x4d.pdparams",
        "967b090039f9de2c8d06fe994fb9095f"),
    "resnext101_64x4d": (
        "https://paddle-hapi.bj.bcebos.com/models/resnext101_64x4d.pdparams",
        "98e04e7ca616a066699230d769d03008"),
    "resnext152_32x4d": (
        "https://paddle-hapi.bj.bcebos.com/models/resnext152_32x4d.pdparams",
        "18ff0beee21f2efc99c4b31786107121"),
    "resnext152_64x4d": (
        "https://paddle-hapi.bj.bcebos.com/models/resnext152_64x4d.pdparams",
        "77c4af00ca42c405fa7f841841959379"),
}


def _resnet(arch, block, depth, width=64, pretrained=False, **kwargs):
    model = ResNet(block, depth, width=width, **kwargs)
    if pretrained:
        from ...utils.pretrained import load_pretrained
        load_pretrained(model, arch, model_urls, pretrained)
    return model


def resnet18(pretrained=False, **kwargs):
    return _resnet("resnet18", BasicBlock, 18, pretrained=pretrained,
                   **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet("resnet34", BasicBlock, 34, pretrained=pretrained,
                   **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet("resnet50", BottleneckBlock, 50, pretrained=pretrained,
                   **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet("resnet101", BottleneckBlock, 101, pretrained=pretrained,
                   **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet("resnet152", BottleneckBlock, 152, pretrained=pretrained,
                   **kwargs)


def _resnext(arch, depth, groups, base_width, pretrained, **kwargs):
    # BottleneckBlock with grouped 3x3 convolutions; base_width 4 narrows
    # each group's channels
    return _resnet(arch, BottleneckBlock, depth, width=base_width,
                   pretrained=pretrained, groups=groups, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    return _resnext("resnext50_32x4d", 50, 32, 4, pretrained, **kwargs)


def resnext50_64x4d(pretrained=False, **kwargs):
    return _resnext("resnext50_64x4d", 50, 64, 4, pretrained, **kwargs)


def resnext101_32x4d(pretrained=False, **kwargs):
    return _resnext("resnext101_32x4d", 101, 32, 4, pretrained, **kwargs)


def resnext101_64x4d(pretrained=False, **kwargs):
    return _resnext("resnext101_64x4d", 101, 64, 4, pretrained, **kwargs)


def resnext152_32x4d(pretrained=False, **kwargs):
    return _resnext("resnext152_32x4d", 152, 32, 4, pretrained, **kwargs)


def resnext152_64x4d(pretrained=False, **kwargs):
    return _resnext("resnext152_64x4d", 152, 64, 4, pretrained, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    return _resnet("wide_resnet50_2", BottleneckBlock, 50, width=128,
                   pretrained=pretrained, **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    return _resnet("wide_resnet101_2", BottleneckBlock, 101, width=128,
                   pretrained=pretrained, **kwargs)
