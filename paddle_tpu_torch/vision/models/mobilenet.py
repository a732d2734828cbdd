"""MobileNet V1/V2 (counterpart of
``paddle_tpu/vision/models/mobilenet.py``; reference:
python/paddle/vision/models/mobilenetv1.py,
mobilenetv2.py). ``data_format="NHWC"`` runs the whole network
channels-last (each convolution hands cuDNN the NCHW view of the same
memory, as vision/models/resnet.py does); weights stay OIHW so
checkpoints are layout-independent.
"""
from __future__ import annotations

from ... import nn

__all__ = ["MobileNetV1", "MobileNetV2", "mobilenet_v1", "mobilenet_v2"]


class ConvBNRelu(nn.Layer):
    def __init__(self, in_c, out_c, kernel, stride=1, padding=0, groups=1,
                 relu6=True, data_format="NCHW"):
        super().__init__()
        self.conv = nn.Conv2D(in_c, out_c, kernel, stride=stride,
                              padding=padding, groups=groups,
                              bias_attr=False, data_format=data_format)
        self.bn = nn.BatchNorm2D(out_c, data_format=data_format)
        self.act = nn.ReLU6() if relu6 else nn.ReLU()

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class DepthwiseSeparable(nn.Layer):
    def __init__(self, in_c, out_c, stride, data_format="NCHW"):
        super().__init__()
        self.dw = ConvBNRelu(in_c, in_c, 3, stride=stride, padding=1,
                             groups=in_c, relu6=False,
                             data_format=data_format)
        self.pw = ConvBNRelu(in_c, out_c, 1, relu6=False,
                             data_format=data_format)

    def forward(self, x):
        return self.pw(self.dw(x))


def _check_data_format(data_format):
    # same loud rejection as ResNet (resnet.py:91) — a typo must not
    # reach the conv/BN kernels, whose layout fallbacks disagree
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"data_format must be NCHW or NHWC, "
                         f"got {data_format!r}")


class MobileNetV1(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 data_format="NCHW"):
        super().__init__()
        _check_data_format(data_format)
        self.num_classes = num_classes
        self.with_pool = with_pool

        def c(ch):
            return max(1, int(ch * scale))

        cfg = [(c(32), c(64), 1), (c(64), c(128), 2), (c(128), c(128), 1),
               (c(128), c(256), 2), (c(256), c(256), 1),
               (c(256), c(512), 2)] + [(c(512), c(512), 1)] * 5 + \
              [(c(512), c(1024), 2), (c(1024), c(1024), 1)]
        layers = [ConvBNRelu(3, c(32), 3, stride=2, padding=1,
                             relu6=False, data_format=data_format)]
        for in_c, out_c, s in cfg:
            layers.append(DepthwiseSeparable(in_c, out_c, s,
                                             data_format=data_format))
        self.features = nn.Sequential(*layers)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1),
                                             data_format=data_format)
        if num_classes > 0:
            self.fc = nn.Linear(c(1024), num_classes)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = nn.Flatten()(x)
            x = self.fc(x)
        return x


class InvertedResidual(nn.Layer):
    def __init__(self, in_c, out_c, stride, expand_ratio,
                 data_format="NCHW"):
        super().__init__()
        hidden = int(round(in_c * expand_ratio))
        self.use_res = stride == 1 and in_c == out_c
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNRelu(in_c, hidden, 1,
                                     data_format=data_format))
        layers += [
            ConvBNRelu(hidden, hidden, 3, stride=stride, padding=1,
                       groups=hidden, data_format=data_format),
            nn.Conv2D(hidden, out_c, 1, bias_attr=False,
                      data_format=data_format),
            nn.BatchNorm2D(out_c, data_format=data_format),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 data_format="NCHW"):
        super().__init__()
        _check_data_format(data_format)
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]

        def c(ch):
            return max(8, int(ch * scale))

        in_c = c(32)
        layers = [ConvBNRelu(3, in_c, 3, stride=2, padding=1,
                             data_format=data_format)]
        for t, ch, n, s in cfg:
            out_c = c(ch)
            for i in range(n):
                layers.append(InvertedResidual(
                    in_c, out_c, s if i == 0 else 1, t,
                    data_format=data_format))
                in_c = out_c
        self.last_c = c(1280) if scale > 1.0 else 1280
        layers.append(ConvBNRelu(in_c, self.last_c, 1,
                                 data_format=data_format))
        self.features = nn.Sequential(*layers)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1),
                                             data_format=data_format)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.2), nn.Linear(self.last_c, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = nn.Flatten()(x)
            x = self.classifier(x)
        return x


model_urls = {
    "mobilenetv1_1.0": (
        "https://paddle-hapi.bj.bcebos.com/models/mobilenetv1_1.0.pdparams",
        "3033ab1975b1670bef51545feb65fc45"),
    "mobilenetv2_1.0": (
        "https://paddle-hapi.bj.bcebos.com/models/mobilenet_v2_x1.0.pdparams",
        "0340af0a901346c8d46f4529882fb63d"),
}


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    model = MobileNetV1(scale=scale, **kwargs)
    if pretrained:
        from ...utils.pretrained import load_pretrained
        load_pretrained(model, f"mobilenetv1_{scale}", model_urls,
                        pretrained)
    return model


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    model = MobileNetV2(scale=scale, **kwargs)
    if pretrained:
        from ...utils.pretrained import load_pretrained
        load_pretrained(model, f"mobilenetv2_{scale}", model_urls,
                        pretrained)
    return model
