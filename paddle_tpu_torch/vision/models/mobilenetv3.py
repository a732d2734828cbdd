"""MobileNetV3 small/large (counterpart of
``paddle_tpu/vision/models/mobilenetv3.py``; reference:
python/paddle/vision/models/mobilenetv3.py)."""
from __future__ import annotations

from ... import nn

__all__ = ["MobileNetV3Small", "MobileNetV3Large", "mobilenet_v3_small",
           "mobilenet_v3_large"]


def _make_divisible(v, divisor=8, min_value=None):
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class _SE(nn.Layer):
    def __init__(self, c, reduction=4):
        super().__init__()
        mid = _make_divisible(c // reduction)
        self.pool = nn.AdaptiveAvgPool2D(1)
        self.fc1 = nn.Conv2D(c, mid, 1)
        self.fc2 = nn.Conv2D(mid, c, 1)
        self.relu = nn.ReLU()
        self.hs = nn.Hardsigmoid()

    def forward(self, x):
        s = self.hs(self.fc2(self.relu(self.fc1(self.pool(x)))))
        return x * s


class _ConvBNAct(nn.Layer):
    def __init__(self, in_c, out_c, k, stride=1, groups=1, act=None):
        super().__init__()
        self.conv = nn.Conv2D(in_c, out_c, k, stride=stride, padding=k // 2,
                              groups=groups, bias_attr=False)
        self.bn = nn.BatchNorm2D(out_c)
        self.act = {"relu": nn.ReLU(), "hardswish": nn.Hardswish(),
                    None: None}[act]

    def forward(self, x):
        x = self.bn(self.conv(x))
        return self.act(x) if self.act is not None else x


class _InvertedResidualV3(nn.Layer):
    def __init__(self, in_c, exp_c, out_c, k, stride, use_se, act):
        super().__init__()
        self.use_res = stride == 1 and in_c == out_c
        layers = []
        if exp_c != in_c:
            layers.append(_ConvBNAct(in_c, exp_c, 1, act=act))
        layers.append(_ConvBNAct(exp_c, exp_c, k, stride=stride,
                                 groups=exp_c, act=act))
        if use_se:
            layers.append(_SE(exp_c))
        layers.append(_ConvBNAct(exp_c, out_c, 1, act=None))
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        return x + out if self.use_res else out


# (kernel, exp, out, se, act, stride) per reference config
_LARGE = [
    (3, 16, 16, False, "relu", 1), (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1), (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1), (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hardswish", 2), (3, 200, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1), (3, 184, 80, False, "hardswish", 1),
    (3, 480, 112, True, "hardswish", 1), (3, 672, 112, True, "hardswish", 1),
    (5, 672, 160, True, "hardswish", 2), (5, 960, 160, True, "hardswish", 1),
    (5, 960, 160, True, "hardswish", 1),
]
_SMALL = [
    (3, 16, 16, True, "relu", 2), (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1), (5, 96, 40, True, "hardswish", 2),
    (5, 240, 40, True, "hardswish", 1), (5, 240, 40, True, "hardswish", 1),
    (5, 120, 48, True, "hardswish", 1), (5, 144, 48, True, "hardswish", 1),
    (5, 288, 96, True, "hardswish", 2), (5, 576, 96, True, "hardswish", 1),
    (5, 576, 96, True, "hardswish", 1),
]


class _MobileNetV3(nn.Layer):
    def __init__(self, cfg, last_exp, last_c, scale=1.0, num_classes=1000,
                 with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool

        def c(ch):
            return _make_divisible(ch * scale)

        in_c = c(16)
        feats = [_ConvBNAct(3, in_c, 3, stride=2, act="hardswish")]
        for k, exp, out, se, act, s in cfg:
            feats.append(_InvertedResidualV3(in_c, c(exp), c(out), k, s, se,
                                             act))
            in_c = c(out)
        feats.append(_ConvBNAct(in_c, c(last_exp), 1, act="hardswish"))
        self.features = nn.Sequential(*feats)
        self._feat_c = c(last_exp)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(self._feat_c, last_c), nn.Hardswish(),
                nn.Dropout(0.2), nn.Linear(last_c, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = nn.Flatten()(x)
            x = self.classifier(x)
        return x


class MobileNetV3Large(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_LARGE, 960, 1280, scale, num_classes, with_pool)


class MobileNetV3Small(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_SMALL, 576, 1024, scale, num_classes, with_pool)


model_urls = {
    "mobilenet_v3_small_x1.0": (
        "https://paddle-hapi.bj.bcebos.com/models/"
        "mobilenet_v3_small_x1.0.pdparams",
        "34fe0e7c1f8b00b2b056ad6788d0590c"),
    "mobilenet_v3_large_x1.0": (
        "https://paddle-hapi.bj.bcebos.com/models/"
        "mobilenet_v3_large_x1.0.pdparams",
        "118db5792b4e183b925d8e8e334db3df"),
}


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    model = MobileNetV3Small(scale=scale, **kwargs)
    if pretrained:
        from ...utils.pretrained import load_pretrained
        load_pretrained(model, f"mobilenet_v3_small_x{scale}", model_urls,
                        pretrained)
    return model


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    model = MobileNetV3Large(scale=scale, **kwargs)
    if pretrained:
        from ...utils.pretrained import load_pretrained
        load_pretrained(model, f"mobilenet_v3_large_x{scale}", model_urls,
                        pretrained)
    return model
