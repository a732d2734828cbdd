"""SqueezeNet 1.0/1.1 (counterpart of
``paddle_tpu/vision/models/squeezenet.py``; reference:
python/paddle/vision/models/squeezenet.py)."""
from __future__ import annotations

from ... import nn

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class Fire(nn.Layer):
    def __init__(self, in_c, squeeze_c, e1_c, e3_c):
        super().__init__()
        self.squeeze = nn.Conv2D(in_c, squeeze_c, 1)
        self.expand1 = nn.Conv2D(squeeze_c, e1_c, 1)
        self.expand3 = nn.Conv2D(squeeze_c, e3_c, 3, padding=1)
        self.relu = nn.ReLU()

    def forward(self, x):
        x = self.relu(self.squeeze(x))
        from ...framework.dispatch import call_op
        return call_op("concat", [self.relu(self.expand1(x)),
                                  self.relu(self.expand3(x))], axis=1)


class SqueezeNet(nn.Layer):
    def __init__(self, version="1.0", num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        if version == "1.0":
            self.features = nn.Sequential(
                nn.Conv2D(3, 96, 7, stride=2), nn.ReLU(),
                nn.MaxPool2D(3, stride=2, ceil_mode=True),
                Fire(96, 16, 64, 64), Fire(128, 16, 64, 64),
                Fire(128, 32, 128, 128),
                nn.MaxPool2D(3, stride=2, ceil_mode=True),
                Fire(256, 32, 128, 128), Fire(256, 48, 192, 192),
                Fire(384, 48, 192, 192), Fire(384, 64, 256, 256),
                nn.MaxPool2D(3, stride=2, ceil_mode=True),
                Fire(512, 64, 256, 256),
            )
        else:
            self.features = nn.Sequential(
                nn.Conv2D(3, 64, 3, stride=2), nn.ReLU(),
                nn.MaxPool2D(3, stride=2, ceil_mode=True),
                Fire(64, 16, 64, 64), Fire(128, 16, 64, 64),
                nn.MaxPool2D(3, stride=2, ceil_mode=True),
                Fire(128, 32, 128, 128), Fire(256, 32, 128, 128),
                nn.MaxPool2D(3, stride=2, ceil_mode=True),
                Fire(256, 48, 192, 192), Fire(384, 48, 192, 192),
                Fire(384, 64, 256, 256), Fire(512, 64, 256, 256),
            )
        if num_classes > 0:
            self.classifier_conv = nn.Conv2D(512, num_classes, 1)
            self.dropout = nn.Dropout(0.5)
            self.relu = nn.ReLU()
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.relu(self.classifier_conv(self.dropout(x)))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = nn.Flatten()(x)
        return x


model_urls = {
    "squeezenet1_0": (
        "https://paddle-imagenet-models-name.bj.bcebos.com/dygraph/"
        "SqueezeNet1_0_pretrained.pdparams",
        "30b95af60a2178f03cf9b66cd77e1db1"),
    "squeezenet1_1": (
        "https://paddle-imagenet-models-name.bj.bcebos.com/dygraph/"
        "SqueezeNet1_1_pretrained.pdparams",
        "a11250d3a1f91d7131fd095ebbf09eee"),
}


def squeezenet1_0(pretrained=False, **kwargs):
    model = SqueezeNet("1.0", **kwargs)
    if pretrained:
        from ...utils.pretrained import load_pretrained
        load_pretrained(model, "squeezenet1_0", model_urls, pretrained)
    return model


def squeezenet1_1(pretrained=False, **kwargs):
    model = SqueezeNet("1.1", **kwargs)
    if pretrained:
        from ...utils.pretrained import load_pretrained
        load_pretrained(model, "squeezenet1_1", model_urls, pretrained)
    return model
