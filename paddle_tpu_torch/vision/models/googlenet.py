"""GoogLeNet / InceptionV1 (counterpart of
``paddle_tpu/vision/models/googlenet.py``; reference:
python/paddle/vision/models/googlenet.py). Returns (main, aux1, aux2) logits
in train mode like the reference."""
from __future__ import annotations

from ... import nn
from ...framework.dispatch import call_op

__all__ = ["GoogLeNet", "googlenet"]


class _Inception(nn.Layer):
    def __init__(self, in_c, c1, c3r, c3, c5r, c5, proj):
        super().__init__()
        self.b1 = nn.Sequential(nn.Conv2D(in_c, c1, 1), nn.ReLU())
        self.b2 = nn.Sequential(nn.Conv2D(in_c, c3r, 1), nn.ReLU(),
                                nn.Conv2D(c3r, c3, 3, padding=1), nn.ReLU())
        self.b3 = nn.Sequential(nn.Conv2D(in_c, c5r, 1), nn.ReLU(),
                                nn.Conv2D(c5r, c5, 5, padding=2), nn.ReLU())
        self.b4 = nn.Sequential(nn.MaxPool2D(3, stride=1, padding=1),
                                nn.Conv2D(in_c, proj, 1), nn.ReLU())

    def forward(self, x):
        return call_op("concat", [self.b1(x), self.b2(x), self.b3(x),
                                  self.b4(x)], axis=1)


class _AuxHead(nn.Layer):
    def __init__(self, in_c, num_classes):
        super().__init__()
        self.pool = nn.AdaptiveAvgPool2D((4, 4))
        self.conv = nn.Conv2D(in_c, 128, 1)
        self.fc1 = nn.Linear(128 * 16, 1024)
        self.fc2 = nn.Linear(1024, num_classes)
        self.relu = nn.ReLU()
        self.dropout = nn.Dropout(0.7)

    def forward(self, x):
        x = self.relu(self.conv(self.pool(x)))
        x = nn.Flatten()(x)
        x = self.dropout(self.relu(self.fc1(x)))
        return self.fc2(x)


class GoogLeNet(nn.Layer):
    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            nn.Conv2D(3, 64, 7, stride=2, padding=3), nn.ReLU(),
            nn.MaxPool2D(3, stride=2, ceil_mode=True),
            nn.Conv2D(64, 64, 1), nn.ReLU(),
            nn.Conv2D(64, 192, 3, padding=1), nn.ReLU(),
            nn.MaxPool2D(3, stride=2, ceil_mode=True),
        )
        self.inc3a = _Inception(192, 64, 96, 128, 16, 32, 32)
        self.inc3b = _Inception(256, 128, 128, 192, 32, 96, 64)
        self.pool3 = nn.MaxPool2D(3, stride=2, ceil_mode=True)
        self.inc4a = _Inception(480, 192, 96, 208, 16, 48, 64)
        self.inc4b = _Inception(512, 160, 112, 224, 24, 64, 64)
        self.inc4c = _Inception(512, 128, 128, 256, 24, 64, 64)
        self.inc4d = _Inception(512, 112, 144, 288, 32, 64, 64)
        self.inc4e = _Inception(528, 256, 160, 320, 32, 128, 128)
        self.pool4 = nn.MaxPool2D(3, stride=2, ceil_mode=True)
        self.inc5a = _Inception(832, 256, 160, 320, 32, 128, 128)
        self.inc5b = _Inception(832, 384, 192, 384, 48, 128, 128)
        if with_pool:
            self.pool5 = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.dropout = nn.Dropout(0.4)
            self.fc = nn.Linear(1024, num_classes)
            self.aux1 = _AuxHead(512, num_classes)
            self.aux2 = _AuxHead(528, num_classes)

    def forward(self, x):
        x = self.stem(x)
        x = self.pool3(self.inc3b(self.inc3a(x)))
        x = self.inc4a(x)
        aux1 = self.aux1(x) if (self.num_classes > 0 and self.training) \
            else None
        x = self.inc4d(self.inc4c(self.inc4b(x)))
        aux2 = self.aux2(x) if (self.num_classes > 0 and self.training) \
            else None
        x = self.pool4(self.inc4e(x))
        x = self.inc5b(self.inc5a(x))
        if self.with_pool:
            x = self.pool5(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(nn.Flatten()(x)))
        if self.training and self.num_classes > 0:
            return x, aux1, aux2
        return x


model_urls = {"googlenet": (
    "https://paddle-imagenet-models-name.bj.bcebos.com/dygraph/"
    "GoogLeNet_pretrained.pdparams", "80c06f038e905c53ab32c40eca6e26ae")}


def googlenet(pretrained=False, **kwargs):
    model = GoogLeNet(**kwargs)
    if pretrained:
        from ...utils.pretrained import load_pretrained
        load_pretrained(model, "googlenet", model_urls, pretrained)
    return model
