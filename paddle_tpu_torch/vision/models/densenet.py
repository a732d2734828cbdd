"""DenseNet 121/161/169/201/264 (counterpart of
``paddle_tpu/vision/models/densenet.py``; reference:
python/paddle/vision/models/densenet.py)."""
from __future__ import annotations

from ... import nn
from ...framework.dispatch import call_op

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201", "densenet264"]

_CFG = {
    121: (64, 32, (6, 12, 24, 16)),
    161: (96, 48, (6, 12, 36, 24)),
    169: (64, 32, (6, 12, 32, 32)),
    201: (64, 32, (6, 12, 48, 32)),
    264: (64, 32, (6, 12, 64, 48)),
}


class _DenseLayer(nn.Layer):
    def __init__(self, in_c, growth, bn_size, dropout):
        super().__init__()
        self.bn1 = nn.BatchNorm2D(in_c)
        self.conv1 = nn.Conv2D(in_c, bn_size * growth, 1, bias_attr=False)
        self.bn2 = nn.BatchNorm2D(bn_size * growth)
        self.conv2 = nn.Conv2D(bn_size * growth, growth, 3, padding=1,
                               bias_attr=False)
        self.dropout = nn.Dropout(dropout) if dropout else None
        self.relu = nn.ReLU()

    def forward(self, x):
        out = self.conv1(self.relu(self.bn1(x)))
        out = self.conv2(self.relu(self.bn2(out)))
        if self.dropout is not None:
            out = self.dropout(out)
        return call_op("concat", [x, out], axis=1)


class _Transition(nn.Layer):
    def __init__(self, in_c, out_c):
        super().__init__()
        self.bn = nn.BatchNorm2D(in_c)
        self.conv = nn.Conv2D(in_c, out_c, 1, bias_attr=False)
        self.relu = nn.ReLU()
        self.pool = nn.AvgPool2D(2, stride=2)

    def forward(self, x):
        return self.pool(self.conv(self.relu(self.bn(x))))


class DenseNet(nn.Layer):
    def __init__(self, layers=121, bn_size=4, dropout=0.0, num_classes=1000,
                 with_pool=True):
        super().__init__()
        if layers not in _CFG:
            raise ValueError(f"layers must be one of {sorted(_CFG)}")
        num_init, growth, blocks = _CFG[layers]
        self.num_classes = num_classes
        self.with_pool = with_pool
        feats = [nn.Conv2D(3, num_init, 7, stride=2, padding=3,
                           bias_attr=False),
                 nn.BatchNorm2D(num_init), nn.ReLU(),
                 nn.MaxPool2D(3, stride=2, padding=1)]
        ch = num_init
        for bi, n in enumerate(blocks):
            for _ in range(n):
                feats.append(_DenseLayer(ch, growth, bn_size, dropout))
                ch += growth
            if bi != len(blocks) - 1:
                feats.append(_Transition(ch, ch // 2))
                ch //= 2
        feats += [nn.BatchNorm2D(ch), nn.ReLU()]
        self.features = nn.Sequential(*feats)
        self._out_c = ch
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Linear(ch, num_classes)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = nn.Flatten()(x)
            x = self.fc(x)
        return x


model_urls = {
    f"densenet{n}": (
        "https://paddle-imagenet-models-name.bj.bcebos.com/dygraph/"
        f"DenseNet{n}_pretrained.pdparams", md5)
    for n, md5 in [(121, "db1b239ed80a905290fd8b01d3af08e4"),
                   (161, "62158869cb315098bd25ddbfd308a853"),
                   (169, "82cc7c635c3f19098c748850efb2d796"),
                   (201, "16ca29565a7712329cf9e36e02caaf58"),
                   (264, "3270ce516b85370bba88cfdd9f60bff4")]}


def _make(layers):
    def fn(pretrained=False, **kwargs):
        model = DenseNet(layers=layers, **kwargs)
        if pretrained:
            from ...utils.pretrained import load_pretrained
            load_pretrained(model, f"densenet{layers}", model_urls,
                            pretrained)
        return model
    fn.__name__ = f"densenet{layers}"
    return fn


densenet121 = _make(121)
densenet161 = _make(161)
densenet169 = _make(169)
densenet201 = _make(201)
densenet264 = _make(264)
