"""AlexNet (counterpart of
``paddle_tpu/vision/models/alexnet.py``; reference:
python/paddle/vision/models/alexnet.py)."""
from __future__ import annotations

from ... import nn

__all__ = ["AlexNet", "alexnet"]


class AlexNet(nn.Layer):
    def __init__(self, num_classes=1000):
        super().__init__()
        self.num_classes = num_classes
        self.features = nn.Sequential(
            nn.Conv2D(3, 64, 11, stride=4, padding=2), nn.ReLU(),
            nn.MaxPool2D(3, stride=2),
            nn.Conv2D(64, 192, 5, padding=2), nn.ReLU(),
            nn.MaxPool2D(3, stride=2),
            nn.Conv2D(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2D(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2D(256, 256, 3, padding=1), nn.ReLU(),
            nn.MaxPool2D(3, stride=2),
        )
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.5), nn.Linear(256 * 6 * 6, 4096), nn.ReLU(),
                nn.Dropout(0.5), nn.Linear(4096, 4096), nn.ReLU(),
                nn.Linear(4096, num_classes),
            )

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = nn.Flatten()(x)
            x = self.classifier(x)
        return x


model_urls = {"alexnet": (
    "https://paddle-imagenet-models-name.bj.bcebos.com/dygraph/"
    "AlexNet_pretrained.pdparams", "7f0f9f737132e02732d75a1459d98a43")}


def alexnet(pretrained=False, **kwargs):
    model = AlexNet(**kwargs)
    if pretrained:
        from ...utils.pretrained import load_pretrained
        load_pretrained(model, "alexnet", model_urls, pretrained)
    return model
