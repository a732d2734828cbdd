"""ShuffleNetV2 (counterpart of
``paddle_tpu/vision/models/shufflenetv2.py``; reference:
python/paddle/vision/models/shufflenetv2.py) —
built on the channel_shuffle op."""
from __future__ import annotations

from ... import nn
from ...framework.dispatch import call_op

__all__ = ["ShuffleNetV2", "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
           "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
           "shufflenet_v2_x2_0", "shufflenet_v2_swish"]

_STAGE_OUT = {
    0.25: (24, 24, 48, 96, 512),
    0.33: (24, 32, 64, 128, 512),
    0.5: (24, 48, 96, 192, 1024),
    1.0: (24, 116, 232, 464, 1024),
    1.5: (24, 176, 352, 704, 1024),
    2.0: (24, 244, 488, 976, 2048),
}
_REPEATS = (4, 8, 4)


def _conv_bn(in_c, out_c, k, stride=1, groups=1, act="relu"):
    layers = [nn.Conv2D(in_c, out_c, k, stride=stride, padding=k // 2,
                        groups=groups, bias_attr=False),
              nn.BatchNorm2D(out_c)]
    if act == "relu":
        layers.append(nn.ReLU())
    elif act == "swish":
        layers.append(nn.Swish())
    return nn.Sequential(*layers)


class _ShuffleUnit(nn.Layer):
    def __init__(self, in_c, out_c, stride, act="relu"):
        super().__init__()
        self.stride = stride
        branch_c = out_c // 2
        if stride == 1:
            self.branch2 = nn.Sequential(
                _conv_bn(branch_c, branch_c, 1, act=act),
                _conv_bn(branch_c, branch_c, 3, stride=1, groups=branch_c,
                         act="none"),
                _conv_bn(branch_c, branch_c, 1, act=act))
        else:
            self.branch1 = nn.Sequential(
                _conv_bn(in_c, in_c, 3, stride=stride, groups=in_c,
                         act="none"),
                _conv_bn(in_c, branch_c, 1, act=act))
            self.branch2 = nn.Sequential(
                _conv_bn(in_c, branch_c, 1, act=act),
                _conv_bn(branch_c, branch_c, 3, stride=stride,
                         groups=branch_c, act="none"),
                _conv_bn(branch_c, branch_c, 1, act=act))

    def forward(self, x):
        if self.stride == 1:
            half = x.shape[1] // 2
            x1 = call_op("slice", x, axes=(1,), starts=(0,), ends=(half,))
            x2 = call_op("slice", x, axes=(1,), starts=(half,),
                         ends=(x.shape[1],))
            out = call_op("concat", [x1, self.branch2(x2)], axis=1)
        else:
            out = call_op("concat", [self.branch1(x), self.branch2(x)],
                          axis=1)
        return call_op("channel_shuffle", out, groups=2)


class ShuffleNetV2(nn.Layer):
    def __init__(self, scale=1.0, act="relu", num_classes=1000,
                 with_pool=True):
        super().__init__()
        if scale not in _STAGE_OUT:
            raise ValueError(f"scale must be one of {sorted(_STAGE_OUT)}")
        outs = _STAGE_OUT[scale]
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.conv1 = _conv_bn(3, outs[0], 3, stride=2, act=act)
        self.pool1 = nn.MaxPool2D(3, stride=2, padding=1)
        stages = []
        in_c = outs[0]
        for si, rep in enumerate(_REPEATS):
            out_c = outs[si + 1]
            for i in range(rep):
                stages.append(_ShuffleUnit(in_c, out_c, 2 if i == 0 else 1,
                                           act=act))
                in_c = out_c
        self.stages = nn.Sequential(*stages)
        self.conv_last = _conv_bn(in_c, outs[4], 1, act=act)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Linear(outs[4], num_classes)

    def forward(self, x):
        x = self.pool1(self.conv1(x))
        x = self.stages(x)
        x = self.conv_last(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = nn.Flatten()(x)
            x = self.fc(x)
        return x


model_urls = {
    name: (f"https://paddle-hapi.bj.bcebos.com/models/{name}.pdparams", md5)
    for name, md5 in [
        ("shufflenet_v2_x0_25", "1e509b4c140eeb096bb16e214796d03b"),
        ("shufflenet_v2_x0_33", "3d7b3ab0eaa5c0927ff1026d31b729bd"),
        ("shufflenet_v2_x0_5", "5e5cee182a7793c4e4c73949b1a71bd4"),
        ("shufflenet_v2_x1_0", "122d42478b9e81eb49f8a9ede327b1a4"),
        ("shufflenet_v2_x1_5", "faced5827380d73531d0ee027c67826d"),
        ("shufflenet_v2_x2_0", "cd3dddcd8305e7bcd8ad14d1c69a5784"),
        ("shufflenet_v2_swish", "adde0aa3b023e5b0c94a68be1c394b84")]}


def _make(scale, act="relu", name=None):
    def fn(pretrained=False, **kwargs):
        model = ShuffleNetV2(scale=scale, act=act, **kwargs)
        if pretrained:
            from ...utils.pretrained import load_pretrained
            load_pretrained(model, name, model_urls, pretrained)
        return model
    fn.__name__ = name
    return fn


shufflenet_v2_x0_25 = _make(0.25, name="shufflenet_v2_x0_25")
shufflenet_v2_x0_33 = _make(0.33, name="shufflenet_v2_x0_33")
shufflenet_v2_x0_5 = _make(0.5, name="shufflenet_v2_x0_5")
shufflenet_v2_x1_0 = _make(1.0, name="shufflenet_v2_x1_0")
shufflenet_v2_x1_5 = _make(1.5, name="shufflenet_v2_x1_5")
shufflenet_v2_x2_0 = _make(2.0, name="shufflenet_v2_x2_0")
shufflenet_v2_swish = _make(1.0, act="swish", name="shufflenet_v2_swish")
