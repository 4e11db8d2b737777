"""``paddle.vision.models`` of the port (counterpart of
``paddle_tpu/vision/models.py``): LeNet, the ResNet family, VGG,
AlexNet and MobileNetV2, on the port's conv, pooling, batch-norm and
linear layers, with the reference's layer names (a ``state_dict``
moves between the packages, batch-norm statistics included).

Every model takes the port's ``device`` keyword (default: cuda;
``device="cpu"`` asks for the CPU); its layers draw their weights from
the port's generators. ``pretrained=True`` loads nothing, as in the
reference: no weights are downloaded.
"""
from __future__ import annotations

import functools

import torch

from ..nn import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout, Layer,
                  Linear, MaxPool2D, ReLU, ReLU6, Sequential)

__all__ = ["LeNet", "ResNet", "BasicBlock", "BottleneckBlock", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152", "VGG",
           "vgg11", "vgg13", "vgg16", "vgg19", "AlexNet", "alexnet",
           "MobileNetV2", "mobilenet_v2"]


class LeNet(Layer):
    """LeNet-5: two conv + ReLU + 2x2 max-pool stages and three linear
    layers (no activation between them, as Paddle's), for 1 x 28 x 28
    inputs."""

    def __init__(self, num_classes=10, *, device=None):
        super().__init__()
        self.num_classes = num_classes
        self.features = Sequential(
            Conv2D(1, 6, 3, stride=1, padding=1, device=device),
            ReLU(),
            MaxPool2D(2, 2),
            Conv2D(6, 16, 5, stride=1, padding=0, device=device),
            ReLU(),
            MaxPool2D(2, 2),
        )
        if num_classes > 0:
            self.fc = Sequential(
                Linear(400, 120, device=device),
                Linear(120, 84, device=device),
                Linear(84, num_classes, device=device),
            )

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


class BasicBlock(Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None, *,
                 device=None):
        super().__init__()
        norm_layer = norm_layer or functools.partial(BatchNorm2D,
                                                     device=device)
        self.conv1 = Conv2D(inplanes, planes, 3, padding=1, stride=stride,
                            bias_attr=False, device=device)
        self.bn1 = norm_layer(planes)
        self.relu = ReLU()
        self.conv2 = Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                            device=device)
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


class BottleneckBlock(Layer):
    """1x1 -> 3x3 (stride, groups, dilation) -> 1x1 (x4 channels), each
    followed by batch norm, plus the identity (or ``downsample``)."""
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None, *,
                 device=None):
        super().__init__()
        norm_layer = norm_layer or functools.partial(BatchNorm2D,
                                                     device=device)
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv2D(inplanes, width, 1, bias_attr=False,
                            device=device)
        self.bn1 = norm_layer(width)
        self.conv2 = Conv2D(width, width, 3, padding=dilation,
                            stride=stride, groups=groups, dilation=dilation,
                            bias_attr=False, device=device)
        self.bn2 = norm_layer(width)
        self.conv3 = Conv2D(width, planes * self.expansion, 1,
                            bias_attr=False, device=device)
        self.bn3 = norm_layer(planes * self.expansion)
        self.relu = ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(Layer):
    """ResNet for 3 x 224 x 224 inputs (``depth`` 18, 34, 50, 101 or
    152): a 7x7 stride-2 stem, a 3x3 stride-2 max-pool, four stages,
    global average pooling and a linear head."""

    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, *, device=None):
        super().__init__()
        layers = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                  101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}[depth]
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.inplanes = 64
        self.dilation = 1
        self._device = device
        self.conv1 = Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                            bias_attr=False, device=device)
        self.bn1 = BatchNorm2D(self.inplanes, device=device)
        self.relu = ReLU()
        self.maxpool = MaxPool2D(3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = Linear(512 * block.expansion, num_classes,
                             device=device)

    def _make_layer(self, block, planes, blocks, stride=1):
        dev = self._device
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1,
                       stride=stride, bias_attr=False, device=dev),
                BatchNorm2D(planes * block.expansion, device=dev),
            )
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, device=dev)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width, device=dev))
        return Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


def _resnet(block, depth, pretrained=False, **kwargs):
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, **kwargs)


_VGG_CFG = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512,
          512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
          512, 512, "M", 512, 512, 512, 512, "M"],
}


class VGG(Layer):
    def __init__(self, features, num_classes=1000, with_pool=True, *,
                 device=None):
        super().__init__()
        self.features = features
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = Sequential(
                Linear(512 * 7 * 7, 4096, device=device), ReLU(), Dropout(),
                Linear(4096, 4096, device=device), ReLU(), Dropout(),
                Linear(4096, num_classes, device=device),
            )

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(torch.flatten(x, 1))
        return x


def _make_vgg_layers(cfg, batch_norm=False, device=None):
    layers, in_c = [], 3
    for v in cfg:
        if v == "M":
            layers.append(MaxPool2D(2, 2))
        else:
            layers.append(Conv2D(in_c, v, 3, padding=1, device=device))
            if batch_norm:
                layers.append(BatchNorm2D(v, device=device))
            layers.append(ReLU())
            in_c = v
    return Sequential(*layers)


def _vgg(cfg, batch_norm, kwargs):
    return VGG(_make_vgg_layers(_VGG_CFG[cfg], batch_norm,
                                kwargs.get("device")), **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("A", batch_norm, kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("B", batch_norm, kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("D", batch_norm, kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("E", batch_norm, kwargs)


class AlexNet(Layer):
    def __init__(self, num_classes=1000, *, device=None):
        super().__init__()
        self.features = Sequential(
            Conv2D(3, 64, 11, stride=4, padding=2, device=device), ReLU(),
            MaxPool2D(3, 2),
            Conv2D(64, 192, 5, padding=2, device=device), ReLU(),
            MaxPool2D(3, 2),
            Conv2D(192, 384, 3, padding=1, device=device), ReLU(),
            Conv2D(384, 256, 3, padding=1, device=device), ReLU(),
            Conv2D(256, 256, 3, padding=1, device=device), ReLU(),
            MaxPool2D(3, 2),
        )
        self.avgpool = AdaptiveAvgPool2D((6, 6))
        self.classifier = Sequential(
            Dropout(), Linear(256 * 6 * 6, 4096, device=device), ReLU(),
            Dropout(), Linear(4096, 4096, device=device), ReLU(),
            Linear(4096, num_classes, device=device),
        )

    def forward(self, x):
        x = self.avgpool(self.features(x))
        return self.classifier(torch.flatten(x, 1))


def alexnet(pretrained=False, **kwargs):
    return AlexNet(**kwargs)


class _InvertedResidual(Layer):
    def __init__(self, inp, oup, stride, expand_ratio, device=None):
        super().__init__()
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        mk = dict(bias_attr=False, device=device)
        layers = []
        if expand_ratio != 1:
            layers += [Conv2D(inp, hidden, 1, **mk),
                       BatchNorm2D(hidden, device=device), ReLU6()]
        layers += [
            Conv2D(hidden, hidden, 3, stride=stride, padding=1,
                   groups=hidden, **mk),
            BatchNorm2D(hidden, device=device), ReLU6(),
            Conv2D(hidden, oup, 1, **mk), BatchNorm2D(oup, device=device),
        ]
        self.conv = Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device=None):
        super().__init__()
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        in_c = int(32 * scale)
        features = [Conv2D(3, in_c, 3, stride=2, padding=1, bias_attr=False,
                           device=device),
                    BatchNorm2D(in_c, device=device), ReLU6()]
        for t, c, n, s in cfg:
            out_c = int(c * scale)
            for i in range(n):
                features.append(_InvertedResidual(
                    in_c, out_c, s if i == 0 else 1, t, device))
                in_c = out_c
        last = int(1280 * max(1.0, scale))
        features += [Conv2D(in_c, last, 1, bias_attr=False, device=device),
                     BatchNorm2D(last, device=device), ReLU6()]
        self.features = Sequential(*features)
        self.with_pool = with_pool
        self.num_classes = num_classes
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = Sequential(
                Dropout(0.2), Linear(last, num_classes, device=device))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(torch.flatten(x, 1))
        return x


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV2(scale=scale, **kwargs)
