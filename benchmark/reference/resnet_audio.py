"""The 2D ResNets of the audio towers (``towers/resnet9.py``,
``towers/resnet50.py``) over log-mel spectrograms: stem 7x7/2 conv to 64,
BN, ReLU, 3x3/2 max pool; four stages of basic blocks or of bottlenecks
(x4 expansion) at 64, 128, 256, 512 planes, stride 2 from stage 2; global
average pool to 512 x the expansion. Its stem is ``stem.conv``."""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from benchmark.reference.model import BN, Conv, _run, conv_draw_std


class ConvBN(nn.Module):
    def __init__(self, cin, cout, kernel, stride, padding, relu):
        super().__init__()
        self.conv = Conv(cin, cout, kernel, stride, padding)
        self.bn = BN(cout)
        self.relu = relu

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.relu else x


class AudioBasic(nn.Module):
    expansion = 1

    def __init__(self, cin, planes, stride):
        super().__init__()
        self.conv1 = ConvBN(cin, planes, (3, 3), (stride,) * 2, (1, 1), True)
        self.conv2 = ConvBN(planes, planes, (3, 3), (1, 1), (1, 1), False)
        self.downsample = (
            ConvBN(cin, planes, (1, 1), (stride,) * 2, (0, 0), False)
            if stride != 1 or cin != planes else None)

    def forward(self, x):
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(self.conv2(self.conv1(x)) + res)


class AudioBottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, planes, stride):
        super().__init__()
        cout = planes * 4
        self.conv1 = ConvBN(cin, planes, (1, 1), (1, 1), (0, 0), True)
        self.conv2 = ConvBN(planes, planes, (3, 3), (stride,) * 2, (1, 1),
                            True)
        self.conv3 = ConvBN(planes, cout, (1, 1), (1, 1), (0, 0), False)
        self.downsample = (
            ConvBN(cin, cout, (1, 1), (stride,) * 2, (0, 0), False)
            if stride != 1 or cin != cout else None)

    def forward(self, x):
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(self.conv3(self.conv2(self.conv1(x))) + res)


class AudioResNet(nn.Module):
    draw_std = staticmethod(conv_draw_std)

    def __init__(self, block, stages, in_channels):
        super().__init__()
        self.feature_dim = 512 * block.expansion
        self.stem = ConvBN(in_channels, 64, (7, 7), (2, 2), (3, 3), True)
        blocks, cin = [], 64
        for s, (planes, n) in enumerate(zip((64, 128, 256, 512), stages)):
            for b in range(n):
                blocks.append(block(cin, planes, 2 if s > 0 and b == 0 else 1))
                cin = planes * block.expansion
        self.blocks = nn.ModuleList(blocks)

    def _stem(self, x):
        return F.max_pool2d(self.stem(x), kernel_size=3, stride=2, padding=1)

    def forward(self, spec):
        """spec [B, F, T, C] -> [B, feature_dim]."""
        x = _run(self._stem, spec.permute(0, 3, 1, 2))
        for block in self.blocks:
            x = _run(block, x)
        return x.mean(dim=(2, 3))
