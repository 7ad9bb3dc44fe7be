"""R(2+1)D-18 (torchvision's ``r2plus1d_18``), the video tower
``r2plus1d_18``: stem (1,7,7)/2 conv to 45 channels, BN, ReLU, (3,1,1)
conv to 64, BN, ReLU; four stages of two (2+1)D basic blocks (64, 128,
256, 512; stride 2 from stage 2, in all three dims), torchvision's
midplanes ``in*out*27 / (9*in + 3*out)`` shared by a block's two convs;
global average pool to 512. Its stem is ``stem_spatial``."""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from benchmark.reference.model import BN, Conv, _run, conv_draw_std


def midplanes(cin, cout):
    return (cin * cout * 27) // (cin * 9 + 3 * cout)


class Conv2Plus1D(nn.Module):
    def __init__(self, cin, cout, stride, mid):
        super().__init__()
        self.spatial = Conv(cin, mid, (1, 3, 3), (1, stride, stride),
                            (0, 1, 1))
        self.bn_mid = BN(mid)
        self.temporal = Conv(mid, cout, (3, 1, 1), (stride, 1, 1),
                             (1, 0, 0))

    def unit(self, x):
        return F.relu(self.bn_mid(self.spatial(x)))

    def forward(self, x):
        return self.temporal(_run(self.unit, x))


class Downsample(nn.Module):
    def __init__(self, cin, cout, stride, ndim=3):
        super().__init__()
        self.conv = Conv(cin, cout, (1,) * ndim, (stride,) * ndim,
                         (0,) * ndim)
        self.bn = BN(cout)

    def forward(self, x):
        return self.bn(self.conv(x))


class VideoBlock(nn.Module):
    def __init__(self, cin, cout, stride):
        super().__init__()
        mid = midplanes(cin, cout)
        self.conv1 = Conv2Plus1D(cin, cout, stride, mid)
        self.bn1 = BN(cout)
        self.conv2 = Conv2Plus1D(cout, cout, 1, mid)
        self.bn2 = BN(cout)
        self.downsample = (Downsample(cin, cout, stride)
                           if stride != 1 or cin != cout else None)

    def first(self, x):
        return F.relu(self.bn1(self.conv1(x)))

    def second(self, x):
        return self.bn2(self.conv2(x))

    def forward(self, x):
        out = _run(self.second, _run(self.first, x))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(out + res)


class Video(nn.Module):
    PLAN = ((64, 64, 1), (64, 128, 2), (128, 256, 2), (256, 512, 2))
    feature_dim = 512
    draw_std = staticmethod(conv_draw_std)

    def __init__(self, in_channels=3):
        super().__init__()
        self.stem_spatial = Conv(in_channels, 45, (1, 7, 7), (1, 2, 2),
                                 (0, 3, 3))
        self.stem_bn1 = BN(45)
        self.stem_temporal = Conv(45, 64, (3, 1, 1), (1, 1, 1), (1, 0, 0))
        self.stem_bn2 = BN(64)
        for s, (cin, cout, stride) in enumerate(self.PLAN, 1):
            setattr(self, f"layer{s}_block0", VideoBlock(cin, cout, stride))
            setattr(self, f"layer{s}_block1", VideoBlock(cout, cout, 1))

    def stem(self, x):
        x = F.relu(self.stem_bn1(self.stem_spatial(x)))
        return F.relu(self.stem_bn2(self.stem_temporal(x)))

    def forward(self, video):
        """video [B, T, H, W, 3] -> [B, 512]."""
        x = _run(self.stem, video.permute(0, 4, 1, 2, 3))
        for s in range(1, 5):
            for b in range(2):
                x = _run(getattr(self, f"layer{s}_block{b}"), x)
        return x.mean(dim=(2, 3, 4))


def build(channels):
    return Video(channels)
