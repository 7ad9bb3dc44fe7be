"""Audio encoder: 2D ResNet over log-filterbank spectrograms
(``selavi_tpu/models/resnet_audio.py``), in NCHW.

``forward`` takes the JAX package's layout ``[B, F, T, C]`` and permutes to
``[B, C, F, T]`` inside. C, the stem's input channels, is 1, or 2 for
dual_data (two channel-stacked spectrograms); JAX reads it off the example
at init (``selavi_tpu/data/factory.py::example_shapes``), the port takes it
as ``in_channels``. resnet9/18/34 stack BasicBlocks and give 512-d
features; resnet50 stacks Bottlenecks (expansion 4) and gives 2048-d.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from selavi_tpu_torch.models.common import ConvBN

# name -> (block kind, blocks per stage, feature dim)
AUDIO_ARCHS = {
    "resnet9": ("basic", (1, 1, 1, 1), 512),
    "resnet18": ("basic", (2, 2, 2, 2), 512),
    "resnet34": ("basic", (3, 4, 6, 3), 512),
    "resnet50": ("bottleneck", (3, 4, 6, 3), 2048),
}


class BasicBlock2D(nn.Module):
    def __init__(self, in_planes, planes, stride, generator):
        super().__init__()
        self.conv1 = ConvBN(in_planes, planes, (3, 3), (stride, stride),
                            (1, 1), True, generator)
        # ReLU after the residual add
        self.conv2 = ConvBN(planes, planes, (3, 3), (1, 1), (1, 1), True,
                            generator)
        self.downsample = (
            ConvBN(in_planes, planes, (1, 1), (stride, stride), (0, 0), False,
                   generator)
            if stride != 1 or in_planes != planes else None
        )

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return self.conv2(self.conv1(x), residual=residual)


class Bottleneck2D(nn.Module):
    """1x1 -> 3x3 (with the stride) -> 1x1 to ``planes * 4``, and a 1x1
    projection of the input when the stride or the width changes."""

    expansion = 4

    def __init__(self, in_planes, planes, stride, generator):
        super().__init__()
        out_planes = planes * self.expansion
        self.conv1 = ConvBN(in_planes, planes, (1, 1), (1, 1), (0, 0), True,
                            generator)
        self.conv2 = ConvBN(planes, planes, (3, 3), (stride, stride), (1, 1),
                            True, generator)
        # ReLU after the residual add
        self.conv3 = ConvBN(planes, out_planes, (1, 1), (1, 1), (0, 0), True,
                            generator)
        self.downsample = (
            ConvBN(in_planes, out_planes, (1, 1), (stride, stride), (0, 0),
                   False, generator)
            if stride != 1 or in_planes != out_planes else None
        )

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return self.conv3(self.conv2(self.conv1(x)), residual=residual)


class AudioResNet(nn.Module):
    def __init__(self, arch: str = "resnet9",
                 generator: Optional[torch.Generator] = None,
                 in_channels: int = 1):
        super().__init__()
        self.arch = arch
        kind, stage_blocks, self.feature_dim = AUDIO_ARCHS[arch]
        block, expansion = ((BasicBlock2D, 1) if kind == "basic"
                            else (Bottleneck2D, Bottleneck2D.expansion))
        g = generator if generator is not None else torch.Generator()
        self.stem = ConvBN(in_channels, 64, (7, 7), (2, 2), (3, 3), True, g)
        blocks = []
        in_planes = 64
        for stage, (planes, nblocks) in enumerate(
            zip((64, 128, 256, 512), stage_blocks)
        ):
            for b in range(nblocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                blocks.append(block(in_planes, planes, stride, g))
                in_planes = planes * expansion
        self.blocks = nn.ModuleList(blocks)

    def forward(self, spec):
        """spec [B, F, T, C] -> [B, feature_dim] fp32."""
        x = self.stem(spec.permute(0, 3, 1, 2))
        # MaxPool2d pads with -inf, like the JAX tower's max_pool
        x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
        for block in self.blocks:
            x = block(x)
        return x.float().mean(dim=(2, 3))
