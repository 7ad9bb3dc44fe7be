"""R(2+1)D-18 video encoder (``selavi_tpu/models/r2plus1d.py``, '3d' conv
expression), in NCDHW.

The public layout stays the JAX package's: ``forward`` takes normalized
video ``[B, T, H, W, 3]`` and permutes to ``[B, 3, T, H, W]`` inside.
Kept from the reference tower:

* both midplanes modes: ``parity`` (torchvision's parameter-matched
  width) and ``aligned`` (rounded to a multiple of 128, min 128);
* the per-block shared midplanes of ``parity`` mode: torchvision computes
  one width per block from (inplanes, planes), so a transition block's
  conv2 gets the conv1 width;
* the stem at width 45 in both modes;
* downsample strides by s in all three dims;
* fp32 global average pool; ``return_map`` gives the pre-GAP map
  ``[B, t, h, w, 512]``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from selavi_tpu_torch.models.common import FlaxBatchNorm, make_conv

VIDEO_FEATURE_DIM = 512


def _midplanes(in_planes: int, out_planes: int) -> int:
    return (in_planes * out_planes * 3 * 3 * 3) // (
        in_planes * 3 * 3 + 3 * out_planes
    )


def _aligned_midplanes(in_planes: int, out_planes: int) -> int:
    mid = _midplanes(in_planes, out_planes)
    return max(128, int(round(mid / 128)) * 128)


class Conv2Plus1D(nn.Module):
    """Spatial (1,3,3) conv -> BN -> ReLU -> temporal (3,1,1) conv."""

    def __init__(self, in_planes, out_planes, stride, midplanes_mode,
                 midplanes: Optional[int], generator):
        super().__init__()
        mid = midplanes
        if mid is None:
            mid = (_aligned_midplanes(in_planes, out_planes)
                   if midplanes_mode == "aligned"
                   else _midplanes(in_planes, out_planes))
        self.spatial = make_conv(in_planes, mid, (1, 3, 3), (1, stride, stride),
                                 (0, 1, 1), generator)
        self.bn_mid = FlaxBatchNorm(mid)
        self.temporal = make_conv(mid, out_planes, (3, 1, 1), (stride, 1, 1),
                                  (1, 0, 0), generator)

    def forward(self, x):
        return self.temporal(F.relu(self.bn_mid(self.spatial(x))))


class Downsample(nn.Module):
    def __init__(self, in_planes, planes, stride, generator):
        super().__init__()
        self.conv = make_conv(in_planes, planes, (1, 1, 1), (stride,) * 3,
                              (0, 0, 0), generator)
        self.bn = FlaxBatchNorm(planes)

    def forward(self, x):
        return self.bn(self.conv(x))


class BasicBlock2Plus1D(nn.Module):
    def __init__(self, in_planes, planes, stride, midplanes_mode, generator):
        super().__init__()
        block_mid = (_midplanes(in_planes, planes)
                     if midplanes_mode == "parity" else None)
        self.conv1 = Conv2Plus1D(in_planes, planes, stride, midplanes_mode,
                                 block_mid, generator)
        self.bn1 = FlaxBatchNorm(planes)
        self.conv2 = Conv2Plus1D(planes, planes, 1, midplanes_mode, block_mid,
                                 generator)
        self.bn2 = FlaxBatchNorm(planes)
        self.downsample = (
            Downsample(in_planes, planes, stride, generator)
            if stride != 1 or in_planes != planes else None
        )

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class R2Plus1D18(nn.Module):
    PLAN = ((64, 64, 1), (64, 128, 2), (128, 256, 2), (256, 512, 2))

    def __init__(self, midplanes_mode: str = "parity",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if midplanes_mode not in ("parity", "aligned"):
            raise ValueError(f"unknown midplanes_mode {midplanes_mode!r}")
        g = generator if generator is not None else torch.Generator()
        self.stem_spatial = make_conv(3, 45, (1, 7, 7), (1, 2, 2), (0, 3, 3), g)
        self.stem_bn1 = FlaxBatchNorm(45)
        self.stem_temporal = make_conv(45, 64, (3, 1, 1), (1, 1, 1), (1, 0, 0),
                                       g)
        self.stem_bn2 = FlaxBatchNorm(64)
        for stage, (in_planes, planes, stride) in enumerate(self.PLAN, 1):
            setattr(self, f"layer{stage}_block0", BasicBlock2Plus1D(
                in_planes, planes, stride, midplanes_mode, g))
            setattr(self, f"layer{stage}_block1", BasicBlock2Plus1D(
                planes, planes, 1, midplanes_mode, g))

    def forward(self, video, return_map: bool = False):
        """video [B, T, H, W, 3] -> [B, 512] fp32 (or the pre-GAP map)."""
        x = video.permute(0, 4, 1, 2, 3)
        x = F.relu(self.stem_bn1(self.stem_spatial(x)))
        x = F.relu(self.stem_bn2(self.stem_temporal(x)))
        for stage in range(1, 5):
            x = getattr(self, f"layer{stage}_block0")(x)
            x = getattr(self, f"layer{stage}_block1")(x)
        if return_map:
            return x.permute(0, 2, 3, 4, 1).float()
        return x.float().mean(dim=(2, 3, 4))
