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

The temporal (3,1,1) convs are ``TemporalConv3d``: an ``nn.Conv3d`` (same
weight, same parameter name) whose forward runs the hand kernel of
``ops/temporal_conv.py`` on bf16 CUDA inputs.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from selavi_tpu_torch.models.common import (
    FlaxBatchNorm,
    kaiming_normal_fan_out_,
    make_conv,
)
from selavi_tpu_torch.ops.temporal_conv import TemporalConvFunction

VIDEO_FEATURE_DIM = 512


def _midplanes(in_planes: int, out_planes: int) -> int:
    return (in_planes * out_planes * 3 * 3 * 3) // (
        in_planes * 3 * 3 + 3 * out_planes
    )


def _aligned_midplanes(in_planes: int, out_planes: int) -> int:
    mid = _midplanes(in_planes, out_planes)
    return max(128, int(round(mid / 128)) * 128)


def _autocast_cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """What autocast does to a conv's operand: float16/32 and bfloat16 to
    ``dtype``, float64 left alone."""
    return t.to(dtype) if t.is_floating_point() and t.dtype != torch.float64 \
        else t


class TemporalConv3d(nn.Conv3d):
    """The (3,1,1) conv, stride (s, 1, 1), padding (1, 0, 0), no bias.

    Its forward routes on the input alone, casting as autocast's conv does
    (to the autocast dtype, then autocast off): bf16 on the card runs the
    hand kernel (``ops/temporal_conv.py``) on x in channels_last_3d memory;
    a CPU tensor runs its plain version; another CUDA dtype (a float32 or
    float16 run) keeps ``F.conv3d``, for which the kernel does not exist."""

    def __init__(self, in_planes: int, out_planes: int, stride: int,
                 generator: torch.Generator):
        super().__init__(in_planes, out_planes, (3, 1, 1), (stride, 1, 1),
                         (1, 0, 0), bias=False)
        kaiming_normal_fan_out_(self.weight, generator)

    def forward(self, x):
        device = x.device.type
        if torch.is_autocast_enabled(device):
            dtype = torch.get_autocast_dtype(device)
            with torch.autocast(device, enabled=False):
                return self._conv(_autocast_cast(x, dtype),
                                  _autocast_cast(self.weight, dtype))
        return self._conv(x, self.weight)

    def _conv(self, x, w):
        if x.is_cuda:
            if x.dtype != torch.bfloat16:
                return F.conv3d(x, w, None, self.stride, self.padding)
            x = x.contiguous(memory_format=torch.channels_last_3d)
        return TemporalConvFunction.apply(x, w, self.stride[0])


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
        self.temporal = TemporalConv3d(mid, out_planes, stride, generator)

    def forward(self, x):
        return self.temporal(self.bn_mid(self.spatial(x), relu=True))


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
        residual = x if self.downsample is None else self.downsample(x)
        out = self.bn1(self.conv1(x), relu=True)
        return self.bn2(self.conv2(out), relu=True, residual=residual)


class R2Plus1D18(nn.Module):
    PLAN = ((64, 64, 1), (64, 128, 2), (128, 256, 2), (256, 512, 2))
    arch = "r2plus1d_18"
    feature_dim = VIDEO_FEATURE_DIM

    def __init__(self, midplanes_mode: str = "parity",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if midplanes_mode not in ("parity", "aligned"):
            raise ValueError(f"unknown midplanes_mode {midplanes_mode!r}")
        g = generator if generator is not None else torch.Generator()
        self.stem_spatial = make_conv(3, 45, (1, 7, 7), (1, 2, 2), (0, 3, 3), g)
        self.stem_bn1 = FlaxBatchNorm(45)
        self.stem_temporal = TemporalConv3d(45, 64, 1, g)
        self.stem_bn2 = FlaxBatchNorm(64)
        for stage, (in_planes, planes, stride) in enumerate(self.PLAN, 1):
            setattr(self, f"layer{stage}_block0", BasicBlock2Plus1D(
                in_planes, planes, stride, midplanes_mode, g))
            setattr(self, f"layer{stage}_block1", BasicBlock2Plus1D(
                planes, planes, 1, midplanes_mode, g))

    def forward(self, video, return_map: bool = False, generator=None,
                shard=(0, 1)):
        """video [B, T, H, W, 3] -> [B, 512] fp32 (or the pre-GAP map).
        ``generator`` and ``shard`` are the video towers' common arguments;
        this tower draws nothing."""
        x = video.permute(0, 4, 1, 2, 3)
        x = self.stem_bn1(self.stem_spatial(x), relu=True)
        x = self.stem_bn2(self.stem_temporal(x), relu=True)
        for stage in range(1, 5):
            x = getattr(self, f"layer{stage}_block0")(x)
            x = getattr(self, f"layer{stage}_block1")(x)
        if return_map:
            return x.permute(0, 2, 3, 4, 1).float()
        return x.float().mean(dim=(2, 3, 4))


def temporal_conv_shapes(midplanes_mode: str = "parity", frames: int = 30,
                         size: int = 112) -> list:
    """``(name, C, Co, stride, T, H, W)`` of the tower's 17 temporal convs:
    each one's channels and stride, and the input it is handed for clips of
    ``frames`` x ``size`` x ``size`` (as ``R2Plus1D18`` builds them)."""
    hw = (size + 2 * 3 - 7) // 2 + 1  # the stem's (1, 7, 7) conv, stride 2
    t = frames
    shapes = [("stem_temporal", 45, 64, 1, t, hw, hw)]
    for stage, (in_planes, planes, stride) in enumerate(R2Plus1D18.PLAN, 1):
        for block, (block_in, s) in enumerate(((in_planes, stride),
                                               (planes, 1))):
            shared = (_midplanes(block_in, planes)
                      if midplanes_mode == "parity" else None)
            for conv, (conv_in, cs) in enumerate(((block_in, s),
                                                  (planes, 1)), 1):
                mid = (shared if shared is not None
                       else _aligned_midplanes(conv_in, planes))
                hw = (hw - 1) // cs + 1  # the (1, 3, 3) conv, padding 1
                shapes.append((f"layer{stage}_block{block}.conv{conv}."
                               f"temporal", mid, planes, cs, t, hw, hw))
                t = (t - 1) // cs + 1
    return shapes
