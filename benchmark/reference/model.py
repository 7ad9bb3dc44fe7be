"""The plain reference of SeLaVi's network: R(2+1)D-18 video, a 2D ResNet
over log-mel spectrograms for audio, and ``headcount`` MLP heads a
modality, in plain PyTorch.

It follows the published description (Asano et al., NeurIPS 2020;
facebookresearch/selavi ``model.py``, torchvision's ``r2plus1d_18``) and
holds its parameters under the names and layouts of the system under
test, so that one state dict made by the benchmark loads into both. It
imports nothing of the system under test.

* Video: stem (1,7,7)/2 conv to 45 channels, BN, ReLU, (3,1,1) conv to 64,
  BN, ReLU; four stages of two (2+1)D basic blocks (64, 128, 256, 512;
  stride 2 from stage 2, in all three dims), torchvision's midplanes
  ``in*out*27 / (9*in + 3*out)`` shared by a block's two convs; global
  average pool to 512.
* Audio: stem 7x7/2 conv to 64, BN, ReLU, 3x3/2 max pool; resnet9 (one
  basic block a stage) or resnet50 (3, 4, 6, 3 bottlenecks, x4 expansion);
  global average pool to 512 or 2048.
* Heads: per head Dropout(0.3), Dense(512, no bias), BN, ReLU,
  Dropout(0.3), Dense(K).
* BatchNorm: train mode normalises with the batch's biased variance,
  eps 1e-5; eval mode with the running statistics.

Everything runs in float32. ``Precision.fp8`` turns on the precision
control, the usual float8 training recipe: each convolution's and dense
layer's two operands are rounded to e4m3 in the forward pass and the
gradient of its output to e5m2 in the backward pass (one scale a tensor),
so that every product of the step takes fp8 operands.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

BN_EPS = 1e-5
DROPOUT = 0.3
E4M3_MAX = 448.0  # largest finite float8 values
E5M2_MAX = 57344.0

# name -> (block kind, blocks a stage, feature width)
AUDIO_ARCHS = {
    "resnet9": ("basic", (1, 1, 1, 1), 512),
    "resnet50": ("bottleneck", (3, 4, 6, 3), 2048),
}


class Precision:
    """``fp8``: round the operands of every convolution and dense layer to
    float8 e4m3 (the control); ``bf16``: run them under bf16 autocast (a
    second implementation at the system's precision, for the look at what
    that precision alone moves); ``checkpoint``: recompute blocks in the
    backward pass instead of keeping their activations (``_run``)."""

    fp8 = False
    bf16 = False
    checkpoint = False


def _round(x, dtype, largest):
    scale = x.abs().amax().clamp_min(1e-30) / largest
    return (x / scale).to(dtype).to(x.dtype) * scale


class _RoundFP8(torch.autograd.Function):
    """Forward: round to e4m3; backward: pass the gradient through."""

    @staticmethod
    def forward(ctx, x):
        return _round(x.detach(), torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, grad):
        return grad


class _RoundGradFP8(torch.autograd.Function):
    """Forward: identity; backward: round the gradient to e5m2, so that
    the layer's input and weight gradients are products of fp8 operands."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, torch.float8_e5m2, E5M2_MAX)


def q(x):
    """A layer's operand: rounded to e4m3 under ``Precision.fp8``."""
    return _RoundFP8.apply(x) if Precision.fp8 else x


def qg(y):
    """A layer's output, whose gradient is rounded to e5m2 under
    ``Precision.fp8``."""
    return _RoundGradFP8.apply(y) if Precision.fp8 else y


def autocast(x):
    if not Precision.bf16:
        return contextlib.nullcontext()
    return torch.autocast(x.device.type, torch.bfloat16)


def batch_norm(x, weight, bias, running_mean, running_var, train):
    if train:
        return F.batch_norm(x, None, None, weight, bias, training=True,
                            eps=BN_EPS)
    return F.batch_norm(x, running_mean, running_var, weight, bias,
                        training=False, eps=BN_EPS)


class BN(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        return batch_norm(x, self.weight, self.bias, self.running_mean,
                          self.running_var, self.training)


class Conv(nn.Module):
    """A bias-free convolution, 2D or 3D by the kernel's length."""

    def __init__(self, cin, cout, kernel, stride, padding):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, *kernel))
        self.stride, self.padding = tuple(stride), tuple(padding)

    def forward(self, x):
        conv = F.conv3d if self.weight.ndim == 5 else F.conv2d
        with autocast(x):
            return qg(conv(q(x), q(self.weight), None, self.stride,
                           self.padding))


def _run(block, x):
    """``block(x)``; under ``Precision.checkpoint`` its activations are
    recomputed in the backward pass. The video tower nests this (a block,
    its two halves, each (1,3,3) conv with its BN and ReLU), so that the
    backward pass of a block at 30x56x56 holds one half's tensors."""
    if Precision.checkpoint and torch.is_grad_enabled():
        return checkpoint(block, x, use_reentrant=False)
    return block(x)


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

    def __init__(self):
        super().__init__()
        self.stem_spatial = Conv(3, 45, (1, 7, 7), (1, 2, 2), (0, 3, 3))
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


class Audio(nn.Module):
    def __init__(self, arch="resnet9", in_channels=1):
        super().__init__()
        kind, stages, self.feature_dim = AUDIO_ARCHS[arch]
        block = AudioBasic if kind == "basic" else AudioBottleneck
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


class Heads(nn.Module):
    """``headcount`` MLP heads as ``[H, ...]`` parameters."""

    def __init__(self, headcount, in_dim, k, hidden=512):
        super().__init__()
        self.hidden_weight = nn.Parameter(torch.empty(headcount, in_dim,
                                                      hidden))
        self.bn_weight = nn.Parameter(torch.ones(headcount, hidden))
        self.bn_bias = nn.Parameter(torch.zeros(headcount, hidden))
        self.register_buffer("bn_running_mean", torch.zeros(headcount, hidden))
        self.register_buffer("bn_running_var", torch.ones(headcount, hidden))
        self.proj_weight = nn.Parameter(torch.empty(headcount, hidden, k))
        self.proj_bias = nn.Parameter(torch.zeros(headcount, k))

    def forward(self, feats, generator=None):
        """feats [B, D] -> logits [H, B, K]. In train mode the dropout
        masks are drawn from ``generator``, input mask first: each
        ``rand([H, B, width]) >= 0.3`` keeps an element, scaled by 1/0.7."""
        h, b = self.proj_weight.shape[0], feats.shape[0]
        x = feats.expand(h, *feats.shape)
        if self.training:
            x = _dropout(x, generator)
        with autocast(x):
            x = qg(torch.bmm(q(x), q(self.hidden_weight)).float())
        x = x.transpose(0, 1).reshape(b, -1)
        x = batch_norm(x, self.bn_weight.reshape(-1), self.bn_bias.reshape(-1),
                       self.bn_running_mean.reshape(-1),
                       self.bn_running_var.reshape(-1), self.training)
        x = F.relu(x).reshape(b, h, -1).transpose(0, 1)
        if self.training:
            x = _dropout(x, generator)
        with autocast(x):
            return qg(torch.baddbmm(self.proj_bias[:, None, :], q(x),
                                    q(self.proj_weight)).float())


def _dropout(x, generator):
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= DROPOUT
    return torch.where(keep, x / (1.0 - DROPOUT), torch.zeros_like(x))


class Network(nn.Module):
    """Both towers and both head stacks, under the system's names:
    ``video_network``, ``audio_network``, ``heads_v``, ``heads_a``."""

    def __init__(self, audio_arch="resnet9", headcount=10, k=309,
                 audio_channels=1):
        super().__init__()
        self.video_network = Video()
        self.audio_network = Audio(audio_arch, audio_channels)
        self.heads_v = Heads(headcount, 512, k)
        self.heads_a = Heads(headcount, self.audio_network.feature_dim, k)

    def features(self, video, spec):
        return self.video_network(video), self.audio_network(spec)

    def forward(self, video, spec, generator=None):
        feat_v, feat_a = self.features(video, spec)
        return (self.heads_v(feat_v, generator),
                self.heads_a(feat_a, generator))


def multihead_ce(logits, labels):
    """Mean over heads and rows of the cross-entropy; logits [H, B, K],
    labels [B, H]."""
    h, b, k = logits.shape
    return F.cross_entropy(logits.reshape(h * b, k),
                           labels.t().reshape(h * b).long())
