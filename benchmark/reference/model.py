"""The plain reference of SeLaVi's network in plain PyTorch: a video tower
and an audio tower, each found by its name (``towers/``), and
``headcount`` MLP heads a modality, sized at each tower's feature width.

It follows the published description (Asano et al., NeurIPS 2020;
facebookresearch/selavi ``model.py``) and holds its parameters under the
names and layouts of the system under test, so that one state dict made
by the benchmark loads into both. It imports nothing of the system under
test.

* Heads: per head Dropout(0.3), Dense(D, 512, no bias), BN, ReLU,
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
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from benchmark.reference import towers

BN_EPS = 1e-5
DROPOUT = 0.3
E4M3_MAX = 448.0  # largest finite float8 values
E5M2_MAX = 57344.0


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


def conv_draw_std(name, shape):
    """The seed-draw rule of a convolutional tower: every convolution's
    kernel by ``sqrt(2 / fan_out)`` (kaiming, fan out); every other leaf
    (BatchNorm's) keeps its constant."""
    if len(shape) >= 4:
        return math.sqrt(2.0 / (shape[0] * math.prod(shape[2:])))
    return 0.0


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

    def draw_std(self, name, shape):
        """Dense kernels, and the last layer's bias with its kernel's
        fan-in, by ``1 / sqrt(3 * fan_in)`` (the spread of torch's Linear
        default); BatchNorm's leaves keep their constants."""
        if name in ("hidden_weight", "proj_weight"):
            return 1.0 / math.sqrt(3 * shape[1])
        if name == "proj_bias":
            return 1.0 / math.sqrt(3 * self.proj_weight.shape[1])
        return 0.0

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
    """Both towers, by name, and both head stacks, each at its tower's
    feature width, under the system's names: ``video_network``,
    ``audio_network``, ``heads_v``, ``heads_a``."""

    def __init__(self, video_arch, audio_arch, headcount, k,
                 audio_channels=1):
        super().__init__()
        self.video_network = towers.build(video_arch, 3)
        self.audio_network = towers.build(audio_arch, audio_channels)
        self.heads_v = Heads(headcount, self.video_network.feature_dim, k)
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
