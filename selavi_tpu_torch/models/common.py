"""Layer helpers shared by the port's towers.

* ``FlaxBatchNorm``: BatchNorm with the JAX package's (flax) semantics.
  flax ``momentum=0.9`` keeps 0.9 of the running statistic, which is torch
  ``momentum=0.1``; flax updates the running variance with the *biased*
  batch variance where torch's BatchNorm uses the unbiased one. The layer
  keeps cuDNN's fused statistics kernel and folds the correction into the
  running-variance buffer around the call.
* ``ConvBN``: Conv -> FlaxBatchNorm [-> ReLU] with explicit torch-style
  padding (``selavi_tpu/models/common.py::ConvBN``).
* Initializers drawn from an explicit ``torch.Generator``: kaiming-normal
  fan-out for convs (the JAX package's ``conv_kaiming_init``) and the
  torch-Linear uniform bounds for dense layers.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

BN_MOMENTUM = 0.9  # flax convention: fraction of the old running stat kept
BN_EPS = 1e-5


def kaiming_normal_fan_out_(weight: torch.Tensor, generator: torch.Generator):
    """N(0, 2 / fan_out) with fan_out = out_channels * receptive field."""
    fan_out = weight.shape[0] * math.prod(weight.shape[2:])
    with torch.no_grad():
        weight.copy_(torch.randn(weight.shape, generator=generator)
                     * math.sqrt(2.0 / fan_out))
    return weight


def uniform_fan_in_(t: torch.Tensor, fan_in: int, generator: torch.Generator):
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the torch.nn.Linear default."""
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        t.copy_((torch.rand(t.shape, generator=generator) * 2 - 1) * bound)
    return t


def flax_batch_norm(x, weight, bias, running_mean, running_var,
                    training: bool, momentum: float = BN_MOMENTUM,
                    eps: float = BN_EPS):
    """BatchNorm over channel dim 1 with flax's running-stat update.

    Train mode normalizes with the biased batch variance (as both
    frameworks do) and updates ``running = momentum * running + (1 -
    momentum) * batch`` with the biased variance. torch's kernel folds in
    the unbiased variance ``v * s`` (``s = n / (n - 1)``), so it updates a
    copy of the buffer scaled by ``s``, which is divided by ``s`` after:
    ``((1-m') * rv * s + m' * v * s) / s = (1-m') * rv + m' * v``. The
    kernel gets copies because autograd keeps its running-stat inputs for
    the backward pass.
    """
    if not training:
        return F.batch_norm(x, running_mean, running_var, weight, bias,
                            training=False, eps=eps)
    count = x.numel() // x.shape[1]
    s = count / (count - 1) if count > 1 else 1.0
    with torch.no_grad():
        mean_tmp = running_mean.clone()
        var_tmp = running_var * s
    out = F.batch_norm(x, mean_tmp, var_tmp, weight, bias,
                       training=True, momentum=1.0 - momentum, eps=eps)
    with torch.no_grad():
        running_mean.copy_(mean_tmp)
        running_var.copy_(var_tmp / s)
    return out


class FlaxBatchNorm(nn.Module):
    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        return flax_batch_norm(x, self.weight, self.bias, self.running_mean,
                               self.running_var, self.training)


def _conv_cls(ndim: int):
    return {2: nn.Conv2d, 3: nn.Conv3d}[ndim]


def make_conv(in_ch: int, out_ch: int, kernel: Sequence[int],
              stride: Sequence[int], padding: Sequence[int],
              generator: torch.Generator) -> nn.Module:
    conv = _conv_cls(len(kernel))(in_ch, out_ch, tuple(kernel),
                                  tuple(stride), tuple(padding), bias=False)
    kaiming_normal_fan_out_(conv.weight, generator)
    return conv


class ConvBN(nn.Module):
    """Conv (no bias) -> FlaxBatchNorm [-> ReLU]."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Sequence[int],
                 stride: Sequence[int], padding: Sequence[int],
                 use_relu: bool, generator: torch.Generator):
        super().__init__()
        self.conv = make_conv(in_ch, out_ch, kernel, stride, padding,
                              generator)
        self.bn = FlaxBatchNorm(out_ch)
        self.use_relu = use_relu

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.use_relu else x
