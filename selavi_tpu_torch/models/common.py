"""Layer helpers shared by the port's towers.

* ``FlaxBatchNorm``: BatchNorm with the JAX package's (flax) semantics.
  flax ``momentum=0.9`` keeps 0.9 of the running statistic, which is torch
  ``momentum=0.1``; flax updates the running variance with the *biased*
  batch variance where torch's BatchNorm uses the unbiased one. In one
  process the layer keeps cuDNN's fused statistics kernel and folds the
  correction into the running-variance buffer around the call. Under a
  process group it normalizes with the statistics of the global batch
  (``GlobalBatchNorm``), as GSPMD's BatchNorm does over a sharded batch:
  over the default group for the towers, over a grid's data group for
  the heads (``models/heads.py``: the ranks that hold the same heads).
  ``FlaxBatchNorm.forward(x, relu, residual)`` also takes the residual add
  and the ReLU that follow it in the towers. In eval mode with no gradient
  to keep, the three go to ``ops/bn_act.py::bn_act``: one pass of its
  kernel on a CUDA tensor (which raises on one it does not take), the ops
  as they always were on a CPU tensor. In training, or where a gradient
  is needed: ``flax_batch_norm``, the add, ``F.relu``.
* ``ConvBN``: Conv -> FlaxBatchNorm [-> + residual] [-> ReLU] with explicit
  torch-style padding (``selavi_tpu/models/common.py::ConvBN``).
* Initializers drawn from an explicit ``torch.Generator``: kaiming-normal
  fan-out for convs (the JAX package's ``conv_kaiming_init``) and the
  torch-Linear uniform bounds for dense layers.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as tdist
import torch.nn.functional as F
from torch import nn

from selavi_tpu_torch.ops import bn_act

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


class GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over channel dim 1 with the statistics of the
    batch that all ranks of ``group`` (the default group when None) hold
    together.

    Forward: the per-channel ``sum x``, ``sum x^2`` and the count, in fp32
    (fp64 for fp64 input), read from ``x`` as it is (bf16 stays bf16 in
    memory), all-reduced with SUM; flax's variance ``E[x^2] - E[x]^2``
    clipped at 0; then one fused normalization (``F.batch_norm`` with
    those statistics). Returns ``(y, mean, var)``, ``y`` in ``x``'s dtype.

    Backward: torch's fused train-mode BatchNorm backward at the global
    statistics gives the input gradient over this rank's sums and the
    local ``sum dy * xhat`` and ``sum dy``, which are the weight's and
    bias's gradients of this rank's loss. Those two sums, all-reduced,
    give the input gradient of the loss summed over the ranks: the
    difference between the global and the local means of ``dy`` and
    ``dy * xhat``, a per-channel affine map of ``x``, is added to it (zero
    with one rank). DDP's mean over the ranks then gives the gradient of
    the global mean loss."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float, group=None):
        c = x.shape[1]
        dims = [0, *range(2, x.ndim)]
        acc = torch.promote_types(x.dtype, torch.float32)
        stats = torch.cat([
            x.sum(dims, dtype=acc),
            torch.linalg.vector_norm(x, 2, dims, dtype=acc).square(),
            torch.full((1,), x.numel() // c, dtype=acc, device=x.device)])
        tdist.all_reduce(stats, group=group)
        n = stats[-1]
        mean = stats[:c] / n
        var = (stats[c:2 * c] / n - mean * mean).clamp_min(0.0)
        y = F.batch_norm(x, mean, var, weight, bias, training=False,
                         eps=eps)
        ctx.eps, ctx.group = eps, group
        ctx.save_for_backward(x, weight, mean, torch.rsqrt(var + eps), n)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd, n = ctx.saved_tensors
        dx, dweight, dbias = torch.ops.aten.native_batch_norm_backward(
            dy, x, weight, None, None, mean, invstd, True, ctx.eps,
            [True, True, True])
        local = torch.cat([dbias, dweight]).to(mean.dtype)
        sums = local.clone()
        tdist.all_reduce(sums, group=ctx.group)
        if tdist.get_world_size(ctx.group) > 1:
            c = x.shape[1]
            shape = [1, c] + [1] * (x.ndim - 2)
            n_local = x.numel() // c
            # the local means that dx holds minus the global ones
            d_dy = local[:c] / n_local - sums[:c] / n
            d_dyxhat = local[c:] / n_local - sums[c:] / n
            k = invstd * weight.to(mean.dtype)
            slope = k * invstd * d_dyxhat
            dx = dx.addcmul_(x, slope.view(shape)).add_(
                (k * d_dy - slope * mean).view(shape))
        return dx, dweight, dbias, None, None


def flax_batch_norm(x, weight, bias, running_mean, running_var,
                    training: bool, momentum: float = BN_MOMENTUM,
                    eps: float = BN_EPS, group=None):
    """BatchNorm over channel dim 1 with flax's running-stat update.

    Train mode normalizes with the biased batch variance (as both
    frameworks do) and updates ``running = momentum * running + (1 -
    momentum) * batch`` with the biased variance. Under a process group
    the statistics are those of the batch of ``group``'s ranks (the
    default group when None; ``GlobalBatchNorm``). Otherwise
    torch's kernel folds in the unbiased variance ``v * s`` (``s = n / (n
    - 1)``), so it updates a copy of the buffer scaled by ``s``, which is
    divided by ``s`` after: ``((1-m') * rv * s + m' * v * s) / s = (1-m') *
    rv + m' * v``. The kernel gets copies because autograd keeps its
    running-stat inputs for the backward pass.
    """
    if not training:
        return F.batch_norm(x, running_mean, running_var, weight, bias,
                            training=False, eps=eps)
    if tdist.is_initialized():
        out, mean, var = GlobalBatchNorm.apply(x, weight, bias, eps, group)
        with torch.no_grad():
            running_mean.mul_(momentum).add_(
                mean.to(running_mean.dtype), alpha=1.0 - momentum)
            running_var.mul_(momentum).add_(
                var.to(running_var.dtype), alpha=1.0 - momentum)
        return out
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

    def forward(self, x, relu: bool = False, residual=None):
        """BatchNorm of x, then ``+ residual`` where one is given, then ReLU
        where ``relu``. ``bn_act.bn_act`` in eval mode where no gradient is
        needed (the kernel's pass on the card); otherwise
        ``flax_batch_norm``, the add and ``F.relu``, as separate ops."""
        params = (self.weight, self.bias, self.running_mean,
                  self.running_var)
        needs_grad = torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, residual, *params))
        if not self.training and not needs_grad:
            return bn_act.bn_act(x, *params, BN_EPS, relu, residual)
        y = flax_batch_norm(x, *params, self.training)
        if residual is not None:
            y = y + residual
        return F.relu(y) if relu else y


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
    """Conv (no bias) -> FlaxBatchNorm [-> + residual] [-> ReLU]."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Sequence[int],
                 stride: Sequence[int], padding: Sequence[int],
                 use_relu: bool, generator: torch.Generator):
        super().__init__()
        self.conv = make_conv(in_ch, out_ch, kernel, stride, padding,
                              generator)
        self.bn = FlaxBatchNorm(out_ch)
        self.use_relu = use_relu

    def forward(self, x, residual=None):
        return self.bn(self.conv(x), relu=self.use_relu, residual=residual)
