"""Projection heads as one stacked parameter set (``selavi_tpu/models/heads.py``).

``HeadStack`` holds ``headcount`` independent heads as ``[H, ...]``
parameters and applies them with batched matmuls: features ``[B, D]`` ->
logits ``[H, B, K]``. Per head (``use_mlp=True``):

    Dropout(0.3) -> Dense(512, no bias) -> BN -> ReLU -> Dropout(0.3) -> Dense(K)

and ``use_mlp=False`` is the plain ``Dense(K)``. Dense kernels keep the
JAX package's ``[H, in, out]`` layout. Dropout masks are drawn per head
from the explicit generator passed to ``forward``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from selavi_tpu_torch.models.common import flax_batch_norm, uniform_fan_in_

DROPOUT_RATE = 0.3


def dropout(x, rate: float, generator: Optional[torch.Generator]):
    """Inverted dropout with an explicit generator (keep prob 1 - rate)."""
    if rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("train-mode dropout needs an explicit generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class HeadStack(nn.Module):
    def __init__(self, headcount: int, in_dim: int, num_classes: int,
                 n_hidden: int = 512, use_mlp: bool = True,
                 dropout_rate: float = DROPOUT_RATE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.headcount = headcount
        self.use_mlp = use_mlp
        self.dropout_rate = dropout_rate
        proj_in = n_hidden if use_mlp else in_dim
        if use_mlp:
            self.hidden_weight = nn.Parameter(uniform_fan_in_(
                torch.empty(headcount, in_dim, n_hidden), in_dim, g))
            self.bn_weight = nn.Parameter(torch.ones(headcount, n_hidden))
            self.bn_bias = nn.Parameter(torch.zeros(headcount, n_hidden))
            self.register_buffer("bn_running_mean",
                                 torch.zeros(headcount, n_hidden))
            self.register_buffer("bn_running_var",
                                 torch.ones(headcount, n_hidden))
        self.proj_weight = nn.Parameter(uniform_fan_in_(
            torch.empty(headcount, proj_in, num_classes), proj_in, g))
        self.proj_bias = nn.Parameter(uniform_fan_in_(
            torch.empty(headcount, num_classes), proj_in, g))

    def forward(self, feats, generator: Optional[torch.Generator] = None):
        """feats [B, D] -> logits [H, B, K]."""
        h = self.headcount
        feats = feats.to(self.proj_weight.dtype)
        if not self.use_mlp:
            return torch.baddbmm(self.proj_bias[:, None, :],
                                 feats.expand(h, *feats.shape),
                                 self.proj_weight)
        train = self.training
        x = feats.expand(h, *feats.shape)
        if train:
            x = dropout(x, self.dropout_rate, generator)
        x = torch.bmm(x, self.hidden_weight)  # [H, B, hidden]
        # BN per (head, channel) over the batch: [H, B, C] -> [B, H*C]
        b = x.shape[1]
        x = x.transpose(0, 1).reshape(b, -1)
        x = flax_batch_norm(x, self.bn_weight.reshape(-1),
                            self.bn_bias.reshape(-1),
                            self.bn_running_mean.view(-1),
                            self.bn_running_var.view(-1), train)
        x = torch.relu(x).reshape(b, h, -1).transpose(0, 1)
        if train:
            x = dropout(x, self.dropout_rate, generator)
        return torch.baddbmm(self.proj_bias[:, None, :], x, self.proj_weight)

    @torch.no_grad()
    def permute_output(self, head: int, perm) -> None:
        """Reorder head ``head``'s output clusters: new column k is old
        column ``perm[k]`` of the final Dense kernel and bias."""
        perm = torch.as_tensor(perm, dtype=torch.long,
                               device=self.proj_weight.device)
        self.proj_weight[head] = self.proj_weight[head][:, perm]
        self.proj_bias[head] = self.proj_bias[head][perm]
