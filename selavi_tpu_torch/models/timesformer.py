"""TimeSformer-Base, divided space-time attention (Bertasius, Wang and
Torresani, ICML 2021; facebookresearch/TimeSformer
``timesformer/models/vit.py``: ``VisionTransformer``, ``Block`` with
``attention_type='divided_space_time'``, ``Attention``, ``Mlp``,
``PatchEmbed``), the video tower ``timesformer_base``.

ViT-B/16 over ``T`` frames: a 16x16 stride-16 patch embedding (3 -> 768),
a cls token, learned ``pos_embed [1, 1 + N, 768]`` (N = 196 patches at
224 px) and ``time_embed [1, T, 768]``, 12 blocks of 12 heads of 64 with
an MLP of 3072 (GELU), qkv bias, LayerNorm eps 1e-6, drop-path rising
linearly from 0 to 0.1 over the blocks, a final LayerNorm. The parameters
carry the published names (``cls_token``, ``pos_embed``, ``time_embed``,
``patch_embed.proj``, ``blocks.{i}.{norm1, attn.qkv, attn.proj,
temporal_norm1, temporal_attn.qkv, temporal_attn.proj, temporal_fc,
norm2, mlp.fc1, mlp.fc2}``, ``norm``): a published checkpoint loads once
its ``model.`` prefix and its classifier ``head`` are dropped.

The patch tokens are held as published, ``[B, N * T, D]`` with the frame
index fastest (``b (h w t) m``). A block:

1. temporal attention over each patch's T frames (``[B * N, T, D]``, a
   view): ``temporal_norm1``, ``temporal_attn``, drop-path,
   ``temporal_fc``, residual;
2. spatial attention over each frame's ``1 + N`` tokens
   (``[B * T, 1 + N, D]``, a transposed copy), the cls token repeated into
   every frame: ``norm1``, ``attn``, drop-path; the cls token's T outputs
   are averaged back; residual;
3. the MLP: ``norm2``, fc1, GELU, fc2, drop-path, residual.

Both attentions are ``F.scaled_dot_product_attention``, in bf16 under the
step's autocast (whichever backend it picks). Drop-path keeps or drops a
whole sample's branch: its masks are drawn from the step's generator, a
block's three (temporal, spatial, MLP) at the block's start, none where
the block's rate is 0, each ``rand([world * B]) >= rate`` of the global
batch of which the rank keeps rows ``rank::world`` (as the heads' dropout,
``models/heads.py``), scaled by ``1 / (1 - rate)``. The published code
draws the temporal and spatial masks per reshaped sequence (patch or
frame) rather than per sample.

``forward(video [B, T, H, W, 3]) -> [B, 768]`` fp32: the final LayerNorm's
cls token; ``return_map=True`` gives the final-normed patch tokens
``[B, T, H / 16, W / 16, 768]`` fp32. Spans ``video.temporal_attn``,
``video.spatial_attn`` and ``video.mlp`` cover each branch from its norm to
its residual, layout changes included; the counter ``video.attn_calls``
rises by 2 a block (``utils/profiling.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from selavi_tpu_torch.models.common import uniform_fan_in_
from selavi_tpu_torch.utils.profiling import count, span

FEATURE_DIM = 768
PATCH = 16
LN_EPS = 1e-6
INIT_STD = 0.02  # the published trunc_normal_(std=.02) (cut at +-2, not hit)


class PatchEmbed(nn.Module):
    """Conv 16x16 stride 16, 3 -> ``dim``, on every frame."""

    def __init__(self, dim: int, in_channels: int = 3):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, dim, PATCH, PATCH)

    def forward(self, video):
        """video [B, T, H, W, C] -> tokens [B, T, N, dim], N = (H/16)(W/16)."""
        b, t, h, w, c = video.shape
        x = video.reshape(b * t, h, w, c).permute(0, 3, 1, 2)
        x = self.proj(x.contiguous(memory_format=torch.channels_last))
        return x.flatten(2).transpose(1, 2).reshape(b, t, -1, x.shape[1])


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=True)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        """x [S, L, D] -> [S, L, D]: softmax(q k^T / sqrt(64)) v by head."""
        s, n, d = x.shape
        qkv = self.qkv(x).view(s, n, 3, self.num_heads, d // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        y = F.scaled_dot_product_attention(q, k, v)
        return self.proj(y.transpose(1, 2).reshape(s, n, d))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


def _drop(x, mask):
    """``x [B, ...]`` times the per-sample fp32 ``mask [B]`` (already
    scaled; the product in fp32, so that the scale is not rounded to
    bf16), or ``x`` where there is no mask."""
    if mask is None:
        return x
    return x * mask.view(-1, *([1] * (x.ndim - 1)))


class Block(nn.Module):
    """One divided space-time block (module docstring)."""

    def __init__(self, dim: int, num_heads: int, mlp_hidden: int,
                 drop_path: float):
        super().__init__()
        self.drop_path = drop_path
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads)
        self.temporal_norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.temporal_attn = Attention(dim, num_heads)
        self.temporal_fc = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, mlp_hidden)

    def masks(self, b: int, generator, shard, device):
        """The block's three drop-path masks ``[B]`` (temporal, spatial,
        MLP), each the rank's rows of the global batch's draw, scaled by
        ``1 / (1 - rate)``; None each in eval mode or at rate 0."""
        if not self.training or self.drop_path <= 0.0:
            return (None, None, None)
        if generator is None:
            raise ValueError("train-mode drop-path needs an explicit "
                             "generator")
        rank, world = shard
        keep = 1.0 - self.drop_path
        out = []
        for _ in range(3):
            draw = torch.rand(b * world, generator=generator, device=device)
            out.append((draw[rank::world] >= self.drop_path).float() / keep)
        return tuple(out)

    def forward(self, x, frames: int, masks=(None, None, None)):
        """x [B, 1 + N * T, D] (patch tokens frame-fastest) -> the same."""
        b, tokens, d = x.shape
        t = frames
        n = (tokens - 1) // t
        mask_t, mask_s, mask_m = masks
        cls, patches = x[:, :1], x[:, 1:]
        count("video.attn_calls", 2)
        with span("video.temporal_attn"):
            xt = self.temporal_norm1(patches).reshape(b * n, t, d)
            res = _drop(self.temporal_attn(xt).view(b, n * t, d), mask_t)
            xt = patches + self.temporal_fc(res)
        with span("video.spatial_attn"):
            xs = xt.view(b, n, t, d).transpose(1, 2)  # [B, T, N, D]
            xs = torch.cat([cls.unsqueeze(1).expand(b, t, 1, d), xs], 2)
            res = self.attn(self.norm1(xs.reshape(b * t, 1 + n, d)))
            res = _drop(res.view(b, t, 1 + n, d), mask_s)
            cls_res = res[:, :, :1].mean(1)  # the frames' cls outputs
            res = res[:, :, 1:].transpose(1, 2).reshape(b, n * t, d)
            x = torch.cat([cls + cls_res, xt + res], 1)
        with span("video.mlp"):
            return x + _drop(self.mlp(self.norm2(x)), mask_m)


class TimeSformer(nn.Module):
    """TimeSformer-Base, divided space-time (module docstring)."""

    arch = "timesformer_base"
    feature_dim = FEATURE_DIM

    def __init__(self, generator: Optional[torch.Generator] = None,
                 num_frames: int = 8, img_size: int = 224,
                 dim: int = FEATURE_DIM, depth: int = 12,
                 num_heads: int = 12, mlp_ratio: int = 4,
                 drop_path_rate: float = 0.1, in_channels: int = 3):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.feature_dim = dim
        patches = (img_size // PATCH) ** 2
        self.patch_embed = PatchEmbed(dim, in_channels)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + patches, dim))
        self.time_embed = nn.Parameter(torch.zeros(1, num_frames, dim))
        rates = torch.linspace(0, drop_path_rate, depth,
                               device="cpu").tolist()
        self.blocks = nn.ModuleList(
            Block(dim, num_heads, mlp_ratio * dim, rate) for rate in rates)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self._init(g)

    @torch.no_grad()
    def _init(self, g):
        """The published initialisation, drawn from ``g`` in parameter
        order: the patch conv as torch's Conv2d default, ``cls_token``,
        ``pos_embed`` and every Linear weight N(0, 0.02), Linear biases and
        ``time_embed`` 0, LayerNorm 1 and 0, ``temporal_fc`` 0 in every
        block after the first."""
        fan_in = self.patch_embed.proj.weight[0].numel()
        for name, p in self.named_parameters():
            if name.startswith("patch_embed."):
                uniform_fan_in_(p, fan_in, g)
            elif name in ("cls_token", "pos_embed") or (
                    name.endswith(".weight") and p.ndim == 2):
                p.copy_(torch.randn(p.shape, generator=g) * INIT_STD)
            elif name.endswith(".bias") and not name.startswith("norm"):
                p.zero_()  # Linear biases (LayerNorm's are 0 already)
        for i, blk in enumerate(self.blocks):
            if i > 0:
                blk.temporal_fc.weight.zero_()

    def forward(self, video, return_map: bool = False,
                generator: Optional[torch.Generator] = None,
                shard: tuple[int, int] = (0, 1)):
        """video [B, T, H, W, 3] -> [B, 768] fp32 (or the token map);
        ``generator`` and ``shard`` draw the train-mode drop-path masks."""
        b, t, h, w, _ = video.shape
        x = self.patch_embed(video)  # [B, T, N, D]
        n, d = x.shape[2], x.shape[3]
        x = x + self.pos_embed[:, 1:].unsqueeze(1) + self.time_embed[
            :, :t].unsqueeze(2)
        x = x.transpose(1, 2).reshape(b, n * t, d)  # frame-fastest
        cls = (self.cls_token + self.pos_embed[:, :1]).expand(b, 1, d)
        x = torch.cat([cls.to(x.dtype), x], 1)
        for blk in self.blocks:
            x = blk(x, t, blk.masks(b, generator, shard, video.device))
        x = self.norm(x)
        if return_map:
            hp, wp = h // PATCH, w // PATCH
            return x[:, 1:].reshape(b, hp, wp, t, d).permute(
                0, 3, 1, 2, 4).float()
        return x[:, 0].float()
