"""TimeSformer-Base, divided space-time attention, the video tower
``timesformer_base`` (Bertasius, Wang and Torresani, ICML 2021;
facebookresearch/TimeSformer ``timesformer/models/vit.py``), written out
from the published forward in plain float32.

ViT-B/16 at 8 x 224 x 224: a 16x16 stride-16 patch conv (3 -> 768, with
bias) on every frame, a cls token, ``pos_embed [1, 197, 768]`` and
``time_embed [1, 8, 768]``, 12 blocks of 12 heads of 64, an MLP of 3072
(GELU), qkv bias, LayerNorm eps 1e-6, a final LayerNorm whose cls token
is the feature (768). A block, on tokens ``b (h w t) m`` (the frame
fastest):

1. temporal: ``(b h w) t m``, ``temporal_norm1``, ``temporal_attn``,
   drop-path, back to ``b (h w t) m``, ``temporal_fc``, residual;
2. spatial: ``(b t) (h w) m`` with the cls token repeated into every
   frame, ``norm1``, ``attn``, drop-path; the cls token's frames averaged;
   residual on both;
3. ``x + drop_path(fc2(gelu(fc1(norm2(x)))))``.

An attention is ``softmax(q k^T / 8) v`` by head, written out (no fused
kernel). Drop-path rises linearly from 0 to 0.1 over the blocks
(``torch.linspace``); in train mode a block of rate p > 0 draws three
masks, temporal, spatial and MLP, each ``rand([B]) >= p`` scaled by
``1 / (1 - p)`` and applied to every row of its sample, before the block
runs, from the step's generator: ``model.Network`` hands its towers the
input alone, so the tower reads the generator that ``Network.forward``
was given from the frame of that call (``_step_generator``). The heads'
dropout masks follow from the same generator. The masks are one a sample
and a branch, where the published ``DropPath`` draws one a sequence of
the branch (a patch's frames, a frame's tokens); the port draws the same
as this tower. Drawn at the batch the tower is given, they are the port's
on one process only: under a ``pretrain_dp4`` driver the port draws each
mask for the global batch and keeps its rank's rows, which this tower
could match only if ``Network.forward`` handed it the generator and the
rank's shard.

Seed draws (``draw_std``): LayerNorm scales 1 and shifts 0 are kept;
``cls_token``, ``pos_embed``, ``time_embed``, the patch conv and every
dense layer's weight and bias are drawn at std 0.02 (the published
``trunc_normal_(std=.02)``, whose cut at +-2 is never reached). The
published initialisation zeroes ``temporal_fc`` in every block after the
first and every bias; here they are drawn, so that the temporal branch
and the biases take part in the forward that is checked.

Products: the patch conv, each dense layer (qkv, proj, ``temporal_fc``,
fc1, fc2) and each attention's two products count (``flops``); the patch
conv is the stem.
"""

from __future__ import annotations

import functools
import math
import sys

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.model import Network, _run, autocast, q, qg

DIM, DEPTH, HEADS, MLP_RATIO = 768, 12, 12, 4
PATCH, FRAMES, SIZE = 16, 8, 224
LN_EPS = 1e-6
DROP_PATH = 0.1
STD = 0.02


def _step_generator():
    """The ``generator`` argument of the nearest ``Network.forward`` call
    on the stack (the reference network that runs this tower)."""
    frame = sys._getframe(1)
    while frame is not None:
        if (frame.f_code is Network.forward.__code__
                and isinstance(frame.f_locals.get("generator"),
                               torch.Generator)):
            return frame.f_locals["generator"]
        frame = frame.f_back
    raise RuntimeError("train-mode drop-path draws from the step's "
                       "generator: call the network with one")


class LayerNorm(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return F.layer_norm(x.float(), (x.shape[-1],), self.weight,
                            self.bias, LN_EPS)


class Dense(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        with autocast(x):
            return qg(F.linear(q(x), q(self.weight), self.bias)).float()

    def flops(self, args, out):
        return 2 * out.numel() * self.weight.shape[1]


class PatchConv(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, PATCH, PATCH))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, frames):
        with autocast(frames):
            return qg(F.conv2d(q(frames), q(self.weight), self.bias,
                               stride=PATCH)).float()

    def flops(self, args, out):
        return 2 * out.numel() * self.weight[0].numel()


class PatchEmbed(nn.Module):
    def __init__(self, channels, dim):
        super().__init__()
        self.proj = PatchConv(channels, dim)

    def forward(self, frames):
        """[B*T, C, H, W] -> [B*T, N, D]."""
        return self.proj(frames).flatten(2).transpose(1, 2)


class Attention(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.qkv = Dense(dim, 3 * dim)
        self.proj = Dense(dim, dim)

    def forward(self, x):
        s, n, d = x.shape
        hd = d // self.heads
        qkv = self.qkv(x).reshape(s, n, 3, self.heads, hd).permute(
            2, 0, 3, 1, 4)
        qq, k, v = qkv[0], qkv[1], qkv[2]
        with autocast(x):
            a = qg(q(qq) @ q(k).transpose(-2, -1)).float() / math.sqrt(hd)
            y = qg(q(torch.softmax(a, dim=-1)) @ q(v)).float()
        return self.proj(y.transpose(1, 2).reshape(s, n, d))

    def flops(self, args, out):
        s, n, d = args[0].shape
        return 2 * 2 * s * n * n * d  # the scores and the weighted values


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = Dense(dim, hidden)
        self.fc2 = Dense(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


def _drop(x, mask, rows):
    """``x`` [B * rows, ...] with sample b's rows scaled by ``mask[b]``."""
    if mask is None:
        return x
    m = mask.repeat_interleave(rows)
    return x * m.view(-1, *([1] * (x.ndim - 1)))


class Block(nn.Module):
    def __init__(self, dim, heads, hidden, rate):
        super().__init__()
        self.rate = rate
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, heads)
        self.temporal_norm1 = LayerNorm(dim)
        self.temporal_attn = Attention(dim, heads)
        self.temporal_fc = Dense(dim, dim)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, hidden)

    def masks(self, b, generator):
        if not self.training or self.rate <= 0.0:
            return (None, None, None)
        return tuple((torch.rand(b, generator=generator,
                                 device=generator.device) >= self.rate
                      ).float() / (1.0 - self.rate) for _ in range(3))

    def forward(self, x, frames, masks):
        b, tokens, d = x.shape
        t = frames
        n = (tokens - 1) // t
        mask_t, mask_s, mask_m = masks
        # temporal: b (h w t) m -> (b h w) t m
        xt = x[:, 1:].reshape(b * n, t, d)
        res = _drop(self.temporal_attn(self.temporal_norm1(xt)), mask_t, n)
        res = self.temporal_fc(res.reshape(b, n * t, d))
        xt = x[:, 1:] + res
        # spatial: b (h w t) m -> (b t) (h w) m, the cls token in each frame
        init_cls = x[:, :1]
        cls = init_cls.repeat(1, t, 1).reshape(b * t, 1, d)
        xs = xt.reshape(b, n, t, d).permute(0, 2, 1, 3).reshape(b * t, n, d)
        res = _drop(self.attn(self.norm1(torch.cat([cls, xs], 1))), mask_s,
                    t)
        cls = res[:, 0].reshape(b, t, d).mean(1, keepdim=True)
        res = res[:, 1:].reshape(b, t, n, d).permute(0, 2, 1, 3).reshape(
            b, n * t, d)
        x = torch.cat([init_cls, xt], 1) + torch.cat([cls, res], 1)
        return x + _drop(self.mlp(self.norm2(x)), mask_m, 1)


class Video(nn.Module):
    feature_dim = DIM

    def __init__(self, channels=3, dim=DIM, depth=DEPTH, heads=HEADS,
                 frames=FRAMES, size=SIZE):
        super().__init__()
        self.feature_dim = dim
        self.patch_embed = PatchEmbed(channels, dim)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.empty(
            1, 1 + (size // PATCH) ** 2, dim))
        self.time_embed = nn.Parameter(torch.empty(1, frames, dim))
        rates = torch.linspace(0, DROP_PATH, depth, device="cpu").tolist()
        self.blocks = nn.ModuleList(
            Block(dim, heads, MLP_RATIO * dim, r) for r in rates)
        self.norm = LayerNorm(dim)

    def draw_std(self, name, shape):
        """LayerNorm's leaves keep 1 and 0; every other leaf is drawn at
        0.02 (the module docstring)."""
        if isinstance(self.get_submodule(name.rsplit(".", 1)[0])
                      if "." in name else None, LayerNorm):
            return 0.0
        return STD

    def forward(self, video):
        """video [B, T, H, W, 3] -> [B, 768]: the cls token of
        ``tokens``."""
        return self.tokens(video)[:, 0]

    def tokens(self, video):
        """video [B, T, H, W, 3] -> the final-normed tokens
        ``[B, 1 + N * T, 768]``, ``b (h w t) m`` after the cls token."""
        b, t = video.shape[:2]
        x = self.patch_embed(video.reshape(b * t, *video.shape[2:]).permute(
            0, 3, 1, 2))  # [(b t), n, m]
        n, d = x.shape[1], x.shape[2]
        x = torch.cat([self.cls_token.expand(b * t, 1, d), x], 1)
        x = x + self.pos_embed
        cls = x[:b, :1]  # equal in every row: cls_token + pos_embed[0]
        x = x[:, 1:].reshape(b, t, n, d).permute(0, 2, 1, 3).reshape(
            b * n, t, d) + self.time_embed  # (b n) t m
        x = torch.cat([cls, x.reshape(b, n * t, d)], 1)
        gen = _step_generator() if self.training else None
        for blk in self.blocks:
            masks = blk.masks(b, gen)
            x = _run(functools.partial(blk, frames=t, masks=masks), x)
        return self.norm(x)


def build(channels):
    return Video(channels)
