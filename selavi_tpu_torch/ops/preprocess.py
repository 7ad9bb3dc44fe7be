"""Device-side video preprocessing (``selavi_tpu/ops/preprocess.py``).

Same pipeline order as the JAX package (the reference's
``clip_augmentation``): per-clip horizontal flip, normalize
``(x/255 - 0.45) / 0.225``, then with p=0.8 brightness/contrast/saturation
jitter in a random per-clip order on the normalized frames (no clamp), then
with p=0.2 grayscale. The three jitter ops are linear and ``G`` (gray
projection) and ``M∘G`` (per-frame mean of gray) are idempotent, so every
order collapses to ``t1*x + t2*G(x) + t3*M(G(x))`` with a per-clip
coefficient triple: one pass over the pixels, no per-clip branches.

Random draws come from an explicit ``torch.Generator`` (Philox on the card;
the JAX package draws from threefry, so the streams differ by design).
Tests pass the draws in through ``draws`` instead.
"""

from __future__ import annotations

import itertools
from typing import Optional

import torch

# effective reference gray weights on RGB input (0.299 on channel 2)
GRAY_REF = (0.114, 0.587, 0.299)
# op ids: 0=brightness, 1=contrast, 2=saturation; all 6 application orders
JITTER_PERMS = tuple(itertools.permutations((0, 1, 2)))
JITTER_STRENGTH = 0.4  # factors drawn from U(1 - s, 1 + s)


def normalize_video(frames_u8, dtype=torch.float32):
    """uint8 [B, T, H, W, 3] -> normalized float video."""
    x = frames_u8.float() / 255.0
    return ((x - 0.45) / 0.225).to(dtype)


def yuv420_to_rgb_batch(y_u8, uv_u8):
    """YUV 4:2:0 wire format -> RGB uint8 on the tensors' device.

    ``y`` [B,T,H,W] + ``uv`` [B,T,H/2,W/2,2] uint8 -> [B,T,H,W,3] uint8
    (BT.601 full range, nearest-neighbour chroma upsample, rounded half to
    even and clipped, as the JAX package's). The wire format halves the
    video bytes from host to card (1.5 B/px against 3).
    """
    y = y_u8.float()
    uv = uv_u8.float() - 128.0
    uv = uv.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    u, v = uv[..., 0], uv[..., 1]
    rgb = torch.stack([y + 1.402 * v,
                       y - 0.344136 * u - 0.714136 * v,
                       y + 1.772 * u], dim=-1)
    return torch.round(rgb).clamp_(0.0, 255.0).to(torch.uint8)


def jitter_coefficients(bf, cf, sf, perm_idx):
    """Composed-jitter triple ``[3, b]`` of the map
    ``x -> t1*x + t2*G(x) + t3*M(G(x))`` for order ``JITTER_PERMS[perm_idx]``."""
    triples = []
    for perm in JITTER_PERMS:
        t1, t2, t3 = torch.ones_like(bf), torch.zeros_like(bf), torch.zeros_like(bf)
        for op in perm:
            if op == 0:
                t1, t2, t3 = bf * t1, bf * t2, bf * t3
            elif op == 1:
                t1, t2, t3 = cf * t1, cf * t2, cf * t3 + (1.0 - cf) * (t1 + t2 + t3)
            else:
                t1, t2, t3 = sf * t1, sf * t2 + (1.0 - sf) * (t1 + t2), t3
        triples.append(torch.stack([t1, t2, t3]))
    allc = torch.stack(triples)  # [6, 3, b]
    b = bf.shape[0]
    return allc[perm_idx.long(), :, torch.arange(b, device=bf.device)].T


def _gray(x):
    w = torch.tensor(GRAY_REF, dtype=x.dtype, device=x.device)
    return (x * w).sum(dim=-1)  # [B, T, H, W]


def color_jitter_normalized(x, bf, cf, sf, perm_idx):
    """Reference color jitter on normalized [B,T,H,W,3] frames."""
    t = jitter_coefficients(bf, cf, sf, perm_idx)
    t1, t2, t3 = (t[c][:, None, None, None, None] for c in range(3))
    gray = _gray(x)
    frame_mean = gray.mean(dim=(2, 3), keepdim=True)  # [B, T, 1, 1]
    return t1 * x + t2 * gray[..., None] + t3 * frame_mean[..., None]


def draw_augmentations(b: int, generator: torch.Generator) -> dict:
    """Per-clip draws on the generator's device."""
    dev = generator.device
    s = JITTER_STRENGTH

    def uniform():
        return torch.rand(b, generator=generator, device=dev) * (2 * s) + (1 - s)

    def bernoulli(p):
        return torch.rand(b, generator=generator, device=dev) < p

    return {
        "flip": bernoulli(0.5),
        "bf": uniform(),
        "cf": uniform(),
        "sf": uniform(),
        "perm_idx": torch.randint(0, len(JITTER_PERMS), (b,),
                                  generator=generator, device=dev),
        "jitter": bernoulli(0.8),
        "gray": bernoulli(0.2),
    }


def augment_video_batch(frames_u8, generator: Optional[torch.Generator] = None,
                        colorjitter: bool = False, grayscale: bool = False,
                        flip: bool = True, dtype=torch.float32,
                        draws: Optional[dict] = None, clips: int = 1):
    """Fused flip + normalize + color jitter + grayscale.

    ``frames_u8`` uint8 [B, T, H, W, 3]; returns normalized ``dtype`` video
    of the same layout. With ``clips`` > 1 (dual_data: that many clips
    concatenated along time in each sample) every clip draws its own flip
    and jitter, as the reference's per-clip ``clip_augmentation`` calls
    do. ``draws`` (keys ``flip, bf, cf, sf, perm_idx, jitter, gray``, each
    ``[B * clips]``, sample-major) replaces the generator's draws.
    """
    b_in, t_in = frames_u8.shape[:2]
    if clips > 1:
        frames_u8 = frames_u8.reshape(b_in * clips, t_in // clips,
                                      *frames_u8.shape[2:])
    b = frames_u8.shape[0]
    if draws is None:
        if generator is None:
            raise ValueError("augment_video_batch needs a generator or draws")
        draws = draw_augmentations(b, generator)
    draws = {k: v.to(frames_u8.device) for k, v in draws.items()}
    x = frames_u8.float() / 255.0
    if flip:
        x = torch.where(draws["flip"][:, None, None, None, None],
                        x.flip(3), x)
    x = (x - 0.45) / 0.225
    if colorjitter:
        jit = color_jitter_normalized(x, draws["bf"], draws["cf"],
                                      draws["sf"], draws["perm_idx"])
        x = torch.where(draws["jitter"][:, None, None, None, None], jit, x)
    if grayscale:
        gray = _gray(x)[..., None].expand_as(x)
        x = torch.where(draws["gray"][:, None, None, None, None], gray, x)
    return x.to(dtype).reshape(b_in, t_in, *x.shape[2:])
