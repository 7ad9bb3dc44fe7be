"""Host-side spatial transforms: resize / crop index math.

The port's copy of ``selavi_tpu/data/transforms.py`` (the reference's
video_transforms.py: scale jitter :35-79, random crop :101-134, uniform
test crops :167-210, center crop, spatial_sampling entry :420-467). These
run on the host because they involve data-dependent shapes; the
elementwise augmentations (flip, color jitter, grayscale, normalize) run
fused on the device (``selavi_tpu_torch.ops.preprocess``).

Frames are numpy uint8 ``[T, H, W, C]`` throughout. The bilinear resize is
the vectorized numpy twin of the JAX package's C++ data-runtime kernel
(``selavi_resize_bilinear_u8``): same taps, clamps and rounding. The port
has no native data runtime (ROADMAP Queue 1 item 4), so this is its one
resize.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def resize_frames(frames: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """Bilinear THWC uint8 resize matching the reference's
    ``F.interpolate(mode='bilinear', align_corners=False)`` (2-tap,
    half-pixel centers, NO antialias — torch's default; PIL.BILINEAR
    would area-average on downscale, a different augmentation
    distribution)."""
    return _resize_frames(frames, new_h, new_w)


def _resize_frames(frames: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """Numpy twin of the JAX package's C++ kernel (data_runtime.cpp
    selavi_resize_bilinear_u8): same taps, clamps, and rounding."""
    t, h, w, c = frames.shape
    fy = (np.arange(new_h) + 0.5) * (h / new_h) - 0.5
    fx = (np.arange(new_w) + 0.5) * (w / new_w) - 0.5
    y0 = np.floor(fy).astype(np.int64)
    x0 = np.floor(fx).astype(np.int64)
    wy = (fy - y0).astype(np.float64)[None, :, None, None]
    wx = (fx - x0).astype(np.float64)[None, None, :, None]
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    y0 = np.clip(y0, 0, h - 1)
    x0 = np.clip(x0, 0, w - 1)
    f = frames.astype(np.float64)
    fy0, fy1 = f[:, y0], f[:, y1]
    top = fy0[:, :, x0] * (1 - wx) + fy0[:, :, x1] * wx
    bot = fy1[:, :, x0] * (1 - wx) + fy1[:, :, x1] * wx
    v = top * (1 - wy) + bot * wy
    return np.clip(v + 0.5, 0, 255).astype(np.uint8)


def random_short_side_scale_jitter(
    frames: np.ndarray,
    min_size: int,
    max_size: int,
    rng: np.random.Generator,
) -> np.ndarray:
    """Resize so the short side equals a uniform draw in [min, max]
    (reference video_transforms.py:35-79)."""
    size = int(round(rng.uniform(min_size, max_size)))
    t, h, w, _ = frames.shape
    if (w <= h and w == size) or (h <= w and h == size):
        return frames
    if w < h:
        new_w, new_h = size, int(np.floor(h / w * size))
    else:
        new_w, new_h = int(np.floor(w / h * size)), size
    return resize_frames(frames, new_h, new_w)


def resize_short_side(frames: np.ndarray, size: int) -> np.ndarray:
    t, h, w, _ = frames.shape
    if w < h:
        new_w, new_h = size, int(np.floor(h / w * size))
    else:
        new_w, new_h = int(np.floor(w / h * size)), size
    if (new_h, new_w) == (h, w):
        return frames
    return resize_frames(frames, new_h, new_w)


def random_crop(
    frames: np.ndarray, size: int, rng: np.random.Generator
) -> np.ndarray:
    t, h, w, _ = frames.shape
    y = 0 if h == size else int(rng.integers(0, h - size + 1))
    x = 0 if w == size else int(rng.integers(0, w - size + 1))
    return frames[:, y : y + size, x : x + size, :]


def uniform_crop(
    frames: np.ndarray, size: int, spatial_idx: int
) -> np.ndarray:
    """Test-time 3-crop: 0/1/2 = left-or-top / center / right-or-bottom
    (reference video_transforms.py:167-210)."""
    assert spatial_idx in (0, 1, 2)
    t, h, w, _ = frames.shape
    y = int(np.ceil((h - size) / 2))
    x = int(np.ceil((w - size) / 2))
    if h > w:
        y = 0 if spatial_idx == 0 else (h - size if spatial_idx == 2 else y)
    else:
        x = 0 if spatial_idx == 0 else (w - size if spatial_idx == 2 else x)
    return frames[:, y : y + size, x : x + size, :]


def center_crop(frames: np.ndarray, size: int) -> np.ndarray:
    return uniform_crop(frames, size, 1)


def spatial_sampling(
    frames: np.ndarray,
    spatial_idx: int = -1,
    min_scale: int = 128,
    max_scale: int = 160,
    crop_size: int = 112,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Train (spatial_idx == -1): scale jitter + random crop.
    Test (0/1/2): fixed short-side resize + uniform crop; 3/4/5 are the
    horizontally-flipped variants of 0/1/2.
    (reference video_transforms.py:420-460; train-mode flips happen fused
    on device, test-mode flips here since they are deterministic.)
    """
    if spatial_idx == -1:
        assert rng is not None
        frames = random_short_side_scale_jitter(
            frames, min_scale, max_scale, rng
        )
        frames = random_crop(frames, crop_size, rng)
    else:
        assert spatial_idx in (0, 1, 2, 3, 4, 5)
        frames = resize_short_side(frames, min_scale)
        frames = uniform_crop(frames, crop_size, spatial_idx % 3)
        if spatial_idx >= 3:
            frames = frames[:, :, ::-1, :]
    return frames


def lighting_jitter(
    frames: np.ndarray,
    alphastd: float,
    eigval,
    eigvec,
    rng: np.random.Generator,
) -> np.ndarray:
    """AlexNet-style PCA lighting jitter.

    Behavior parity with the reference's datasets/video_transforms.py:366-393
    (defined there but unused by the reference's training pipeline — provided
    here for the same availability). One alpha vector ``~N(0, alphastd)`` is
    drawn per call; the per-channel shift is ``sum_j eigvec[c, j] * alpha[j]
    * eigval[j]`` and — matching the reference exactly — channel ``c``
    receives the shift computed for channel ``2 - c`` (its loop adds
    ``rgb[2 - idx]`` to channel ``idx``).

    Frames are ``[T, H, W, C]`` float; returns the same dtype/shape.
    ``alphastd == 0`` is the identity (reference :379-380).
    """
    if alphastd == 0:
        return frames
    alpha = rng.normal(0.0, alphastd, size=(1, 3))
    eig_vec = np.asarray(eigvec, dtype=np.float64)
    eig_val = np.reshape(np.asarray(eigval, dtype=np.float64), (1, 3))
    shift = np.sum(eig_vec * alpha * eig_val, axis=1)
    out = frames.astype(np.float32, copy=True)
    for c in range(frames.shape[-1]):
        out[..., c] += shift[2 - c]
    return out.astype(frames.dtype) if frames.dtype != np.float32 else out


def train_scale_range(crop_size: int) -> Tuple[int, int]:
    """Scale-jitter range by crop size (reference AVideoDataset.py:213-217:
    (128, 160) for crops in {112, 128}, (256, 320) for every other crop
    the reference accepts). Crops below 112 only exist in this repo's
    tests/synthetic configs; they scale the 112 range proportionally —
    documented deviation (the reference would upscale a 32-crop from a
    256-320 short side)."""
    if crop_size in (112, 128):
        return 128, 160
    if crop_size >= 112:
        return 256, 320
    return int(crop_size * 128 / 112), int(crop_size * 160 / 112)
