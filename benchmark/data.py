"""The benchmark's data: a packed shard of synthetic clips, and the view of
it that a cell's dataset length asks for.

``write_shard`` is a frozen copy of the system's synthetic generator
(class-structured clips: a class-coloured square orbiting at a
class-dependent speed on a noise background, a static class marker, and a
class-frequency tone with its octave and noise, at int16 scale) and of its
shard writer (YUV 4:2:0 planes, int16 PCM, an int32 label a record). The
shard is built once a checkout and configuration (``shard_path``), from
the configuration's ``data_seed``, into ``benchmark/.cache``; later runs
reuse it, so that a run writes nothing to disk but its trace.
``ModN`` serves sample ``i`` of a dataset of any length from record
``i mod R`` of the system's shard reader, so an epoch is as long as the
configuration's dataset and no epoch ends inside a window.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import os
import struct
from pathlib import Path

import numpy as np

from benchmark.reference.inputs import MAGIC


def _clip(idx, label, phase, k, t, c, sr, seconds, rng):
    """One sample: uint8 RGB [t, c, c, 3] and float32 PCM [seconds * sr]."""
    hue = (label * 0.61803398875) % 1.0
    color = np.array([0.5 + 0.5 * np.sin(2 * np.pi * hue + s)
                      for s in (0.0, 2.1, 4.2)])
    clip = rng.integers(0, 39, size=(t, c, c, 3), dtype=np.uint8)
    color_u8 = (color * 255).astype(np.uint8)
    radius, sq = c // 4, max(c // 8, 2)
    speed = 1.0 + (label % 12)
    direction = 1.0 if (label // 12) % 2 == 0 else -1.0
    my = int(((label // 4) % 4 + 0.5) * c / 4)
    mx = int((label % 4 + 0.5) * c / 4)
    msq = max(c // 16, 2)
    clip[:, max(my - msq, 0):min(my + msq, c),
         max(mx - msq, 0):min(mx + msq, c), :] = color_u8
    for f in range(t):
        ang = phase + direction * speed * f / t * 2 * np.pi
        cy = int(c / 2 + radius * np.sin(ang))
        cx = int(c / 2 + radius * np.cos(ang))
        clip[f, max(cy - sq, 0):min(cy + sq, c),
             max(cx - sq, 0):min(cx + sq, c), :] = color_u8
    top = 0.35 * sr
    f0 = 110.0 * (top / 110.0) ** (label / max(k - 1, 1))
    h_amp = 0.3 if 2 * f0 < 0.45 * sr else 0.0
    start = int(np.round(rng.uniform(0, 1) * sr))
    n = seconds * sr
    tt = (np.arange(start, start + n) / sr).astype(np.float32)
    w = (0.6 * np.sin(2 * np.pi * f0 * tt + phase, dtype=np.float32)
         + h_amp * np.sin(2 * np.pi * 2 * f0 * tt, dtype=np.float32))
    w += 0.05 * rng.standard_normal(n).astype(np.float32)
    return clip, w * 8000.0


def rgb_to_yuv420(video):
    """[T,H,W,3] uint8 -> (y [T,H,W], uv [T,H/2,W/2,2]) uint8, BT.601 full
    range, 2x2-mean chroma."""
    t, h, w, _ = video.shape
    f = video.astype(np.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    v = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    uv = np.stack([u, v], axis=-1).reshape(t, h // 2, 2, w // 2, 2, 2)
    uv = uv.mean(axis=(2, 4))
    to_u8 = lambda x: np.clip(np.round(x), 0, 255).astype(np.uint8)
    return to_u8(y), to_u8(uv)


def _record(i, labels, phases, k, t, c, sr, seconds, seed):
    rng = np.random.default_rng((seed, i))
    video, pcm = _clip(i, int(labels[i]), phases[i], k, t, c, sr, seconds,
                       rng)
    y, uv = rgb_to_yuv420(video)
    pcm = np.clip(np.round(pcm.astype(np.float64)), -32768, 32767)
    return (y.tobytes() + uv.tobytes() + pcm.astype("<i2").tobytes()
            + struct.pack("<i", int(labels[i])))


def write_shard(path, records, classes, frames, size, samplerate, seconds,
                seed, threads=8):
    """Write ``records`` samples of ``classes`` classes, ``frames`` frames
    of ``size`` px and ``seconds`` s of PCM, drawn from ``seed``."""
    base = np.random.default_rng(seed)
    labels = base.integers(0, classes, size=records)
    phases = base.uniform(0, 2 * np.pi, size=records)
    meta = {"n": records, "video_shape": [frames, size, size, 3],
            "pcm_len": seconds * samplerate, "seed": seed,
            "video_format": "yuv420", "pcm_dtype": "int16"}
    tmp = Path(f"{path}.partial")
    with open(tmp, "wb") as f, cf.ThreadPoolExecutor(threads) as pool:
        f.write(MAGIC)
        blob = json.dumps(meta).encode()
        f.write(struct.pack("<I", len(blob)))
        f.write(blob)
        args = (labels, phases, classes, frames, size, samplerate, seconds,
                seed)
        for rec in pool.map(lambda i: _record(i, *args), range(records)):
            f.write(rec)
    os.replace(tmp, path)
    return meta


def shard_path(config, cache):
    """The configuration's shard in the directory ``cache``, built on
    first use."""
    c = config
    name = (f"shard_k{c['mlp_dim']}_r{c['distinct_samples']}"
            f"_t{c['num_frames']}_s{c['stored_size']}"
            f"_a{c['aud_sample_rate']}_seed{c['data_seed']}.pack")
    path = Path(cache) / name
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        write_shard(path, c["distinct_samples"], c["mlp_dim"],
                    c["num_frames"], c["stored_size"], c["aud_sample_rate"],
                    c["num_sec_aud"], c["data_seed"])
    return path


class ModN:
    """A dataset of ``n`` samples over the records of ``inner`` (the
    system's shard reader): sample ``i`` is record ``i mod len(inner)``,
    read with the loader's per-sample generator, under its own index."""

    def __init__(self, inner, n):
        self.inner, self.n = inner, int(n)
        self.name = getattr(inner, "name", "packed")
        reps = -(-self.n // len(inner))
        self._labels = np.tile(np.asarray(inner.labels), reps)[:self.n]
        self.valid_indices = np.arange(self.n)

    def __len__(self):
        return self.n

    @property
    def labels(self):
        return self._labels

    def get_example(self, idx, rng=None):
        ex = self.inner.get_example(int(idx) % len(self.inner), rng)
        ex["index"] = ex["vid_idx"] = int(idx)
        return ex

    def close(self):
        self.inner.close()
