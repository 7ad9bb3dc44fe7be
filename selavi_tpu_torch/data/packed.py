"""Packed pre-decoded shard cache: decode once, train many epochs.

The port's copy of ``selavi_tpu/data/packed.py``; a shard written by
either package reads in both, byte for byte. The reference decodes the
full audio file and a video clip from mp4 on EVERY access (its known
bottleneck). This cache stores decoded samples once in a flat binary
shard, then serves them zero-copy via mmap:

    header: magic, version, counts and shapes (json, length-prefixed)
    per sample: video uint8 [T, S, S, 3] (pre-crop buffer at the
                scale-jitter maximum) or YUV 4:2:0 planes (y [T, S, S],
                uv [T, S/2, S/2, 2]), pcm float32 or int16
                [num_sec * sr + slack], label int32

``PackedAVDataset.get_example`` applies the train-time spatial augmentation
(random crop from the pre-crop buffer; flips/color jitter stay fused on
the card) and slices a jittered audio window from the stored waveform, so
per-epoch augmentation freshness is preserved for everything except the
temporal clip position (fixed at pack time; re-pack with a different seed
or store multiple clips per video to refresh).

mmap + numpy frombuffer = zero copies until the crop; a shard is a single
file. YUV planes and int16 PCM stay in their wire format through the
loader; the card turns them into RGB and float32
(``data/loader.py::decode_wire_batch``).
"""

from __future__ import annotations

import json
import mmap
import struct
from typing import Optional

import numpy as np

from selavi_tpu_torch.data.transforms import center_crop, random_crop

MAGIC = b"SLVPACK1"


def rgb_to_yuv420(video_u8: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """[T,H,W,3] uint8 RGB -> (y [T,H,W], uv [T,H/2,W/2,2]) uint8, BT.601
    full-range with 2x2-mean chroma subsampling (H, W must be even)."""
    t, h, w, _ = video_u8.shape
    assert h % 2 == 0 and w % 2 == 0, (h, w)
    f = video_u8.astype(np.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    v = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    uv = np.stack([u, v], axis=-1)
    uv = uv.reshape(t, h // 2, 2, w // 2, 2, 2).mean(axis=(2, 4))
    to_u8 = lambda x: np.clip(np.round(x), 0, 255).astype(np.uint8)
    return to_u8(y), to_u8(uv)


def _video_bytes_for(video_shape, video_format: str) -> int:
    full = int(np.prod(video_shape))
    if video_format == "yuv420":
        return full // 2  # y (1/3 of rgb bytes x3=1) + uv (1/2 of a plane)
    return full


def write_packed_shard(
    dataset,
    path: str,
    num_samples: Optional[int] = None,
    seed: int = 0,
    pcm_slack_sec: float = 0.5,
    video_format: str = "rgb",  # 'rgb' | 'yuv420' (half the bytes)
    pcm_dtype: str = "float32",  # 'float32' | 'int16' (quarter the bytes)
) -> dict:
    """Iterate ``dataset`` once (PCM mode preferred) and write the shard.

    The dataset must yield fixed-shape examples; video is stored exactly as
    produced (use a pre-crop dataset configuration — e.g. center_crop=False
    with the crop applied later — to keep crop freshness).

    Wire-efficiency options (both also shrink host RAM cache footprint and
    host->device transfer, the dominant cost on bandwidth-limited links):
    ``video_format='yuv420'`` stores planar YUV 4:2:0 (1.5 B/px; converted
    back to RGB on the card by ``ops.preprocess.yuv420_to_rgb_batch``);
    ``pcm_dtype='int16'`` stores waveforms at their native decode width
    (the reference decodes s16 PCM anyway, audio_utils.py:89-98).
    """
    assert video_format in ("rgb", "yuv420"), video_format
    assert pcm_dtype in ("float32", "int16"), pcm_dtype
    n = num_samples or len(dataset)
    ex0 = dataset.get_example(0, np.random.default_rng((seed, 0)))
    video_shape = ex0["video"].shape
    if "audio_pcm" in ex0:
        pcm_len = len(ex0["audio_pcm"])
    else:
        pcm_len = 0

    meta = {
        "n": n,
        "video_shape": list(video_shape),
        "pcm_len": pcm_len,
        "seed": seed,
        "video_format": video_format,
        "pcm_dtype": pcm_dtype,
    }
    pcm_itemsize = 2 if pcm_dtype == "int16" else 4
    rec_bytes = (
        _video_bytes_for(video_shape, video_format)
        + pcm_len * pcm_itemsize
        + 4  # int32 label
    )

    with open(path, "wb") as f:
        f.write(MAGIC)
        blob = json.dumps(meta).encode()
        f.write(struct.pack("<I", len(blob)))
        f.write(blob)
        for i in range(n):
            ex = dataset.get_example(i, np.random.default_rng((seed, i)))
            assert ex["video"].shape == video_shape, (
                i, ex["video"].shape, video_shape
            )
            video = np.ascontiguousarray(ex["video"], np.uint8)
            if video_format == "yuv420":
                y, uv = rgb_to_yuv420(video)
                f.write(y.tobytes())
                f.write(np.ascontiguousarray(uv).tobytes())
            else:
                f.write(video.tobytes())
            if pcm_len:
                pcm = np.asarray(ex["audio_pcm"])
                assert len(pcm) == pcm_len, (i, len(pcm), pcm_len)
                if pcm_dtype == "int16":
                    pcm = np.clip(
                        np.round(pcm.astype(np.float64)), -32768, 32767
                    ).astype(np.int16)
                else:
                    pcm = pcm.astype(np.float32)
                f.write(np.ascontiguousarray(pcm).tobytes())
            f.write(struct.pack("<i", int(ex["label"])))
    meta["rec_bytes"] = rec_bytes
    return meta


class PackedAVDataset:
    """Zero-copy reader over a packed shard.

    ``crop_size``: when smaller than the stored spatial size, a random crop
    is taken per access (train) or a center crop (mode='test').
    ``num_sec``/``sample_rate``: audio window sliced from the stored PCM
    with a random start when slack exists.
    """

    def __init__(
        self,
        path: str,
        crop_size: Optional[int] = None,
        mode: str = "train",
        num_sec: Optional[int] = None,
        sample_rate: Optional[int] = None,
    ):
        self.path = path
        self._file = open(path, "rb")
        magic = self._file.read(len(MAGIC))
        assert magic == MAGIC, f"not a packed shard: {path}"
        (hlen,) = struct.unpack("<I", self._file.read(4))
        self.meta = json.loads(self._file.read(hlen))
        self._data_off = len(MAGIC) + 4 + hlen
        self._mm = mmap.mmap(
            self._file.fileno(), 0, access=mmap.ACCESS_READ
        )
        self.video_shape = tuple(self.meta["video_shape"])
        self.pcm_len = self.meta["pcm_len"]
        self.video_format = self.meta.get("video_format", "rgb")
        self.pcm_dtype = np.dtype(self.meta.get("pcm_dtype", "float32"))
        self._video_bytes = _video_bytes_for(
            self.video_shape, self.video_format
        )
        self._rec_bytes = (
            self._video_bytes + self.pcm_len * self.pcm_dtype.itemsize + 4
        )
        self.n = self.meta["n"]
        self.crop_size = crop_size
        self.mode = mode
        self.num_sec = num_sec
        self.sample_rate = sample_rate
        self.name = "packed"
        # ground-truth labels for SK diagnostics
        self._labels = np.array(
            [self._read_label(i) for i in range(self.n)], np.int64
        )
        self.valid_indices = np.arange(self.n)

    def _rec(self, i: int) -> int:
        return self._data_off + i * self._rec_bytes

    def _read_label(self, i: int) -> int:
        off = (
            self._rec(i)
            + self._video_bytes
            + self.pcm_len * self.pcm_dtype.itemsize
        )
        return struct.unpack("<i", self._mm[off : off + 4])[0]

    def __len__(self):
        return self.n

    @property
    def labels(self) -> np.ndarray:
        return self._labels

    def get_example(self, idx: int, rng: Optional[np.random.Generator] = None):
        if rng is None:
            rng = np.random.default_rng(idx)
        off = self._rec(idx)
        out = {
            "label": int(self._labels[idx]),
            "index": idx,
            "vid_idx": idx,
        }
        t, h, w, _ = self.video_shape
        if self.video_format == "yuv420":
            y = np.frombuffer(self._mm, np.uint8, t * h * w, off).reshape(
                t, h, w
            )
            uv = np.frombuffer(
                self._mm, np.uint8, t * (h // 2) * (w // 2) * 2,
                off + t * h * w,
            ).reshape(t, h // 2, w // 2, 2)
            c = self.crop_size
            if c and c < h:
                # even-aligned paired crop so chroma stays in register
                if self.mode == "train":
                    i0 = 2 * int(rng.integers(0, (h - c) // 2 + 1))
                    j0 = 2 * int(rng.integers(0, (w - c) // 2 + 1))
                else:
                    i0 = ((h - c) // 2) // 2 * 2
                    j0 = ((w - c) // 2) // 2 * 2
                y = y[:, i0 : i0 + c, j0 : j0 + c]
                uv = uv[:, i0 // 2 : (i0 + c) // 2,
                        j0 // 2 : (j0 + c) // 2]
            out["video_y"] = np.ascontiguousarray(y)
            out["video_uv"] = np.ascontiguousarray(uv)
        else:
            video = np.frombuffer(
                self._mm, np.uint8, self._video_bytes, off
            ).reshape(self.video_shape)
            if self.crop_size and self.crop_size < h:
                if self.mode == "train":
                    video = random_crop(video, self.crop_size, rng)
                else:
                    video = center_crop(video, self.crop_size)
            out["video"] = np.ascontiguousarray(video)
        if self.pcm_len:
            pcm = np.frombuffer(
                self._mm, self.pcm_dtype, self.pcm_len,
                off + self._video_bytes,
            )
            if self.num_sec and self.sample_rate:
                want = self.num_sec * self.sample_rate
                slack = self.pcm_len - want
                start = int(rng.integers(0, slack + 1)) if (
                    slack > 0 and self.mode == "train"
                ) else max(slack // 2, 0)
                pcm = pcm[start : start + want]
            out["audio_pcm"] = np.ascontiguousarray(pcm)
        return out

    def close(self):
        # get_example returns zero-copy views into the mmap (the loader's
        # collate copies them); if any view is still alive the unmap is
        # deferred to GC
        try:
            self._mm.close()
        except BufferError:
            pass
        self._file.close()
