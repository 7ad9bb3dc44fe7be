"""Batch loader: seeded per-epoch shuffle, host threads, pinned H2D.

The port's counterpart of ``selavi_tpu/data/loader.py`` for one process:
the same order (``default_rng((seed, epoch)).permutation(N)``) and the same
per-example RNG (``default_rng((seed, epoch, index))``), so the port reads
the same samples as the JAX package. Batches are collated to

    {"video": uint8 [B,T,H,W,3]            (or, from a yuv420 shard,
                                            "video_y" uint8 [B,T,H,W] and
                                            "video_uv" uint8 [B,T,H/2,W/2,2]),
     "audio": fp32 [B,F,T,1]               (or "audio_pcm" [B,S]: int16 as
                                            stored, fp32 otherwise),
     "label": int64 [B], "index": int64 [B], "vid_idx": int64 [B]}

and copied to the device from pinned memory with ``non_blocking``. Example
rendering runs on ``num_workers`` threads (numpy releases the GIL for the
heavy parts), ``prefetch`` batches ahead of the consumer.

The wire formats stay compact until they are on the device:
``decode_wire_batch`` (the JAX package's ``decode_wire_batches``) turns the
YUV planes into RGB and int16 PCM into fp32 there.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
from typing import Iterator

import numpy as np
import torch

from selavi_tpu_torch.ops.preprocess import yuv420_to_rgb_batch


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 0, seed: int = 0,
                 device="cpu", prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.seed = seed
        self.device = torch.device(device)
        self.prefetch = max(1, prefetch)
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _order(self) -> np.ndarray:
        n = len(self.dataset)
        if not self.shuffle:
            return np.arange(n)
        return np.random.default_rng((self.seed, self.epoch)).permutation(n)

    def _fetch(self, i: int) -> dict:
        rng = np.random.default_rng((self.seed, self.epoch, int(i)))
        return self.dataset.get_example(int(i), rng)

    def _collate(self, examples) -> dict:
        host = {}
        if "video_y" in examples[0]:
            host["video_y"] = np.stack([e["video_y"] for e in examples])
            host["video_uv"] = np.stack([e["video_uv"] for e in examples])
        else:
            host["video"] = np.stack([e["video"] for e in examples])
        if "audio_pcm" in examples[0]:
            # raw waveforms: the spectrogram is computed on the device;
            # int16 (packed shards) stays int16 over the wire
            pcm = np.stack([e["audio_pcm"] for e in examples])
            host["audio_pcm"] = (pcm if pcm.dtype == np.int16
                                 else pcm.astype(np.float32))
        else:
            audio = np.stack([e["audio"] for e in examples])
            if audio.ndim == 3:  # [B, F, T] -> add the channel axis
                audio = audio[..., None]
            host["audio"] = audio.astype(np.float32)
        for key in ("label", "index", "vid_idx"):
            host[key] = np.asarray([e[key] for e in examples], np.int64)
        host = {k: torch.from_numpy(v) for k, v in host.items()}
        if self.device.type != "cuda":
            return host
        return {k: v.pin_memory().to(self.device, non_blocking=True)
                for k, v in host.items()}

    def __iter__(self) -> Iterator[dict]:
        order = self._order()
        bs = self.batch_size
        stop = len(order) - bs + 1 if self.drop_last else len(order)
        batches = [order[s:s + bs] for s in range(0, max(stop, 0), bs)]
        if self.num_workers <= 0:
            for idxs in batches:
                yield self._collate([self._fetch(i) for i in idxs])
            return
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            pending = collections.deque()
            for idxs in batches:
                pending.append([pool.submit(self._fetch, i) for i in idxs])
                if len(pending) > self.prefetch:
                    yield self._collate([f.result() for f in pending.popleft()])
            while pending:
                yield self._collate([f.result() for f in pending.popleft()])


def decode_wire_batch(batch: dict) -> dict:
    """Expand the wire formats where the batch lies: YUV 4:2:0 planes
    become RGB uint8 ``video``, int16 ``audio_pcm`` becomes fp32. Plain
    batches pass through unchanged."""
    if "video_y" in batch:
        batch = dict(batch)
        batch["video"] = yuv420_to_rgb_batch(batch.pop("video_y"),
                                             batch.pop("video_uv"))
    if "audio_pcm" in batch and batch["audio_pcm"].dtype == torch.int16:
        batch = dict(batch)
        batch["audio_pcm"] = batch["audio_pcm"].float()
    return batch


def decode_wire_batches(batch_iter: Iterator[dict]) -> Iterator[dict]:
    """``decode_wire_batch`` over an iterator of batches."""
    for batch in batch_iter:
        yield decode_wire_batch(batch)
