"""Batch loader: seeded per-epoch shuffle, host threads, pinned H2D.

The port's counterpart of ``selavi_tpu/data/loader.py`` for one process:
the same order (``default_rng((seed, epoch)).permutation(N)``) and the same
per-example RNG (``default_rng((seed, epoch, index))``), so the port reads
the same samples as the JAX package. Batches are collated to

    {"video": uint8 [B,T,H,W,3], "audio": fp32 [B,F,T,1],
     "label": int64 [B], "index": int64 [B]}

and copied to the device from pinned memory with ``non_blocking``. Example
rendering runs on ``num_workers`` threads (numpy releases the GIL for the
heavy parts), ``prefetch`` batches ahead of the consumer.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
from typing import Iterator

import numpy as np
import torch


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
        audio = np.stack([e["audio"] for e in examples])
        if audio.ndim == 3:  # [B, F, T] -> add the channel axis
            audio = audio[..., None]
        host = {
            "video": torch.from_numpy(np.stack([e["video"] for e in examples])),
            "audio": torch.from_numpy(audio.astype(np.float32)),
            "label": torch.as_tensor([e["label"] for e in examples],
                                     dtype=torch.int64),
            "index": torch.as_tensor([e["index"] for e in examples],
                                     dtype=torch.int64),
        }
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
