"""Batch loader: seeded per-epoch shuffle, host workers, pinned H2D.

The port's counterpart of ``selavi_tpu/data/loader.py``: the same order
(``default_rng((seed, epoch)).permutation(N)``) and the same per-example
RNG (``default_rng((seed, epoch, index))``), so the port reads the same
samples as the JAX package. With ``world_size`` > 1 each rank reads the
strided subset ``order[rank::world_size]`` of that order, cut to a
multiple of ``world_size`` under ``drop_last`` and wrapped up to one
otherwise, so every rank yields the same number of batches; rank ``r``'s
batch ``k`` is then rows ``r::world_size`` of the one-process batch ``k``
at ``world_size`` times the batch size. Batches are collated to

    {"video": uint8 [B,T,H,W,3]            (or, from a yuv420 shard,
                                            "video_y" uint8 [B,T,H,W] and
                                            "video_uv" uint8 [B,T,H/2,W/2,2]),
     "audio": fp32 [B,F,T,C]               (or "audio_pcm" [B,S] / [B,2,S]:
                                            int16 as stored, fp32 otherwise),
     "label": int64 [B], "index": int64 [B], "vid_idx": int64 [B]}

(with ``world_size`` > 1 also ``"valid": bool [B]``, false on the rows
that wrap-padding repeated, at global positions >= N, which the consumers
that gather rows across ranks drop) and copied to the device from pinned
memory with ``non_blocking``.

Examples are rendered ``prefetch`` batches ahead of the consumer, on
``num_workers`` threads (``worker_mode="thread"``; numpy releases the GIL
for the heavy parts) or spawned processes (``"process"``: no GIL, at the
cost of pickling each example back; the dataset must be picklable, and a
packed shard, which holds an mmap, is not, as in the JAX package). Either
mode yields the same batches bit for bit. Workers never touch the card:
collation, pinning and the copy stay in the consumer's process.

With ``coalesce`` (``--coalesce_transfers``, the default) a batch goes to
the card in one copy (``coalesce_batch``). Its buffer is field-major, not
the JAX package's row-major ``[B, rec_bytes]``: each field is one
contiguous run of bytes at a 64-byte aligned offset, so on the card every
field is a zero-copy ``view`` of the buffer (a strided byte column of the
row layout would need a ``contiguous()`` copy per field to be read as
int16 or fp32).

The wire formats stay compact until they are on the device:
``decode_wire_batch`` (the JAX package's ``decode_wire_batches``) turns the
YUV planes into RGB and int16 PCM into fp32 there.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import multiprocessing
import os
from typing import Iterator

import numpy as np
import torch

from selavi_tpu_torch.ops.preprocess import yuv420_to_rgb_batch
from selavi_tpu_torch.utils.profiling import count, span

FIELD_ALIGN = 64  # bytes: every field of a coalesced buffer starts aligned

_WORKER_DATASET = None


def _process_worker_init(dataset) -> None:
    """Runs first in each spawned worker: hide the card from the worker
    before anything could initialise CUDA there (workers only render
    examples in numpy), and hold the dataset once instead of pickling it
    with every task."""
    global _WORKER_DATASET
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    _WORKER_DATASET = dataset


def _process_fetch(idx: int, seed: tuple) -> dict:
    return _WORKER_DATASET.get_example(int(idx), np.random.default_rng(seed))


def coalesce_batch(host: dict, device) -> dict:
    """Host arrays -> tensors on ``device`` through ONE buffer: the fields
    are packed field-major into one uint8 buffer (pinned for a CUDA
    device), copied with one ``non_blocking`` copy, and split on the device
    into views, bit for bit the arrays given."""
    device = torch.device(device)
    layout, total = [], 0
    for key in sorted(host):
        a = np.ascontiguousarray(host[key])
        layout.append((key, a, total))
        total += -(-a.nbytes // FIELD_ALIGN) * FIELD_ALIGN
    buf = torch.empty(total, dtype=torch.uint8,
                      pin_memory=device.type == "cuda")
    flat = buf.numpy()
    for _, a, off in layout:
        flat[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
    if device.type == "cuda":
        buf = buf.to(device, non_blocking=True)
    out = {}
    for key, a, off in layout:
        dtype = torch.from_numpy(a[:0]).dtype
        out[key] = buf[off:off + a.nbytes].view(dtype).view(a.shape)
    return out


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 0, seed: int = 0,
                 device="cpu", prefetch: int = 2, worker_mode: str = "thread",
                 coalesce: bool = True, rank: int = 0, world_size: int = 1):
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"worker_mode {worker_mode!r}: thread or "
                             f"process")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.seed = seed
        self.device = torch.device(device)
        self.prefetch = max(1, prefetch)
        self.worker_mode = worker_mode
        self.coalesce = coalesce
        self.rank = rank
        self.world_size = world_size
        self.epoch = 0
        self._pool = None

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        """Batches every rank yields (the same on every rank)."""
        n = len(self.dataset)
        if self.drop_last:
            return (n // self.world_size) // self.batch_size
        per_rank = -(-n // self.world_size)
        return -(-per_rank // self.batch_size)

    def _positions(self) -> np.ndarray:
        """This rank's positions in the epoch's order: ``rank::world_size``
        of it cut (``drop_last``) or wrapped to a multiple of
        ``world_size``."""
        n = len(self.dataset)
        if self.drop_last:
            total = n // self.world_size * self.world_size
        else:
            total = -(-n // self.world_size) * self.world_size
        return np.arange(self.rank, total, self.world_size)

    def _order(self) -> np.ndarray:
        n = len(self.dataset)
        order = (np.random.default_rng((self.seed, self.epoch)).permutation(n)
                 if self.shuffle else np.arange(n))
        if self.world_size == 1:
            return order
        # np.resize tiles: wrap-padding longer than N (N < world_size / 2)
        # still gives every rank the same count
        padded = -(-n // self.world_size) * self.world_size
        return np.resize(order, padded)[self._positions()]

    def _fetch(self, i: int) -> dict:
        rng = np.random.default_rng((self.seed, self.epoch, int(i)))
        return self.dataset.get_example(int(i), rng)

    def _get_pool(self) -> cf.ProcessPoolExecutor:
        """The spawned worker processes, started at the first process-mode
        epoch and kept until ``close()``."""
        if self._pool is None:
            self._pool = cf.ProcessPoolExecutor(
                self.num_workers,
                mp_context=multiprocessing.get_context("spawn"),
                initializer=_process_worker_init, initargs=(self.dataset,))
        return self._pool

    def close(self) -> None:
        """Stop the worker processes, if any were started."""
        if self._pool is not None:
            self._pool.shutdown(cancel_futures=True)
            self._pool = None

    def _collate(self, examples, valid=None) -> dict:
        """The batch of ``examples`` on the device; ``valid`` (bool, one
        a row) rides along as ``"valid"`` when given. Spanned as
        ``loader.collate`` and counted in ``loader.batches``."""
        count("loader.batches")
        with span("loader.collate"):
            return self._collate_examples(examples, valid)

    def _collate_examples(self, examples, valid) -> dict:
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
        elif "audio" in examples[0]:  # none with decode_audio=False
            audio = np.stack([e["audio"] for e in examples])
            if audio.ndim == 3:  # [B, F, T] -> add the channel axis
                audio = audio[..., None]
            host["audio"] = audio.astype(np.float32)
        for key in ("label", "index", "vid_idx"):
            host[key] = np.asarray([e[key] for e in examples], np.int64)
        if valid is not None:
            host["valid"] = valid
        if self.coalesce:
            return coalesce_batch(host, self.device)
        host = {k: torch.from_numpy(v) for k, v in host.items()}
        if self.device.type != "cuda":
            return host
        return {k: v.pin_memory().to(self.device, non_blocking=True)
                for k, v in host.items()}

    def __iter__(self) -> Iterator[dict]:
        order = self._order()
        bs = self.batch_size
        stop = len(order) - bs + 1 if self.drop_last else len(order)
        starts = range(0, max(stop, 0), bs)
        batches = [order[s:s + bs] for s in starts]
        # rows at global positions >= N are wrap-padding
        valid = ([self._positions()[s:s + bs] < len(self.dataset)
                  for s in starts] if self.world_size > 1
                 else [None] * len(batches))
        if self.num_workers <= 0:
            for idxs, ok in zip(batches, valid):
                with span("loader.wait"):
                    examples = [self._fetch(i) for i in idxs]
                yield self._collate(examples, ok)
            return
        if self.worker_mode == "process":
            pool = self._get_pool()
            yield from self._pipelined(batches, valid, lambda i: pool.submit(
                _process_fetch, int(i), (self.seed, self.epoch, int(i))))
            return
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            yield from self._pipelined(
                batches, valid, lambda i: pool.submit(self._fetch, i))

    def _pipelined(self, batches, valid, submit) -> Iterator[dict]:
        """Keep ``prefetch`` batches of examples in flight on the workers
        and collate them in order; the consumer's wait for a batch's
        examples is the span ``loader.wait``."""
        pending = collections.deque()
        for idxs, ok in zip(batches, valid):
            pending.append(([submit(i) for i in idxs], ok))
            if len(pending) > self.prefetch:
                yield self._collate(*self._wait(pending.popleft()))
        while pending:
            yield self._collate(*self._wait(pending.popleft()))

    @staticmethod
    def _wait(entry) -> tuple[list, object]:
        futures, ok = entry
        with span("loader.wait"):
            return [f.result() for f in futures], ok


def batch_valid(batch: dict, device="cpu") -> torch.Tensor:
    """The batch's ``valid`` rows (every row where it carries none, as a
    one-rank loader's batch does) as a bool tensor on ``device``."""
    valid = batch.get("valid")
    if valid is None:
        return torch.ones(len(batch["label"]), dtype=torch.bool,
                          device=device)
    return torch.as_tensor(valid).to(device, torch.bool)


def decode_wire_batch(batch: dict) -> dict:
    """Expand the wire formats where the batch lies: YUV 4:2:0 planes
    become RGB uint8 ``video``, int16 ``audio_pcm`` becomes fp32. Plain
    batches pass through unchanged. Spanned as ``loader.decode``."""
    with span("loader.decode"):
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
