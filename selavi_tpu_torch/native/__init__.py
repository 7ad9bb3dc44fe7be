"""ctypes bindings for the port's C++ host data runtime
(``native/data_runtime.cpp``; the counterpart of ``selavi_tpu/native``).

The library is built with g++ at first use (``ops/_build.py::
build_host_library``, the JAX package's flags) into
``build/selavi_tpu_torch/``, keyed by the source's hash and the host, since
``-march=native`` code is host-specific. Every entry point has a numpy
fallback, used with a logged warning when g++ is missing or fails, as in
the JAX package; ``available()`` says which path is active.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent / "data_runtime.cpp"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def build_library() -> Path:
    """Compile ``native/data_runtime.cpp`` (see ``ops/_build.py``) and
    return the library's path; raises ``RuntimeError`` if g++ fails."""
    from selavi_tpu_torch.ops import _build

    return _build.build_host_library(SOURCE)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i = ctypes.c_int
    lib.selavi_logfbank_batch.argtypes = [
        f32p, i, i, i, f64p, i, i, i, i, i, ctypes.c_double, f32p, i,
    ]
    lib.selavi_logfbank_batch.restype = None
    lib.selavi_resize_bilinear_u8.argtypes = [u8p, i, i, i, i, u8p, i, i, i]
    lib.selavi_resize_bilinear_u8.restype = None
    lib.selavi_greedy_swap_match.argtypes = [
        f64p, i, i, i, i, ctypes.c_uint64, ctypes.POINTER(ctypes.c_int32),
    ]
    lib.selavi_greedy_swap_match.restype = None
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            _lib = _bind(ctypes.CDLL(str(build_library())))
        except (RuntimeError, OSError) as e:
            logger.warning("native data runtime unavailable (%s); using "
                           "numpy fallbacks", e)
            _build_failed = True
        return _lib


def available() -> bool:
    return _load() is not None


def logfbank_batch_native(
    pcm: np.ndarray,
    samplerate: int,
    nfilt: int = 40,
    nfft: int = 1024,
    winlen: float = 0.02,
    winstep: float = 0.01,
    preemph: float = 0.97,
    nthreads: int = 0,
) -> np.ndarray:
    """pcm [B, S] float -> [B, nfilt, T] float32. Falls back to numpy."""
    from selavi_tpu_torch.data.audio import (
        _round_half_up,
        frame_count,
        logfbank,
        mel_filterbank,
    )

    pcm = np.ascontiguousarray(pcm, np.float32)
    b, slen = pcm.shape
    frame_len = _round_half_up(winlen * samplerate)
    frame_step = _round_half_up(winstep * samplerate)
    nframes = frame_count(slen, frame_len, frame_step)

    lib = _load()
    if lib is None:
        out = np.stack([
            logfbank(pcm[i].astype(np.float64), samplerate, winlen=winlen,
                     winstep=winstep, nfilt=nfilt, nfft=nfft,
                     preemph=preemph).T
            for i in range(b)
        ])
        return out.astype(np.float32)

    fb = np.ascontiguousarray(mel_filterbank(nfilt, nfft, samplerate),
                              np.float64)
    out = np.empty((b, nfilt, nframes), np.float32)
    if nthreads <= 0:
        nthreads = min(b, os.cpu_count() or 1)
    lib.selavi_logfbank_batch(
        pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        b, slen, samplerate,
        fb.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        nfilt, nfft, frame_len, frame_step, nframes,
        ctypes.c_double(preemph),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        nthreads,
    )
    return out


def resize_bilinear_u8(frames: np.ndarray, new_h: int, new_w: int,
                       nthreads: int = 0) -> np.ndarray:
    """frames [T, H, W, C] uint8 -> [T, newH, newW, C] uint8."""
    frames = np.ascontiguousarray(frames, np.uint8)
    t, h, w, c = frames.shape
    if new_h <= 0 or new_w <= 0:
        raise ValueError(f"resize to {new_h}x{new_w}")
    lib = _load()
    if lib is None:
        from selavi_tpu_torch.data.transforms import _resize_frames

        return _resize_frames(frames, new_h, new_w)
    out = np.empty((t, new_h, new_w, c), np.uint8)
    if nthreads <= 0:
        nthreads = min(t, os.cpu_count() or 1)
    lib.selavi_resize_bilinear_u8(
        frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        t, h, w, c,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        new_h, new_w, nthreads,
    )
    return out


def greedy_swap_match_native(
    cost: np.ndarray,
    steps: int = 50000,
    restarts: int = 2,
    patience: int = 1000,
    seed: int = 1,
) -> Optional[np.ndarray]:
    """The C++ greedy swap search over the K x K cost matrix; None when the
    library is unavailable (the caller falls back to the Python loop)."""
    lib = _load()
    if lib is None:
        return None
    cost = np.ascontiguousarray(cost, np.float64)
    k = cost.shape[0]
    if cost.shape != (k, k):
        raise ValueError(f"cost must be square, got {cost.shape}")
    out = np.empty(k, np.int32)
    lib.selavi_greedy_swap_match(
        cost.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        k, steps, restarts, patience, ctypes.c_uint64(seed),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out
