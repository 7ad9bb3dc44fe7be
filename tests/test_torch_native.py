"""The port's C++ host data runtime (``selavi_tpu_torch.native``) against
the JAX package's (``selavi_tpu.native``) on the same numpy inputs.

Both libraries are built here by g++ from the same arithmetic with the
same flags, so every comparison is exact: the filterbank bit for bit at
40 and 257 filters, the resize bit for bit, the swap search the same
permutation. With each library unavailable, the numpy fallbacks of the
two packages equal each other too. Skips when g++ is missing.
"""

import shutil

import numpy as np
import pytest
import torch

from selavi_tpu import native as jax_native
from selavi_tpu_torch import native
from selavi_tpu_torch.ops import _build

torch.set_num_threads(1)


@pytest.fixture
def libraries():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: no native library to compare")
    assert native.available() and jax_native.available()


@pytest.fixture
def fallbacks(monkeypatch):
    """Both packages with their library unavailable."""
    monkeypatch.setattr(native, "_load", lambda: None)
    monkeypatch.setattr(jax_native, "_load", lambda: None)
    assert not native.available() and not jax_native.available()


def _pcm(seed, b=3, n=16000):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    tone = 3000 * np.sin(2 * np.pi * rng.uniform(100, 4000, (b, 1)) * t)
    return (tone + rng.standard_normal((b, n)) * 500).astype(np.float32)


@pytest.mark.parametrize("nfilt", [40, 257])
@pytest.mark.parametrize("samples", [16000, 24000, 1000])
def test_logfbank_matches_jax_bit_for_bit(libraries, nfilt, samples):
    pcm = _pcm(nfilt + samples, n=samples)
    ours = native.logfbank_batch_native(pcm, 16000, nfilt=nfilt, nthreads=2)
    ref = jax_native.logfbank_batch_native(pcm, 16000, nfilt=nfilt,
                                           nthreads=2)
    assert ours.dtype == np.float32 and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)
    # one thread per sample gives the same bits as the threaded batch
    np.testing.assert_array_equal(
        native.logfbank_batch_native(pcm[1:2], 16000, nfilt=nfilt,
                                     nthreads=1)[0], ours[1])


@pytest.mark.parametrize("shape,new", [((3, 48, 64, 3), (128, 170)),
                                       ((2, 160, 160, 3), (112, 112)),
                                       ((1, 37, 53, 3), (200, 90)),
                                       ((2, 31, 17, 2), (9, 45))])
def test_resize_matches_jax_bit_for_bit(libraries, shape, new):
    frames = np.random.default_rng(sum(shape)).integers(0, 256, shape,
                                                        np.uint8)
    ours = native.resize_bilinear_u8(frames, *new, nthreads=2)
    ref = jax_native.resize_bilinear_u8(frames, *new, nthreads=2)
    assert ours.dtype == np.uint8 and ours.shape == shape[:1] + new + shape[3:]
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("seed", [1, 7, 2 ** 61 + 3])
def test_greedy_swap_match_matches_jax(libraries, seed):
    rng = np.random.default_rng(seed % 1000)
    cost = rng.random((57, 57))
    ours = native.greedy_swap_match_native(cost, steps=20000, seed=seed)
    ref = jax_native.greedy_swap_match_native(cost, steps=20000, seed=seed)
    assert ours.dtype == np.int32
    np.testing.assert_array_equal(ours, ref)
    assert sorted(ours.tolist()) == list(range(57))
    # the search improves on the identity
    assert cost[np.arange(57), ours].sum() < np.trace(cost)


def test_fallbacks_match_jax(fallbacks):
    pcm = _pcm(3, b=2)
    for nfilt in (40, 257):
        np.testing.assert_array_equal(
            native.logfbank_batch_native(pcm, 16000, nfilt=nfilt),
            jax_native.logfbank_batch_native(pcm, 16000, nfilt=nfilt))
    frames = np.random.default_rng(4).integers(0, 256, (2, 30, 41, 3),
                                               np.uint8)
    np.testing.assert_array_equal(native.resize_bilinear_u8(frames, 64, 20),
                                  jax_native.resize_bilinear_u8(frames, 64,
                                                                20))
    assert native.greedy_swap_match_native(np.eye(4)) is None
    assert jax_native.greedy_swap_match_native(np.eye(4)) is None


def test_library_is_keyed_by_source_and_host(libraries):
    path = native.build_library()
    assert path.parent == _build.BUILD_DIR
    assert path.name.endswith(f"_{_build.host_key()}.so")
    assert path.name.startswith("libdata_runtime_")
    assert native.build_library() == path  # reused, not rebuilt


def test_a_failed_build_falls_back_with_a_warning(monkeypatch, caplog):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)

    def fail():
        raise RuntimeError("g++ not found")

    monkeypatch.setattr(native, "build_library", fail)
    with caplog.at_level("WARNING", logger=native.__name__):
        assert not native.available()
    assert "numpy fallbacks" in caplog.text
    assert native.greedy_swap_match_native(np.eye(3)) is None
