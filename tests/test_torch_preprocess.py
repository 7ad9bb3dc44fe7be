"""The port's video augmentation against the JAX package's.

JAX draws from threefry and the port from torch generators, so the streams
differ; here the JAX package's own draws (recomputed from its key split)
are injected into the port, and both must then produce the same video.
Tolerance 1e-5: the same fp32 elementwise arithmetic, with the gray
projection and the per-frame mean summed in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selavi_tpu.ops import preprocess as jpre
from selavi_tpu_torch.ops import preprocess as tpre

torch.set_num_threads(1)

B, T, HW = 6, 4, 16


def _frames(seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(B, T, HW, HW, 3), dtype=np.uint8)


def _jax_draws(key, b, s=0.4):
    """The draws jax augment_video_batch makes from ``key``."""
    k_flip, k_bj, k_cj, k_sj, k_perm, k_apply, k_gray = jax.random.split(key, 7)
    draws = {
        "flip": jax.random.bernoulli(k_flip, 0.5, (b,)),
        "bf": jax.random.uniform(k_bj, (b,), minval=1 - s, maxval=1 + s),
        "cf": jax.random.uniform(k_cj, (b,), minval=1 - s, maxval=1 + s),
        "sf": jax.random.uniform(k_sj, (b,), minval=1 - s, maxval=1 + s),
        "perm_idx": jax.random.randint(k_perm, (b,), 0, 6),
        "jitter": jax.random.bernoulli(k_apply, 0.8, (b,)),
        "gray": jax.random.bernoulli(k_gray, 0.2, (b,)),
    }
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("colorjitter,grayscale", [(False, False),
                                                   (True, False),
                                                   (True, True)])
def test_augment_with_injected_draws_matches_jax(seed, colorjitter, grayscale):
    frames = _frames(seed)
    key = jax.random.PRNGKey(seed)
    ref = jpre.augment_video_batch(jnp.asarray(frames), key,
                                   colorjitter=colorjitter,
                                   grayscale=grayscale)
    ours = tpre.augment_video_batch(torch.from_numpy(frames),
                                    colorjitter=colorjitter,
                                    grayscale=grayscale,
                                    draws=_jax_draws(key, B))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_flip_mirrors_width_per_clip():
    frames = _frames(3)
    flip = torch.tensor([True, False, True, False, False, True])
    out = tpre.augment_video_batch(torch.from_numpy(frames),
                                   draws={"flip": flip})
    norm = np.asarray(jpre.normalize_video(jnp.asarray(frames)))
    want = np.where(flip.numpy()[:, None, None, None, None],
                    norm[:, :, :, ::-1, :], norm)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-6, atol=1e-6)


def test_normalize_and_color_jitter_match_jax():
    rng = np.random.default_rng(4)
    frames = _frames(4)
    x_ref = jpre.normalize_video(jnp.asarray(frames))
    x = tpre.normalize_video(torch.from_numpy(frames))
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), rtol=1e-6,
                               atol=1e-6)
    bf, cf, sf = (rng.uniform(0.6, 1.4, B).astype(np.float32)
                  for _ in range(3))
    perm = np.arange(B) % 6  # every application order
    ref = jpre.color_jitter_normalized(x_ref, jnp.asarray(bf), jnp.asarray(cf),
                                       jnp.asarray(sf), jnp.asarray(perm))
    ours = tpre.color_jitter_normalized(x, torch.from_numpy(bf),
                                        torch.from_numpy(cf),
                                        torch.from_numpy(sf),
                                        torch.from_numpy(perm))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_generator_draws_are_reproducible_and_shaped():
    frames = torch.from_numpy(_frames(5))
    outs = [tpre.augment_video_batch(frames, torch.Generator().manual_seed(7),
                                     colorjitter=True, grayscale=True)
            for _ in range(2)]
    assert outs[0].shape == frames.shape and outs[0].dtype == torch.float32
    assert torch.equal(outs[0], outs[1])
