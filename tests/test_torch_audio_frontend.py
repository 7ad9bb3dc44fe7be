"""The port's device audio frontend and YUV wire decode on the CPU,
against the JAX package's:

* ``ops/logmel.py::logfbank_batch`` against JAX's and against the port's
  host ``get_spec``, in fp32, at rtol = atol = 2e-3 (JAX's own test of its
  frontend against the host uses the same; the two frameworks' FFTs differ
  in rounding, measured under 2e-4 here);
* ``train/step.py::prepare_audio`` on ``[B,S]``, ``[B,2,S]`` and a
  spectrogram that passes through, against JAX's;
* ``ops/preprocess.py::yuv420_to_rgb_batch``: exact;
* one train step on a PCM batch against JAX's train step on the same
  weights and inputs, at the tolerances of ``tests/test_torch_step.py``
  (its mirror-symmetric clip and labels, with raw PCM for the audio).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selavi_tpu.models import load_model as jax_load_model
from selavi_tpu.ops.logmel import logfbank_batch as jax_logfbank_batch
from selavi_tpu.ops.preprocess import yuv420_to_rgb_batch as jax_yuv_to_rgb
from selavi_tpu.train import optim as jax_optim
from selavi_tpu.train.state import TrainState
from selavi_tpu.train.step import make_train_step as jax_make_train_step
from selavi_tpu.train.step import prepare_audio as jax_prepare_audio
from selavi_tpu_torch.data.audio import get_spec
from selavi_tpu_torch.models.av_model import load_model
from selavi_tpu_torch.models.convert import load_jax_variables
from selavi_tpu_torch.ops import logmel
from selavi_tpu_torch.ops.preprocess import yuv420_to_rgb_batch
from selavi_tpu_torch.train.optim import make_optimizer, set_lr, warmup_lr
from selavi_tpu_torch.train.step import make_train_step, prepare_audio
from tests.test_torch_step import (BASE_LR, VIDEO, WD, H, K, _batch, _close,
                                   _random_variables)

torch.set_num_threads(1)

RTOL = ATOL = 2e-3


def _pcm(shape, seed=0):
    """int16-range PCM: a tone, noise and a silent stretch (the eps floor)."""
    rng = np.random.default_rng(seed)
    n = shape[-1]
    t = np.arange(n) / 16000.0
    tone = 6000 * np.sin(2 * np.pi * 440 * t)
    pcm = tone + rng.standard_normal(shape) * 3000
    pcm[..., n // 2: n // 2 + 700] = 0.0
    return np.clip(np.round(pcm), -32768, 32767).astype(np.float32)


@pytest.mark.parametrize("samplerate,nfilt,z", [(16000, 40, False),
                                                (16000, 257, True),
                                                (48000, 257, True),
                                                (24000, 40, True)])
def test_logfbank_batch_matches_jax_and_the_host(samplerate, nfilt, z):
    pcm = _pcm((3, samplerate + 37))
    ours = logmel.logfbank_batch(torch.from_numpy(pcm), samplerate=samplerate,
                                 nfilt=nfilt, z_normalize=z)
    ref = np.asarray(jax_logfbank_batch(jnp.asarray(pcm),
                                        samplerate=samplerate, nfilt=nfilt,
                                        z_normalize=z))
    assert ours.dtype == torch.float32 and ours.shape == ref.shape
    assert ours.shape[1] == nfilt
    np.testing.assert_allclose(ours.numpy(), ref, rtol=RTOL, atol=ATOL)
    for b in range(3):
        host = get_spec(pcm[b], 0.0, num_sec=1, sample_rate=samplerate,
                        aud_spec_type=1 if nfilt == 40 else 2,
                        z_normalize=z)[0]
        np.testing.assert_allclose(ours[b, :, :host.shape[1]].numpy(), host,
                                   rtol=RTOL, atol=ATOL)


def test_logfbank_floor_and_filterbank_cache():
    silent = torch.zeros(2, 16000)
    out = logmel.logfbank_batch(silent, samplerate=16000, nfilt=40)
    np.testing.assert_allclose(out.numpy(), np.log(np.finfo(np.float64).eps),
                               rtol=1e-6)
    a = logmel._filterbank_t(40, 1024, 16000, torch.device("cpu"))
    b = logmel._filterbank_t(40, 1024, 16000, torch.device("cpu"))
    assert a is b and a.dtype == torch.float32 and a.shape == (513, 40)
    # fp32 under a bf16 autocast: the frontend leaves it
    pcm = torch.from_numpy(_pcm((2, 16000)))
    with torch.autocast("cpu", dtype=torch.bfloat16):
        auto = logmel.logfbank_batch(pcm, samplerate=16000, nfilt=40)
    assert auto.dtype == torch.float32
    assert torch.equal(auto, logmel.logfbank_batch(pcm, samplerate=16000,
                                                   nfilt=40))


CFG = {"samplerate": 16000, "nfilt": 40, "z_normalize": True}


@pytest.mark.parametrize("shape", [(3, 16000), (2, 2, 16000),
                                   (2, 40, 99, 1)])
def test_prepare_audio_matches_jax(shape):
    audio = _pcm(shape) if len(shape) < 4 else np.random.default_rng(
        1).standard_normal(shape).astype(np.float32)
    ours = prepare_audio(torch.from_numpy(audio), torch.float32, CFG)
    ref = np.asarray(jax_prepare_audio(jnp.asarray(audio), jnp.float32, CFG))
    want = {2: (3, 40, 99, 1), 3: (2, 40, 99, 2), 4: shape}[len(shape)]
    assert ours.shape == ref.shape == want and ours.dtype == torch.float32
    if len(shape) == 4:
        assert np.array_equal(ours.numpy(), audio)  # passes through
    np.testing.assert_allclose(ours.numpy(), ref, rtol=RTOL, atol=ATOL)
    if len(shape) == 3:  # each channel is its clip's spectrogram
        for c in range(2):
            single = prepare_audio(torch.from_numpy(audio[:, c]),
                                   torch.float32, CFG)
            assert torch.equal(ours[..., c], single[..., 0])


@pytest.mark.parametrize("shape", [(2, 3, 16, 24), (1, 2, 112, 112),
                                   (1, 1, 512, 1024)])
def test_yuv420_to_rgb_is_jax_exactly(shape):
    rng = np.random.default_rng(2)
    y = rng.integers(0, 256, shape, np.uint8)
    uv = rng.integers(0, 256, shape[:2] + (shape[2] // 2, shape[3] // 2, 2),
                      np.uint8)
    ours = yuv420_to_rgb_batch(torch.from_numpy(y), torch.from_numpy(uv))
    ref = np.asarray(jax_yuv_to_rgb(jnp.asarray(y), jnp.asarray(uv)))
    assert ours.dtype == torch.uint8 and ours.shape == shape + (3,)
    np.testing.assert_array_equal(ours.numpy(), ref)


# ------------------------------------------------- a train step on PCM

PCM_LEN = 8320  # 51 frames at 16 kHz, the audio width of test_torch_step
AUDIO_CFG = {"samplerate": 16000, "nfilt": 40, "z_normalize": True}


def _pcm_steps(dtype):
    """(jax metrics, jax new variables, port model before/after, metrics)
    for one train step on a PCM batch ``[B, S]``."""
    jdtype = jnp.float64 if dtype == "float64" else jnp.float32
    tdtype = getattr(torch, dtype)
    video, _, labels = _batch()  # test_torch_step's clip and labels
    pcm = _pcm((VIDEO[0], PCM_LEN), seed=3)
    with jax.enable_x64(dtype == "float64"):
        jmodel = jax_load_model(headcount=H, num_classes=K, use_mlp=False,
                                dtype=jdtype)
        shapes = jax.eval_shape(lambda: jmodel.init(
            {"params": jax.random.PRNGKey(0),
             "dropout": jax.random.PRNGKey(1)},
            jnp.zeros(VIDEO), jnp.zeros((2, 40, 51, 1)), train=False))
        variables = _random_variables(shapes, 0)
        params, bs = variables["params"], variables["batch_stats"]
        jparams = jax.tree.map(lambda a: jnp.asarray(a, jdtype), params)
        tx = jax_optim.make_optimizer(BASE_LR, WD, warmup_epochs=10,
                                      batches_per_epoch=1)
        state = TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                           batch_stats=bs, opt_state=tx.init(jparams), tx=tx)
        jstep = jax_make_train_step(jmodel, compute_dtype=jdtype,
                                    donate=False, audio_cfg=AUDIO_CFG)
        new_state, jmetrics = jstep(
            state, {"video": jnp.asarray(video),
                    "audio_pcm": jnp.asarray(pcm)},
            jnp.asarray(labels), jax.random.PRNGKey(3))
        jmetrics = {k: float(v) for k, v in jmetrics.items()}
        new_params = jax.tree.map(lambda a: np.asarray(a, np.float64),
                                  new_state.params)
        new_bs = jax.tree.map(lambda a: np.asarray(a, np.float64),
                              new_state.batch_stats)

    model = load_model(headcount=H, num_classes=K, use_mlp=False,
                       device="cpu")
    load_jax_variables(model, params, bs)
    model = model.to(tdtype)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = make_optimizer(model, BASE_LR, WD)
    set_lr(opt, warmup_lr(0, BASE_LR, 1.0, 10))
    step = make_train_step(model, opt, compute_dtype=tdtype,
                           audio_cfg=AUDIO_CFG)
    metrics = step({"video": torch.from_numpy(video),
                    "audio_pcm": torch.from_numpy(pcm)},
                   torch.from_numpy(labels).long(),
                   torch.Generator().manual_seed(0))

    ref = load_model(headcount=H, num_classes=K, use_mlp=False, device="cpu")
    ref = ref.to(torch.float64)
    load_jax_variables(ref, new_params, new_bs)
    return jmetrics, ref.state_dict(), before, model.state_dict(), metrics


def test_one_pcm_train_step_matches_jax_fp64():
    jmetrics, ref, before, after, metrics = _pcm_steps("float64")
    for key in ("loss", "loss_v", "loss_a"):
        np.testing.assert_allclose(float(metrics[key]), jmetrics[key],
                                   rtol=1e-6)
    for name, value in after.items():
        if "running" in name:
            _close(value, ref[name], 1e-4)
        else:
            _close(value - before[name], ref[name] - before[name], 1e-4)


def test_one_pcm_train_step_matches_jax_fp32():
    jmetrics, ref, before, after, metrics = _pcm_steps("float32")
    for key in ("loss", "loss_v", "loss_a"):
        np.testing.assert_allclose(float(metrics[key]), jmetrics[key],
                                   rtol=1e-5)
    for name, value in after.items():
        if "running" in name:
            _close(value, ref[name], 1e-4)
        elif not name.startswith("video_network."):
            _close(value - before[name], ref[name] - before[name], 2e-3)
