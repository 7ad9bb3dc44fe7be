"""One port train step against one JAX train step on the CPU.

Same weights (loaded through ``load_jax_variables``), batch and labels.
The uint8 clip is mirror-symmetric along W, so the flip draw cannot matter,
and the heads are linear (``use_mlp=False``), so there is no dropout draw:
the two steps then compute the same function.

In fp64 (both frameworks) the loss agrees to 1e-6 and every parameter
update and BN statistic to 1e-4 of scale: both packages keep the input
video, the pooled features and the CE in fp32, and that rounding enters the
fp64 backward, which amplifies it through the video tower. In fp32 the
loss and BN statistics agree to 1e-5 and 1e-4 of scale, and the updates of
the audio tower and the heads to 2e-3 of each tensor's largest update. The
fp32 gradient of the video tower at this tiny input is ill-conditioned
(BN over 8 values per channel in layer4): against an fp64 run the JAX fp32
gradient is off by up to ~33% and the port's by ~3% on the worst tensor,
so the video tower's update is held to the fp64 comparison.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from selavi_tpu.models import load_model as jax_load_model
from selavi_tpu.train import optim as jax_optim
from selavi_tpu.train.state import TrainState
from selavi_tpu.train.step import make_train_step as jax_make_train_step
from selavi_tpu_torch.models.av_model import load_model
from selavi_tpu_torch.models.convert import load_jax_variables
from selavi_tpu_torch.train.optim import make_optimizer, set_lr, warmup_lr
from selavi_tpu_torch.train.step import make_train_step

torch.set_num_threads(1)

H, K = 2, 8
VIDEO = (2, 4, 32, 32, 3)
AUDIO = (2, 40, 51, 1)
BASE_LR, WD = 0.5, 1e-3


def _random_variables(shapes, seed):
    rng = np.random.default_rng(seed)

    def fill(path, s):
        keys = [getattr(p, "key", None) for p in path]
        if keys[-1] == "kernel":
            fan_in = s.shape[-2] if "heads" in keys else math.prod(s.shape[:-1])
            return rng.normal(0, math.sqrt(2.0 / fan_in), s.shape)
        if keys[-1] in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape)
        return rng.normal(0, 0.1, s.shape)

    out = jax.tree_util.tree_map_with_path(fill, shapes)
    return jax.tree.map(lambda a: np.asarray(a, np.float32), out)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    half = rng.integers(0, 256, size=VIDEO[:3] + (VIDEO[3] // 2, 3),
                        dtype=np.uint8)
    video = np.concatenate([half, half[:, :, :, ::-1]], axis=3)  # W-mirror
    audio = rng.normal(0, 1, AUDIO).astype(np.float32)
    labels = rng.integers(0, K, size=(VIDEO[0], H)).astype(np.int32)
    return video, audio, labels


def _close(ours, ref, rtol):
    ours = np.asarray(torch.as_tensor(ours).double())
    ref = np.asarray(torch.as_tensor(ref).double())
    scale = max(float(np.abs(ref).max()), 1e-12)
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=rtol * scale)


def _steps(dtype):
    """(jax metrics, jax new variables, port model before/after, metrics)."""
    jdtype = jnp.float64 if dtype == "float64" else jnp.float32
    tdtype = getattr(torch, dtype)
    video, audio, labels = _batch()
    with jax.enable_x64(dtype == "float64"):
        jmodel = jax_load_model(headcount=H, num_classes=K, use_mlp=False,
                                dtype=jdtype)
        shapes = jax.eval_shape(lambda: jmodel.init(
            {"params": jax.random.PRNGKey(0),
             "dropout": jax.random.PRNGKey(1)},
            jnp.zeros(VIDEO), jnp.zeros(AUDIO), train=False))
        variables = _random_variables(shapes, 0)
        params, bs = variables["params"], variables["batch_stats"]
        jparams = jax.tree.map(lambda a: jnp.asarray(a, jdtype), params)
        tx = jax_optim.make_optimizer(BASE_LR, WD, warmup_epochs=10,
                                      batches_per_epoch=1)
        state = TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                           batch_stats=bs, opt_state=tx.init(jparams), tx=tx)
        jstep = jax_make_train_step(jmodel, compute_dtype=jdtype,
                                    donate=False)
        new_state, jmetrics = jstep(
            state, {"video": jnp.asarray(video), "audio": jnp.asarray(audio)},
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
    step = make_train_step(model, opt, compute_dtype=tdtype)
    metrics = step({"video": torch.from_numpy(video),
                    "audio": torch.from_numpy(audio)},
                   torch.from_numpy(labels).long(),
                   torch.Generator().manual_seed(0))

    ref = load_model(headcount=H, num_classes=K, use_mlp=False, device="cpu")
    ref = ref.to(torch.float64)
    load_jax_variables(ref, new_params, new_bs)
    return jmetrics, ref.state_dict(), before, model.state_dict(), metrics


def test_one_train_step_matches_jax_fp64():
    jmetrics, ref, before, after, metrics = _steps("float64")
    for key in ("loss", "loss_v", "loss_a"):
        np.testing.assert_allclose(float(metrics[key]), jmetrics[key],
                                   rtol=1e-6)
    for name, value in after.items():
        if "running" in name:
            _close(value, ref[name], 1e-4)
        else:
            _close(value - before[name], ref[name] - before[name], 1e-4)
    # every parameter moved
    assert all(float((after[n] - before[n]).abs().max()) > 0
               for n, _ in after.items() if "running" not in n)


def test_one_train_step_matches_jax_fp32():
    jmetrics, ref, before, after, metrics = _steps("float32")
    for key in ("loss", "loss_v", "loss_a"):
        np.testing.assert_allclose(float(metrics[key]), jmetrics[key],
                                   rtol=1e-5)
    for name, value in after.items():
        if "running" in name:
            _close(value, ref[name], 1e-4)
        elif not name.startswith("video_network."):
            _close(value - before[name], ref[name] - before[name], 2e-3)


def test_warmup_lr_matches_jax():
    for use_warmup in (True, False):
        for epoch in range(13):
            for mult, warm in ((1.0, 10), (4.0, 10), (8.0, 3), (2.0, 0)):
                assert warmup_lr(epoch, 0.1, mult, warm, use_warmup) == (
                    jax_optim.warmup_lr(epoch, 0.1, mult, warm, use_warmup))
    # the per-epoch value is the JAX optimizer's step-indexed schedule:
    # with momentum 0 and a unit gradient its update is -lr of the epoch
    tx = jax_optim.make_optimizer(0.1, 0.0, momentum=0.0, multiplier=4.0,
                                  warmup_epochs=5, batches_per_epoch=3)
    params = {"w": jnp.ones(())}
    opt_state = tx.init(params)
    for step in range(24):
        updates, opt_state = tx.update({"w": jnp.ones(())}, opt_state, params)
        np.testing.assert_allclose(-float(updates["w"]),
                                   warmup_lr(step // 3, 0.1, 4.0, 5),
                                   rtol=1e-6)
