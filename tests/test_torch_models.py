"""The port's towers and heads against the JAX package's flax modules.

The same random weights (numpy, fixed seed) go into both through
``selavi_tpu_torch.models.convert.load_jax_variables``, and the same
inputs through both, on the CPU in fp32. Tolerance: both sides run fp32
convolutions but sum in different orders, so after 18 layers outputs (and
the BN statistics of deep layers) agree to about 1e-4 relative to their
scale; a single BN layer or head stack agrees to 1e-5.
"""

import math

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from selavi_tpu.models import load_model as jax_load_model
from selavi_tpu.models.heads import HeadStack as JaxHeadStack
from selavi_tpu_torch.models.av_model import load_model
from selavi_tpu_torch.models.common import FlaxBatchNorm
from selavi_tpu_torch.models.convert import load_jax_variables
from selavi_tpu_torch.models.heads import HeadStack

torch.set_num_threads(1)

H, K = 2, 8
VIDEO = (2, 4, 32, 32, 3)
AUDIO = (2, 40, 51, 1)
RTOL = 1e-4


def _close(ours, ref, rtol=RTOL):
    ours = np.asarray(ours, np.float64)
    ref = np.asarray(ref, np.float64)
    assert ours.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-6)
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=rtol * scale)


def _random_variables(shapes, seed):
    """Numpy weights of the flax shapes: fan-in scaled kernels, non-trivial
    BN affine and running statistics."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        keys = [getattr(p, "key", None) for p in path]
        name = keys[-1]
        if name == "kernel":
            fan_in = s.shape[-2] if "heads" in keys else math.prod(s.shape[:-1])
            return rng.normal(0, math.sqrt(2.0 / fan_in), s.shape)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape)
        return rng.normal(0, 0.1, s.shape)  # bias, mean

    out = jax.tree_util.tree_map_with_path(fill, shapes)
    return jax.tree.map(lambda a: np.asarray(a, np.float32), out)


def _jax_av(seed=0, **kw):
    model = jax_load_model(headcount=H, num_classes=K, **kw)
    shapes = jax.eval_shape(
        lambda: model.init(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
            jnp.zeros(VIDEO), jnp.zeros(AUDIO), train=False,
        )
    )
    variables = _random_variables(shapes, seed)
    return model, variables["params"], variables.get("batch_stats", {})


def _port_av(params, batch_stats, **kw):
    model = load_model(headcount=H, num_classes=K, device="cpu", **kw)
    load_jax_variables(model, params, batch_stats)
    return model


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, VIDEO).astype(np.float32),
            rng.normal(0, 1, AUDIO).astype(np.float32))


@pytest.mark.parametrize("kw", [
    {"midplanes_mode": "parity"},
    {"midplanes_mode": "aligned"},
    {"aud_base_arch": "resnet18"},
    {"aud_base_arch": "resnet34"},
], ids=["parity", "aligned", "resnet18", "resnet34"])
def test_av_model_eval_matches_flax(kw):
    jmodel, params, bs = _jax_av(**kw)
    video, audio = _inputs()
    variables = {"params": params, "batch_stats": bs}
    apply = jax.jit(lambda v, x, a, f: jmodel.apply(
        v, x, a, train=False, return_features=f), static_argnums=3)
    ref_v, ref_a = apply(variables, video, audio, False)
    ref_fv, ref_fa = apply(variables, video, audio, True)

    model = _port_av(params, bs, **kw).eval()
    with torch.no_grad():
        out_v, out_a = model(torch.from_numpy(video), torch.from_numpy(audio))
        feat_v, feat_a = model(torch.from_numpy(video),
                               torch.from_numpy(audio), return_features=True)
    assert out_v.shape == (H, 2, K)
    _close(out_v, ref_v)
    _close(out_a, ref_a)
    _close(feat_v, ref_fv)
    _close(feat_a, ref_fa)


def test_av_model_train_mode_outputs_and_bn_stats_match_flax():
    """Train-mode forward (linear heads, so no dropout draw) updates the
    running statistics with flax's momentum and biased variance."""
    jmodel, params, bs = _jax_av(use_mlp=False)
    video, audio = _inputs(2)
    (ref_v, ref_a), updates = jax.jit(lambda v, x, a: jmodel.apply(
        v, x, a, train=True, mutable=["batch_stats"]))(
        {"params": params, "batch_stats": bs}, video, audio)

    model = _port_av(params, bs, use_mlp=False).train()
    with torch.no_grad():
        out_v, out_a = model(torch.from_numpy(video), torch.from_numpy(audio))
    _close(out_v, ref_v)
    _close(out_a, ref_a)

    ref_model = _port_av(params, jax.tree.map(np.asarray,
                                              updates["batch_stats"]),
                         use_mlp=False)
    ref_buffers = dict(ref_model.named_buffers())
    for name, buf in model.named_buffers():
        # statistics of activations that carry the towers' 1e-4 drift
        _close(buf, ref_buffers[name])


def test_head_stack_train_mode_matches_flax_without_dropout():
    rng = np.random.default_rng(3)
    d, hidden = 16, 12
    jheads = JaxHeadStack(headcount=H, num_classes=K, n_hidden=hidden,
                          dropout_rate=0.0)
    x = rng.normal(0, 1, (6, d)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jheads.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((6, d)), train=False))
    variables = _random_variables(shapes, 4)
    ref, updates = jheads.apply(variables, x, train=True,
                                rngs={"dropout": jax.random.PRNGKey(0)},
                                mutable=["batch_stats"])
    p = variables["params"]["heads"]
    s = variables["batch_stats"]["heads"]["bn"]
    heads = HeadStack(H, d, K, n_hidden=hidden, dropout_rate=0.0).train()
    with torch.no_grad():
        heads.hidden_weight.copy_(torch.from_numpy(p["hidden"]["kernel"]))
        heads.bn_weight.copy_(torch.from_numpy(p["bn"]["scale"]))
        heads.bn_bias.copy_(torch.from_numpy(p["bn"]["bias"]))
        heads.bn_running_mean.copy_(torch.from_numpy(s["mean"]))
        heads.bn_running_var.copy_(torch.from_numpy(s["var"]))
        heads.proj_weight.copy_(torch.from_numpy(p["proj"]["kernel"]))
        heads.proj_bias.copy_(torch.from_numpy(p["proj"]["bias"]))
        out = heads(torch.from_numpy(x))
    _close(out, ref, rtol=1e-5)
    new = updates["batch_stats"]["heads"]["bn"]
    _close(heads.bn_running_mean, new["mean"], rtol=1e-5)
    _close(heads.bn_running_var, new["var"], rtol=1e-5)


def test_batch_norm_uses_flax_momentum_and_biased_variance():
    rng = np.random.default_rng(5)
    x = rng.normal(2.0, 3.0, (4, 6, 5, 5)).astype(np.float32)  # NCHW
    bn = FlaxBatchNorm(6).train()
    out = bn(torch.from_numpy(x))
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    x_nhwc = np.transpose(x, (0, 2, 3, 1))
    variables = jbn.init(jax.random.PRNGKey(0), x_nhwc)  # mean 0, var 1
    ref, updates = jbn.apply(variables, x_nhwc, mutable=["batch_stats"])
    stats = updates["batch_stats"]
    _close(out.detach().numpy(), np.transpose(np.asarray(ref), (0, 3, 1, 2)),
           rtol=1e-5)
    _close(bn.running_mean, stats["mean"], rtol=1e-5)
    _close(bn.running_var, stats["var"], rtol=1e-5)
    # explicitly: 0.9 * 1 + 0.1 * biased variance, not the unbiased one
    biased = x.transpose(1, 0, 2, 3).reshape(6, -1).var(axis=1)
    _close(bn.running_var, 0.9 + 0.1 * biased, rtol=1e-5)


@pytest.mark.parametrize("damage", ["missing", "extra", "shape"])
def test_strict_load_rejects_mismatched_trees(damage):
    _, params, bs = _jax_av(use_mlp=False)
    params = jax.tree.map(np.copy, params)
    audio = params["audio_network"]["BasicBlock2D_0"]
    if damage == "missing":
        del audio["ConvBN_1"]["Conv_0"]
    elif damage == "extra":
        audio["ConvBN_9"] = {"Conv_0": {"kernel": np.zeros((1, 1, 64, 64),
                                                           np.float32)}}
    else:
        audio["ConvBN_1"]["Conv_0"]["kernel"] = np.zeros((3, 3, 64, 65),
                                                         np.float32)
    with pytest.raises((KeyError, ValueError)):
        _port_av(params, bs, use_mlp=False)
