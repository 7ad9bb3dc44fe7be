"""The port's resnet50 audio tower (Bottleneck blocks, 2048-d features)
against the JAX package's flax tower, its export to the reference layout
against the JAX exporter's, and the Trainer's SK step on its 2048-d
features.

The same random weights (numpy, fixed seed) go into both packages through
``models/convert.py::load_jax_variables``, on the CPU: eval mode in fp32,
train mode in fp64 (see its test). Tolerance as
``tests/test_torch_models.py``: 1e-4 of the output's scale (sums in
another order through 50 layers). The export is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_tmp import tmp_path  # noqa: F401
from selavi_tpu.train.torch_export import (
    export_reference_state_dict as jax_export_reference_state_dict,
)
from selavi_tpu_torch.config import parse_arguments
from selavi_tpu_torch.models.resnet_audio import AudioResNet, Bottleneck2D
from selavi_tpu_torch.selflabel.marginals import MarginalState
from selavi_tpu_torch.train import checkpoint, torch_export
from selavi_tpu_torch.train.loop import Trainer
from selavi_tpu_torch.train.state import SelfLabelState
from test_torch_models import H, K, _close, _inputs, _jax_av, _port_av
from test_torch_slice import TINY, _dataset

torch.set_num_threads(1)

ARCH = {"aud_base_arch": "resnet50"}


def test_resnet50_tower_layout():
    tower = AudioResNet("resnet50", torch.Generator().manual_seed(0))
    assert len(tower.blocks) == 16 and tower.feature_dim == 2048
    assert all(isinstance(b, Bottleneck2D) for b in tower.blocks)
    # the first block of each stage projects (width or stride change);
    # the others keep their input
    projects = [b.downsample is not None for b in tower.blocks]
    assert projects == [i in (0, 3, 7, 13) for i in range(16)]
    assert tower.blocks[-1].conv3.conv.weight.shape == (2048, 512, 1, 1)


def test_resnet50_eval_matches_flax():
    jmodel, params, bs = _jax_av(**ARCH)
    video, audio = _inputs()
    variables = {"params": params, "batch_stats": bs}
    apply = jax.jit(lambda v, x, a, f: jmodel.apply(
        v, x, a, train=False, return_features=f), static_argnums=3)
    ref_v, ref_a = apply(variables, video, audio, False)
    _, ref_fa = apply(variables, video, audio, True)

    model = _port_av(params, bs, **ARCH).eval()
    with torch.no_grad():
        out_v, out_a = model(torch.from_numpy(video), torch.from_numpy(audio))
        _, feat_a = model(torch.from_numpy(video), torch.from_numpy(audio),
                          return_features=True)
    assert feat_a.shape == (2, 2048) and out_a.shape == (H, 2, K)
    _close(feat_a, ref_fa)
    _close(out_a, ref_a)
    _close(out_v, ref_v)


def test_resnet50_train_mode_outputs_and_bn_stats_match_flax():
    """Train-mode forward (linear heads, so no dropout draw): outputs and
    every running statistic after the flax-momentum update, both packages
    in fp64. In fp32 the flax tower's own train-mode output lies 1.0-1.6e-4
    of its scale from its fp64 result on spectrograms of 2x40x51 to
    8x40x99 (the port's: 3-6e-5), beyond the 1e-4 tolerance, so the
    comparison is made in fp64, as ``tests/test_torch_step.py`` holds the
    video tower's gradient."""
    video, audio = _inputs(2)
    with jax.enable_x64(True):
        jmodel, params, bs = _jax_av(use_mlp=False, dtype=jnp.float64,
                                     **ARCH)
        variables = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                 {"params": params, "batch_stats": bs})
        (ref_v, ref_a), updates = jax.jit(lambda v, x, a: jmodel.apply(
            v, x, a, train=True, mutable=["batch_stats"]))(
            variables, video.astype(np.float64), audio.astype(np.float64))
        new_bs = jax.tree.map(np.asarray, updates["batch_stats"])

    model = _port_av(params, bs, use_mlp=False, **ARCH).double().train()
    with torch.no_grad():
        out_v, out_a = model(torch.from_numpy(video).double(),
                             torch.from_numpy(audio).double())
    _close(out_a, ref_a)
    _close(out_v, ref_v)
    ref_model = _port_av(params, new_bs, use_mlp=False, **ARCH)
    ref_buffers = dict(ref_model.named_buffers())
    for name, buf in model.audio_network.named_buffers():
        _close(buf, ref_buffers[f"audio_network.{name}"])


@pytest.mark.parametrize("use_mlp", [True, False])
def test_resnet50_export_matches_jax_exporter(tmp_path, use_mlp):
    """A port checkpoint of a resnet50 model, exported by the port's CLI
    module (which reads the architecture off the file), against the JAX
    exporter on the same flax trees: the same keys in the same order, the
    same values."""
    _, params, bs = _jax_av(seed=3, use_mlp=use_mlp, **ARCH)
    model = _port_av(params, bs, use_mlp=use_mlp, **ARCH)
    optimizer = torch.optim.SGD(model.parameters(), lr=0.1)
    labels = np.zeros((4, H), np.int32)
    checkpoint.save_checkpoint(str(tmp_path), model, optimizer,
                               SelfLabelState(labels, MarginalState(), 0), 0)
    out = str(tmp_path / "reference.pth.tar")
    torch_export.main([str(tmp_path / checkpoint.CKPT_NAME), out])
    got = torch.load(out, weights_only=True)["model"]

    ref = jax_export_reference_state_dict(params, bs, H, use_mlp=use_mlp,
                                          audio_stage_blocks=(3, 4, 6, 3))
    assert list(got) == list(ref)
    assert "module.audio_network.base.layer4.2.conv3.weight" in got
    for key, value in ref.items():
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)


def test_trainer_clusters_resnet50_features(monkeypatch, tmp_path):
    """The Trainer with the resnet50 tower: one epoch with an SK step at
    iteration 0 (matching included) over 2048-d audio features."""
    monkeypatch.chdir(tmp_path)
    args = parse_arguments().parse_args(
        TINY.split() + ["--aud_base_arch", "resnet50"])
    trainer = Trainer(args, _dataset(args), device="cpu")
    assert trainer.model.audio_network.feature_dim == 2048
    assert trainer.model.heads_a.hidden_weight.shape[1] == 2048
    history = trainer.fit()
    sk = [h for h in history if "sk_cost" in h]
    assert len(sk) == 1 and np.isfinite(sk[0]["sk_cost"])
    losses = [h["loss"] for h in history if "loss" in h]
    assert losses and np.isfinite(losses).all()
    labels = trainer.sl_state.selflabels
    assert all(len(np.unique(labels[:, h])) > 1 for h in range(2))
