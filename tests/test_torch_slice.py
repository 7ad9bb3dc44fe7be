"""The port's slice as a whole, on the CPU: the Trainer's fit() with BN
warmup, one SK re-clustering (with modality matching) and an epoch of
train steps; the epoch loss against the JAX Trainer's and the refusal of a
JAX checkpoint; plus import hygiene and the no-silent-CPU rule."""

import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import selavi_tpu_torch
from _torch_tmp import tmp_path  # noqa: F401
from selavi_tpu_torch.config import parse_arguments
from selavi_tpu_torch.data.synthetic import SyntheticAVDataset
from selavi_tpu_torch.models.av_model import load_model
from selavi_tpu_torch.ops import sinkhorn_fused
from selavi_tpu.utils.meters import AverageMeter
from selavi_tpu_torch.train import loop
from selavi_tpu_torch.train.loop import Trainer

torch.set_num_threads(1)

TINY = (
    "--ds_name synthetic --num_data_samples 16 --mlp_dim 8 --headcount 2 "
    "--epochs 1 --batch_size 4 --num_frames 4 --train_crop_size 32 "
    "--aud_sample_rate 16000 --aud_spec_type 1 --nopts 1 --match true "
    "--bn_warmup_batches 1 --workers 0 --compute_dtype float32 "
    "--sk_agg_batch 8 --base_lr 0.01 --wd 0.00001"
)


def _dataset(args):
    return SyntheticAVDataset(
        num_samples=args.num_data_samples, num_classes=4,
        num_frames=args.num_frames, crop_size=args.train_crop_size,
        aud_sample_rate=args.aud_sample_rate,
        aud_spec_type=args.aud_spec_type, seed=args.seed,
    )


def test_synthetic_example_layout():
    args = parse_arguments().parse_args(TINY.split())
    ds = _dataset(args)
    ex = ds.get_example(3, np.random.default_rng(0))
    assert ex["video"].shape == (4, 32, 32, 3) and ex["video"].dtype == np.uint8
    assert ex["audio"].shape == ds.spec_shape() == (40, 99)
    assert ex["audio"].dtype == np.float32 and np.isfinite(ex["audio"]).all()
    assert ex["index"] == 3 and ex["label"] == ds.labels[3]


def test_trainer_fit_runs_the_slice_on_cpu(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)  # fit() reads the default --dump_path "."
    args = parse_arguments().parse_args(TINY.split())
    sinkhorn_fused.reset_launches()
    trainer = Trainer(args, _dataset(args), device="cpu")
    heads_before = trainer.model.heads_a.proj_weight.detach().clone()
    history = trainer.fit()

    sk = [h for h in history if "sk_cost" in h]
    assert len(sk) == 1 and sk[0]["iteration"] == 0
    assert np.isfinite(sk[0]["sk_cost"]) and sk[0]["sk_iters_max"] < 2000
    losses = [h["loss"] for h in history if "loss" in h]
    assert losses and all(np.isfinite(losses))
    # first logged loss of the fresh heads is near ln K
    assert abs(losses[0] - np.log(8)) < 0.5
    labels = trainer.sl_state.selflabels
    assert labels.shape == (16, 2) and labels.dtype == np.int32
    assert all(len(np.unique(labels[:, h])) > 1 for h in range(2))
    # matching at the first SK step permuted the audio heads in place
    assert not torch.equal(trainer.model.heads_a.proj_weight, heads_before)
    assert sinkhorn_fused.launches == 0  # the CPU runs the plain version


def test_trainer_refuses_a_model_axis_that_does_not_divide_the_headcount():
    """JAX's ``state_shardings`` refuses it; the port names both numbers."""
    args = parse_arguments().parse_args(
        TINY.split() + ["--model_axis", "3", "--headcount", "10"])
    with pytest.raises(ValueError,
                       match="--model_axis 3 must divide --headcount 10"):
        Trainer(args, _dataset(args), device="cpu")


def _scripted_trainer(monkeypatch, losses):
    """A TINY Trainer whose train_step returns ``losses`` in turn and whose
    SK schedule never fires; records the batch size of each step."""
    args = parse_arguments().parse_args(TINY.split())
    trainer = Trainer(args, _dataset(args), device="cpu")
    script = iter(losses)
    sizes = []

    def train_step(batch, labels, gen):
        sizes.append(batch["video"].shape[0])
        return {"loss": torch.tensor(next(script))}

    monkeypatch.setattr(trainer, "train_step", train_step)
    monkeypatch.setattr(trainer, "maybe_cluster", lambda iteration: False)
    return trainer, sizes


def test_epoch_loss_is_the_jax_average_meter(monkeypatch):
    # Log every 2 iterations, so the TINY epoch's 4 steps sample 2 losses.
    monkeypatch.setattr(loop, "LOG_EVERY", 2)
    losses = [2.5, 1.25, 0.75, 3.0]
    trainer, sizes = _scripted_trainer(monkeypatch, losses)
    assert trainer.batches_per_epoch == len(losses)
    got = trainer.train_epoch(0)

    # selavi_tpu/train/loop.py::train_epoch: each loss read at the logging
    # cadence with weight batch["video"].shape[0], then the last with 1.
    meter = AverageMeter()
    for it, (loss, size) in enumerate(zip(losses, sizes)):
        if it % 2 == 0:
            meter.update(loss, size)
    meter.update(losses[-1], 1)
    assert sizes == [4] * 4
    assert got == pytest.approx(meter.avg, rel=1e-12)
    assert got != pytest.approx(losses[-1])  # not the last step's loss
    # the per-iteration history that chip_smoke.py reads
    assert [(h["iter"], h["loss"]) for h in trainer.history] == [
        (0, 2.5), (2, 0.75)]


def test_fit_refuses_a_dump_path_with_a_checkpoint(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)  # the default --dump_path is "."
    (tmp_path / loop.JAX_CKPT_NAME).write_bytes(b"")
    trainer, sizes = _scripted_trainer(monkeypatch, [1.0] * 4)
    monkeypatch.setattr(trainer, "warmup_batchnorm", lambda: sizes.append(0))
    with pytest.raises(NotImplementedError,
                       match=r"checkpoint\.msgpack.*cross-framework resume is "
                             r"out of scope.*export_torch\.py.*reference "
                             r"\.pth layout.*cli\.get_clusters "
                             r"--weights_path"):
        trainer.fit()
    assert sizes == [] and trainer.history == []  # before any training
    assert sorted(p.name for p in tmp_path.iterdir()) == [loop.JAX_CKPT_NAME]


def test_port_imports_neither_jax_nor_the_jax_package():
    modules = [m.name for m in pkgutil.walk_packages(
        selavi_tpu_torch.__path__, "selavi_tpu_torch.")]
    for name in ("ops.sinkhorn_fused", "ops.conv3x3", "ops._build",
                 "experiments.conv3x3", "cli.main", "cli.pack_dataset",
                 "data.factory", "data.transforms", "data.decoder",
                 "data.dataset", "data.packed", "ops.logmel",
                 "parallel.dist", "parallel.mesh", "train.checkpoint",
                 "train.state", "train.loop", "train.step",
                 "selflabel.engine", "models.common",
                 "train.torch_export", "utils.experiment", "utils.logger",
                 "utils.meters", "utils.profiling", "native",
                 "eval.clustering", "eval.get_clusters", "cli.get_clusters",
                 "cli.clustering_metrics", "cli.plot_distributions",
                 "eval.retrieval", "eval.finetune", "eval.finetune_runner",
                 "eval.cluster_vis", "cli.video_retrieval",
                 "cli.finetune_video", "cli.cluster_vis",
                 "train.torch_import", "train.optim", "models.convert"):
        assert f"selavi_tpu_torch.{name}" in modules
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'flax', 'optax', 'pandas', 'selavi_tpu', 'joblib',\n"
        "        'sklearn', 'cv2', 'av', 'matplotlib', 'tensorboardX')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_without_a_device_refuse_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = parse_arguments().parse_args(TINY.split())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(args, _dataset(args))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_model(headcount=1, num_classes=4)
