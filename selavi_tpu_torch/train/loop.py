"""The pretraining loop on one GPU (``selavi_tpu/train/loop.py::Trainer``).

Resume from ``{dump_path}/checkpoint.pth`` if there is one, BN warmup when
starting at epoch 0, then the epoch loop: each step trains on the current
self-labels, and on the power-law schedule ``maybe_cluster`` re-labels the
dataset with Sinkhorn-Knopp (``selflabel/engine.py::cluster``). Loss is
logged every 50 iterations, and an epoch returns the JAX Trainer's
``AverageMeter`` mean of those losses. A checkpoint follows every epoch;
SIGUSR1 or host-memory pressure writes one mid-epoch and exits 0.

Batches come from any dataset of ``data/factory.py``: spectrograms or raw
PCM (``--device_spectrogram``, or a packed shard), RGB or YUV 4:2:0 video.
Every batch goes through ``data/loader.py::decode_wire_batch`` on the
device, and the steps turn PCM into spectrograms there
(``train/step.py::prepare_audio`` with the args' ``audio_cfg``).
Multi-device meshes, process workers, data echo and the other flags in
``UNPORTED_FLAGS`` are not ported yet: a flag that asks for one of them
makes the Trainer raise rather than train something other than what the
JAX Trainer would.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from selavi_tpu_torch.data.factory import audio_cfg_from_args
from selavi_tpu_torch.data.loader import DataLoader, decode_wire_batches
from selavi_tpu_torch.device import resolve_device
from selavi_tpu_torch.models.av_model import load_model
from selavi_tpu_torch.models.resnet_audio import AUDIO_ARCHS
from selavi_tpu_torch.parallel.dist import (
    MULTI_GPU_ITEM,
    memory_pressure,
    signal_received,
)
from selavi_tpu_torch.selflabel.engine import SKConfig, cluster
from selavi_tpu_torch.selflabel.schedule import (
    fast_forward_schedule,
    make_sk_schedule,
)
from selavi_tpu_torch.train import step as steps
from selavi_tpu_torch.train.checkpoint import (
    CKPT_NAME,
    restore_checkpoint,
    save_checkpoint,
    wait_for_pending_checkpoint,
)
from selavi_tpu_torch.train.optim import make_optimizer, set_lr, warmup_lr
from selavi_tpu_torch.train.state import SelfLabelState
from selavi_tpu_torch.utils.meters import AverageMeter
from selavi_tpu_torch.utils.profiling import trace_window

logger = logging.getLogger(__name__)

LOG_EVERY = 50
# The JAX Trainer's checkpoint file in --dump_path
# (selavi_tpu/train/checkpoint.py::CKPT_NAME).
JAX_CKPT_NAME = "checkpoint.msgpack"

# Flags that the JAX Trainer, its dataset factory or its CLI read and this
# Trainer does not implement: flag -> (default, the ROADMAP Queue 1 item
# that ports it). Any other value raises NotImplementedError.
UNPORTED_FLAGS = {
    "worker_mode": ("thread", "6 (loader: process workers, data echo)"),
    "data_echo": (1, "6 (loader: process workers, data echo)"),
    "dual_data": (False, "7 (dual_data)"),
    "sk_cache_batches": (False, "9 (SK phase: cached aggregation batches)"),
    "model_axis": (1, MULTI_GPU_ITEM),
}


def refuse_unported_flags(args) -> None:
    """Raise NotImplementedError naming the first flag in ``args`` that asks
    for something this Trainer does not implement."""
    for flag, (default, item) in UNPORTED_FLAGS.items():
        value = getattr(args, flag, default)
        if value != default:
            raise NotImplementedError(
                f"--{flag} {value!r} is not implemented by the port's "
                f"Trainer (only the default {default!r}); it is ROADMAP "
                f"Queue 1 item {item}")


class Trainer:
    def __init__(self, args, dataset, device=None):
        refuse_unported_flags(args)
        self.args = args
        self.dataset = dataset
        self.device = resolve_device(device)
        self.compute_dtype = (
            torch.bfloat16
            if getattr(args, "compute_dtype", "float32") == "bfloat16"
            else torch.float32
        )
        self.model = load_model(
            vid_base_arch=args.vid_base_arch,
            aud_base_arch=args.aud_base_arch,
            use_mlp=args.use_mlp,
            num_classes=args.mlp_dim,
            headcount=args.headcount,
            midplanes_mode=("aligned"
                            if getattr(args, "tpu_aligned_midplanes", False)
                            else "parity"),
            seed=args.seed,
            device=self.device,
        )
        workers = getattr(args, "workers", 0)
        self.loader = DataLoader(
            dataset, batch_size=args.batch_size, shuffle=True, drop_last=True,
            num_workers=workers, seed=args.seed, device=self.device,
            prefetch=getattr(args, "prefetch", 2),
        )
        self.batches_per_epoch = len(self.loader)
        self.optimizer = make_optimizer(self.model, args.base_lr, args.wd)
        self.audio_cfg = audio_cfg_from_args(args)
        self.train_step = steps.make_train_step(
            self.model, self.optimizer, colorjitter=args.colorjitter,
            grayscale=args.use_grayscale, compute_dtype=self.compute_dtype,
            audio_cfg=self.audio_cfg,
        )
        n = len(dataset)
        self.sl_state = SelfLabelState.init(n, args.headcount)
        self.step = 0  # optimizer steps taken (JAX's TrainState.step)
        self.np_rng = np.random.default_rng(args.seed)
        self.step_gen = torch.Generator(device=self.device)
        self.step_gen.manual_seed(args.seed + 1)
        self.agg_gen = torch.Generator(device=self.device)
        self.agg_gen.manual_seed(args.seed + 2)
        self.sk_augment = getattr(args, "sk_augment", True)
        self.sk_cfg = SKConfig(
            headcount=args.headcount,
            num_clusters=args.mlp_dim,
            lamb=float(args.lamb),
            ind_groups=args.ind_groups,
            match=args.match,
            distribution=args.distribution,
            gauss_sd=args.gauss_sd,
            diff_dist_every=args.diff_dist_every,
            diff_dist_per_head=args.diff_dist_per_head,
            sk_backend=getattr(args, "sk_backend", "auto"),
            sk_m_bf16=getattr(args, "sk_bf16", False),
            feat_dim_a=AUDIO_ARCHS[args.aud_base_arch][2],
        )
        self.sk_schedule = make_sk_schedule(
            args.epochs, self.batches_per_epoch, args.nopts,
            args.schedulepower,
        )
        self.true_labels = getattr(dataset, "labels", None)
        self.history: list[dict] = []
        self._eval_iter_count = 0

    def resume(self) -> int:
        """Restore from ``{dump_path}/checkpoint.pth`` if it exists and
        fast-forward the SK schedule; returns the epoch to start at."""
        self.sl_state, start_epoch, self.step = restore_checkpoint(
            self.args.dump_path, self.model, self.optimizer, self.sl_state,
            self.step)
        if start_epoch != 0:
            self.sk_schedule, done = fast_forward_schedule(
                self.sk_schedule, self.batches_per_epoch, start_epoch)
            self.sl_state.sk_counter = max(self.sl_state.sk_counter, done)
            logger.info("resumed at epoch %d (%d SK steps done)", start_epoch,
                        done)
        return start_epoch

    def warmup_batchnorm(self, batches=None) -> None:
        batches = batches if batches is not None else getattr(
            self.args, "bn_warmup_batches", 20)
        if batches <= 0:
            return
        logger.info("Warming up batchnorm (%d batches)", batches)
        self.loader.set_epoch(999)
        gen = torch.Generator(device=self.device).manual_seed(999)
        for i, batch in enumerate(decode_wire_batches(self.loader)):
            if i >= batches:
                break
            steps.bn_warmup_step(
                self.model, batch["video"],
                batch.get("audio", batch.get("audio_pcm")), gen,
                self.compute_dtype, self.audio_cfg)

    def _make_eval_iter(self):
        """A fresh sequential full-dataset iterator for SK aggregation."""
        self._eval_iter_count += 1
        return decode_wire_batches(DataLoader(
            self.dataset,
            batch_size=min(getattr(self.args, "sk_agg_batch", 128),
                           max(len(self.dataset), 1)),
            shuffle=False, drop_last=False,
            num_workers=getattr(self.args, "workers", 0),
            seed=self.args.seed + 7919 + self._eval_iter_count,
            device=self.device,
        ))

    def maybe_cluster(self, iteration: int) -> bool:
        """Run SK if the schedule says so."""
        if iteration < self.sk_schedule[-1]:
            return False
        self.sk_schedule.pop()

        def encode_fn(video, audio):
            return steps.encode(
                self.model, video, audio, self.agg_gen,
                augment=self.sk_augment, colorjitter=self.args.colorjitter,
                grayscale=self.args.use_grayscale,
                compute_dtype=self.compute_dtype, audio_cfg=self.audio_cfg,
            )

        def head_logits_fn(feats, modality):
            return steps.head_logits(self.model, feats, modality,
                                     self.compute_dtype)

        labels, marginals, metrics = cluster(
            encode_fn=encode_fn,
            head_logits_fn=head_logits_fn,
            make_batch_iter=self._make_eval_iter,
            n=len(self.dataset),
            cfg=self.sk_cfg,
            selflabels=self.sl_state.selflabels,
            marginal_state=self.sl_state.marginals,
            iter_num=self.sl_state.sk_counter,
            np_rng=self.np_rng,
            device=self.device,
            audio_heads=self.model.heads_a,
            true_labels=self.true_labels,
            sk_counter=self.sl_state.sk_counter,
        )
        self.sl_state.selflabels = labels
        self.sl_state.marginals = marginals
        self.sl_state.sk_counter += 1
        self.history.append({"iteration": iteration, **metrics})
        return True

    def train_epoch(self, epoch: int) -> float:
        if self.batches_per_epoch == 0:
            raise ValueError(
                f"dataset ({len(self.dataset)} samples) is smaller than one "
                f"batch ({self.loader.batch_size}) with drop_last"
            )
        set_lr(self.optimizer, warmup_lr(
            epoch, self.args.base_lr, 1.0, self.args.warmup_epochs,
            self.args.use_warmup_scheduler,
        ))
        self.loader.set_epoch(epoch)
        losses = AverageMeter()
        batch_time = AverageMeter()
        data_time = AverageMeter()
        end = time.time()
        batches_thusfar = epoch * self.batches_per_epoch
        labels_dev = torch.from_numpy(self.sl_state.selflabels).to(self.device)
        metrics = None
        for it, batch in enumerate(decode_wire_batches(self.loader)):
            data_time.update(time.time() - end)
            if self.maybe_cluster(batches_thusfar + it):
                labels_dev = torch.from_numpy(self.sl_state.selflabels).to(
                    self.device)
            metrics = self.train_step(batch, labels_dev[batch["index"]],
                                      self.step_gen)
            self.step += 1
            # the loss is read (a host sync) only at the logging cadence
            batch_time.update(time.time() - end)
            end = time.time()
            if it % LOG_EVERY == 0:
                loss = float(metrics["loss"])
                losses.update(loss, batch["video"].shape[0])
                self.history.append({"epoch": epoch, "iter": it,
                                     "loss": loss})
                logger.info(
                    "Epoch: [%d][%d]\tTime %.3f (%.3f)\tData %.3f (%.3f)\t"
                    "Loss %.4f (%.4f)", epoch, it, batch_time.val,
                    batch_time.avg, data_time.val, data_time.avg, losses.val,
                    losses.avg)
            if signal_received() or memory_pressure():
                # mid-epoch: stamp the CURRENT epoch as the resume point so
                # the interrupted epoch re-runs in full, with its scheduled
                # SK steps
                self.checkpoint(epoch, completed=False)
                wait_for_pending_checkpoint()  # flush before exiting
                logger.warning("preemption checkpoint written; exiting")
                raise SystemExit(0)
        # the last step's loss, weight 1, as the JAX Trainer's epoch loss
        losses.update(float(metrics["loss"]), 1)
        return losses.avg

    def checkpoint(self, epoch: int, completed: bool = True) -> None:
        # one source for the resume point, shared with the file
        resume_epoch = epoch + 1 if completed else epoch
        self.sl_state.epoch = resume_epoch
        save_checkpoint(
            self.args.dump_path, self.model, self.optimizer, self.sl_state,
            epoch, step=self.step,
            checkpoint_freq=self.args.checkpoint_freq,
            total_epochs=self.args.epochs,
            dump_checkpoints=getattr(self.args, "dump_checkpoints", None),
            async_write=self.args.async_checkpoint,
            resume_epoch=resume_epoch,
        )

    def fit(self) -> list[dict]:
        """Resume, BN warmup when starting at epoch 0, then every remaining
        epoch, each followed by a checkpoint; the first one traced with
        ``--trace_profile``. A dump path that holds only the JAX Trainer's
        checkpoint is refused rather than trained over from epoch 0."""
        jax_checkpoint = os.path.join(self.args.dump_path, JAX_CKPT_NAME)
        if (os.path.exists(jax_checkpoint) and not os.path.exists(
                os.path.join(self.args.dump_path, CKPT_NAME))):
            raise NotImplementedError(
                f"{jax_checkpoint} is a JAX checkpoint, and the port cannot "
                f"resume from it: cross-framework resume is out of scope "
                f"(docs/DEVIATIONS.md item 8). Its weights alone can move: "
                f"export_torch.py writes them in the reference .pth layout, "
                f"whose import into the port is ROADMAP Queue 1 item 10 "
                f"(evaluation tools)")
        start_epoch = self.resume()
        if start_epoch == 0:
            self.warmup_batchnorm()
        for epoch in range(start_epoch, self.args.epochs):
            logger.info("============ Starting epoch %i ============", epoch)
            with trace_window(self.args.dump_path,
                              enabled=(self.args.trace_profile
                                       and epoch == start_epoch)):
                loss = self.train_epoch(epoch)
            self.checkpoint(epoch)
            self.history.append({"epoch": epoch, "loss": loss})
        wait_for_pending_checkpoint()  # flush the final async write
        return self.history
