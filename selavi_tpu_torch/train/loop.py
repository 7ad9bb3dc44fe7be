"""The pretraining loop on one GPU (``selavi_tpu/train/loop.py::Trainer``).

Resume from ``{dump_path}/checkpoint.pth`` if there is one, BN warmup when
starting at epoch 0, then the epoch loop: each step trains on the current
self-labels, and on the power-law schedule ``maybe_cluster`` re-labels the
dataset with Sinkhorn-Knopp (``selflabel/engine.py::cluster``;
``--sk_cache_batches`` keeps its first aggregation pass's device batches
for the other ``--ind_groups`` passes). Loss is logged every 50
iterations, and to a TensorBoard ``writer`` when the caller gives one
(``loss/iter``, ``batch_time/iter``, ``data_time/iter``, as the JAX
Trainer writes them; the engine adds its ``train/*`` metrics), and an
epoch returns the JAX Trainer's ``AverageMeter`` mean of those losses. A
checkpoint follows every epoch; SIGUSR1 or host-memory pressure writes one
mid-epoch and exits 0.

Batches come from any dataset of ``data/factory.py``: spectrograms or raw
PCM (``--device_spectrogram``, or a packed shard), RGB or YUV 4:2:0 video,
one clip a sample or two (``--dual_data``: the clips concatenated along
time, each augmented with its own draws, and a 2-channel audio stem).
The loader renders them on threads or spawned processes
(``--worker_mode``) and copies each batch to the card in one transfer
(``--coalesce_transfers``); every batch goes through
``data/loader.py::decode_wire_batch`` on the device, and the steps turn
PCM into spectrograms there (``train/step.py::prepare_audio`` with the
args' ``audio_cfg``). With ``--data_echo N`` each loaded batch trains N
steps, each with fresh augmentations, and the epoch, the SK schedule and
its fast-forward count N times the loader's batches. Multi-device meshes
(``UNPORTED_FLAGS``) are not ported yet: a flag that asks for one makes
the Trainer raise rather than train something other than what the JAX
Trainer would.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Iterator

import numpy as np
import torch

from selavi_tpu_torch.data.factory import audio_cfg_from_args, example_shapes
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
    REFERENCE_IMPORT_ROUTE,
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
    def __init__(self, args, dataset, device=None, writer=None):
        refuse_unported_flags(args)
        self.args = args
        self.dataset = dataset
        self.writer = writer  # a TensorBoard SummaryWriter, or None
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
            # the stem takes the example's audio channels: 2 for dual_data
            audio_channels=example_shapes(args, dataset)[1][-1],
        )
        self.loader = self._loader(
            batch_size=args.batch_size, shuffle=True, drop_last=True,
            seed=args.seed, prefetch=getattr(args, "prefetch", 2))
        # data echoing (Choi et al., arXiv:1907.05550): each loaded batch
        # trains data_echo steps, each with fresh augmentations
        self.data_echo = max(1, int(getattr(args, "data_echo", 1) or 1))
        self.batches_per_epoch = len(self.loader) * self.data_echo
        self.video_clips = 2 if getattr(args, "dual_data", False) else 1
        self.optimizer = make_optimizer(self.model, args.base_lr, args.wd)
        self.audio_cfg = audio_cfg_from_args(args)
        self.train_step = steps.make_train_step(
            self.model, self.optimizer, colorjitter=args.colorjitter,
            grayscale=args.use_grayscale, compute_dtype=self.compute_dtype,
            audio_cfg=self.audio_cfg, video_clips=self.video_clips,
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
            cache_group_batches=getattr(args, "sk_cache_batches", False),
            feat_dim_a=AUDIO_ARCHS[args.aud_base_arch][2],
        )
        self.sk_schedule = make_sk_schedule(
            args.epochs, self.batches_per_epoch, args.nopts,
            args.schedulepower,
        )
        self.true_labels = getattr(dataset, "labels", None)
        self.history: list[dict] = []
        self._eval_iter_count = 0

    def _loader(self, **kwargs) -> DataLoader:
        """A loader of the dataset on the Trainer's device, with the args'
        workers, worker mode and transfer mode."""
        return DataLoader(
            self.dataset, num_workers=getattr(self.args, "workers", 0),
            device=self.device,
            worker_mode=getattr(self.args, "worker_mode", "thread"),
            coalesce=getattr(self.args, "coalesce_transfers", True),
            **kwargs)

    def _device_batches(self, echo: bool = True) -> Iterator[dict]:
        """The train loader's batches on the device, each ``data_echo``
        times in a row; ``echo=False`` yields each once (BN warmup wants
        unique batches, not replays)."""
        batches = decode_wire_batches(self.loader)
        if self.data_echo == 1 or not echo:
            return batches
        return (b for b in batches for _ in range(self.data_echo))

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
        for i, batch in enumerate(self._device_batches(echo=False)):
            if i >= batches:
                break
            steps.bn_warmup_step(
                self.model, batch["video"],
                batch.get("audio", batch.get("audio_pcm")), gen,
                self.compute_dtype, self.audio_cfg, self.video_clips)

    def _make_eval_iter(self) -> Iterator[dict]:
        """A fresh sequential full-dataset iterator for SK aggregation; its
        worker processes, if any, stop when it ends."""
        self._eval_iter_count += 1
        loader = self._loader(
            batch_size=min(getattr(self.args, "sk_agg_batch", 128),
                           max(len(self.dataset), 1)),
            shuffle=False, drop_last=False,
            seed=self.args.seed + 7919 + self._eval_iter_count)
        try:
            yield from decode_wire_batches(loader)
        finally:
            loader.close()

    def sk_encode(self, video, audio):
        """The SK aggregation's pooled features of one batch: eval mode,
        with the train-time augmentations drawn from ``agg_gen``."""
        return steps.encode(
            self.model, video, audio, self.agg_gen,
            augment=self.sk_augment, colorjitter=self.args.colorjitter,
            grayscale=self.args.use_grayscale,
            compute_dtype=self.compute_dtype, audio_cfg=self.audio_cfg,
            video_clips=self.video_clips,
        )

    def maybe_cluster(self, iteration: int) -> bool:
        """Run SK if the schedule says so."""
        if iteration < self.sk_schedule[-1]:
            return False
        self.sk_schedule.pop()

        def head_logits_fn(feats, modality):
            return steps.head_logits(self.model, feats, modality,
                                     self.compute_dtype)

        labels, marginals, metrics = cluster(
            encode_fn=self.sk_encode,
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
            writer=self.writer,
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
        for it, batch in enumerate(self._device_batches()):
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
                if self.writer is not None:
                    iteration = batches_thusfar + it
                    self.writer.add_scalar("loss/iter", loss, iteration)
                    self.writer.add_scalar("batch_time/iter", batch_time.avg,
                                           iteration)
                    self.writer.add_scalar("data_time/iter", data_time.avg,
                                           iteration)
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
                f"{REFERENCE_IMPORT_ROUTE}")
        start_epoch = self.resume()
        try:
            if start_epoch == 0:
                self.warmup_batchnorm()
            for epoch in range(start_epoch, self.args.epochs):
                logger.info("============ Starting epoch %i ============",
                            epoch)
                with trace_window(self.args.dump_path,
                                  enabled=(self.args.trace_profile
                                           and epoch == start_epoch)):
                    loss = self.train_epoch(epoch)
                self.checkpoint(epoch)
                self.history.append({"epoch": epoch, "loss": loss})
        finally:
            self.loader.close()  # the worker processes, if any
        wait_for_pending_checkpoint()  # flush the final async write
        return self.history
