"""The pretraining loop on one GPU (``selavi_tpu/train/loop.py::Trainer``).

BN warmup, then the epoch loop: each step trains on the current
self-labels, and on the power-law schedule ``maybe_cluster`` re-labels the
dataset with Sinkhorn-Knopp (``selflabel/engine.py::cluster``). Loss is
logged every 50 iterations, and an epoch returns the JAX Trainer's
``AverageMeter`` mean of those losses. Checkpoints, resume, preemption, the
host-RSS watchdog, multi-device meshes and data echo are not ported yet: a
flag that asks for one of them (``UNPORTED_FLAGS``) makes the Trainer raise
rather than train something other than what the JAX Trainer would, and
``fit`` refuses a dump path that holds a checkpoint the JAX Trainer would
resume from.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from selavi_tpu_torch.data.loader import DataLoader
from selavi_tpu_torch.device import resolve_device
from selavi_tpu_torch.models.av_model import load_model
from selavi_tpu_torch.models.resnet_audio import AUDIO_ARCHS
from selavi_tpu_torch.selflabel.engine import SKConfig, cluster
from selavi_tpu_torch.selflabel.marginals import MarginalState
from selavi_tpu_torch.selflabel.schedule import make_sk_schedule
from selavi_tpu_torch.train import step as steps
from selavi_tpu_torch.train.optim import make_optimizer, set_lr, warmup_lr

logger = logging.getLogger(__name__)

LOG_EVERY = 50
# The JAX Trainer's checkpoint file in --dump_path
# (selavi_tpu/train/checkpoint.py::CKPT_NAME).
CKPT_NAME = "checkpoint.msgpack"
CHECKPOINT_ITEM = "1 (checkpoints, resume and CLI)"

# Flags that the JAX Trainer, its dataset factory or its CLI read and this
# Trainer does not implement: flag -> (default, the ROADMAP Queue 1 item
# that ports it). Any other value raises NotImplementedError.
UNPORTED_FLAGS = {
    "device_spectrogram": (False, "5 (device audio frontend)"),
    "worker_mode": ("thread", "6 (loader: wire format, process workers, "
                              "data echo)"),
    "data_echo": (1, "6 (loader: wire format, process workers, data echo)"),
    "dual_data": (False, "7 (dual_data)"),
    "resume": (False, CHECKPOINT_ITEM),
    "checkpoint_freq": (5, CHECKPOINT_ITEM),
    "async_checkpoint": (True, CHECKPOINT_ITEM),
    "dump_path": (".", CHECKPOINT_ITEM),
    "max_host_mem_gb": (0, CHECKPOINT_ITEM),
    "trace_profile": (False, CHECKPOINT_ITEM),
    "sk_cache_batches": (False, "9 (SK phase: cached aggregation batches)"),
    "model_axis": (1, "11 (multi-GPU)"),
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
        self.train_step = steps.make_train_step(
            self.model, self.optimizer, colorjitter=args.colorjitter,
            grayscale=args.use_grayscale, compute_dtype=self.compute_dtype,
        )
        n = len(dataset)
        self.selflabels = np.zeros((n, args.headcount), np.int32)
        self.marginals = MarginalState()
        self.sk_counter = 0
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

    def warmup_batchnorm(self, batches=None) -> None:
        batches = batches if batches is not None else getattr(
            self.args, "bn_warmup_batches", 20)
        if batches <= 0:
            return
        logger.info("Warming up batchnorm (%d batches)", batches)
        self.loader.set_epoch(999)
        gen = torch.Generator(device=self.device).manual_seed(999)
        for i, batch in enumerate(self.loader):
            if i >= batches:
                break
            steps.bn_warmup_step(self.model, batch["video"], batch["audio"],
                                 gen, self.compute_dtype)

    def _make_eval_iter(self):
        """A fresh sequential full-dataset iterator for SK aggregation."""
        self._eval_iter_count += 1
        return iter(DataLoader(
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
                compute_dtype=self.compute_dtype,
            )

        def head_logits_fn(feats, modality):
            return steps.head_logits(self.model, feats, modality,
                                     self.compute_dtype)

        labels, self.marginals, metrics = cluster(
            encode_fn=encode_fn,
            head_logits_fn=head_logits_fn,
            make_batch_iter=self._make_eval_iter,
            n=len(self.dataset),
            cfg=self.sk_cfg,
            selflabels=self.selflabels,
            marginal_state=self.marginals,
            iter_num=self.sk_counter,
            np_rng=self.np_rng,
            device=self.device,
            audio_heads=self.model.heads_a,
            true_labels=self.true_labels,
            sk_counter=self.sk_counter,
        )
        self.selflabels = labels
        self.sk_counter += 1
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
        batches_thusfar = epoch * self.batches_per_epoch
        labels_dev = torch.from_numpy(self.selflabels).to(self.device)
        end = time.time()
        metrics = None
        # The JAX Trainer's epoch loss: an AverageMeter over the losses read
        # at the LOG_EVERY cadence, each weighted by its batch, and the last
        # step's loss with weight 1.
        loss_sum, loss_weight = 0.0, 0
        for it, batch in enumerate(self.loader):
            if self.maybe_cluster(batches_thusfar + it):
                labels_dev = torch.from_numpy(self.selflabels).to(self.device)
            metrics = self.train_step(batch, labels_dev[batch["index"]],
                                      self.step_gen)
            if it % LOG_EVERY == 0:
                loss = float(metrics["loss"])  # syncs only at this cadence
                loss_sum += loss * batch["video"].shape[0]
                loss_weight += batch["video"].shape[0]
                self.history.append({"epoch": epoch, "iter": it,
                                     "loss": loss})
                logger.info("Epoch: [%d][%d]\tTime %.3f\tLoss %.4f", epoch,
                            it, time.time() - end, loss)
                end = time.time()
        loss_sum += float(metrics["loss"])
        loss_weight += 1
        return loss_sum / loss_weight

    def fit(self) -> list[dict]:
        """BN warmup, then every epoch. The JAX Trainer resumes from
        ``{dump_path}/checkpoint.msgpack`` and writes one after each epoch;
        this one does neither, so it raises rather than restart from epoch
        0 over a checkpoint that the JAX Trainer would resume from."""
        checkpoint = os.path.join(self.args.dump_path, CKPT_NAME)
        if os.path.exists(checkpoint):
            raise NotImplementedError(
                f"{checkpoint} exists: the JAX Trainer would resume from it, "
                f"and the port's Trainer does not implement resuming (ROADMAP "
                f"Queue 1 item {CHECKPOINT_ITEM})")
        logger.warning(
            "the port's Trainer writes no checkpoint (the JAX Trainer writes "
            "%s after every epoch; ROADMAP Queue 1 item %s)", checkpoint,
            CHECKPOINT_ITEM)
        self.warmup_batchnorm()
        for epoch in range(self.args.epochs):
            logger.info("============ Starting epoch %i ============", epoch)
            loss = self.train_epoch(epoch)
            self.history.append({"epoch": epoch, "loss": loss})
        return self.history
