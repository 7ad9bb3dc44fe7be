"""The pretraining loop (``selavi_tpu/train/loop.py::Trainer``), on one GPU
or data-parallel over the ranks of a process group, one GPU each.

Resume from ``{dump_path}/checkpoint.pth`` if there is one, BN warmup when
starting at epoch 0, then the epoch loop: each step trains on the current
self-labels, and on the power-law schedule ``maybe_cluster`` re-labels the
dataset with Sinkhorn-Knopp (``selflabel/engine.py::cluster``;
``--sk_cache_batches`` keeps its first aggregation pass's device batches
for the other ``--ind_groups`` passes). Loss is logged every 50
iterations, and to a TensorBoard ``writer`` when the caller gives one
(``loss/iter``, ``batch_time/iter``, ``data_time/iter``, as the JAX
Trainer writes them; the engine adds its ``train/*`` metrics), and an
epoch returns the JAX Trainer's ``AverageMeter`` mean of those losses.
The batch and data times are the seconds of the spans ``trainer.step``
(label gather and train step) and ``trainer.data`` (the next device
batch), which a profiler also records (``utils/profiling.py``; the
second into ``totals`` alone, not the trace). A
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
its fast-forward count N times the loader's batches.

Under a process group (``parallel/dist.py``) the Trainer computes what the
JAX Trainer computes on a data mesh of one device a rank: each rank loads
``--batch_size`` samples a step from its stride of the epoch's order (and
``--sk_agg_batch`` for the SK aggregation), the model runs under
``DistributedDataParallel`` with BatchNorm over the global batch, the
augmentations and dropout masks are the global batch's draws, the LR warms
up to a multiplier of the world size, every rank holds the same SK labels
(rank 0's, ``selflabel/engine.py``), rank 0 writes the checkpoints and the
ranks agree on a preemption exit (``dist.StopVote``).

With ``--model_axis M`` the ranks form JAX's ``('data', 'model')`` grid
(``mesh.make_grid``; ``M`` must divide the world size and the headcount)
and the head stacks are split over its model axis, as JAX's
``state_shardings`` splits them: a rank holds, optimizes and checkpoints
``H / M`` heads, runs them on its data row's gathered features, and
solves their SK problems. The towers stay as at ``M = 1`` (each rank
computes them on its own rows), and every number equals ``M = 1``'s on
the same ranks; the checkpoint file is ``M = 1``'s, so a run resumes
under any ``M``.
"""

from __future__ import annotations

import itertools
import logging
import os
from typing import Iterator

import numpy as np
import torch

from selavi_tpu_torch.data.factory import audio_cfg_from_args, example_shapes
from selavi_tpu_torch.data.loader import DataLoader, decode_wire_batches
from selavi_tpu_torch.device import resolve_device
from selavi_tpu_torch.models.av_model import load_model
from selavi_tpu_torch.parallel import mesh
from selavi_tpu_torch.parallel.dist import StopVote, sync_hosts
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
from selavi_tpu_torch.utils.profiling import span, trace_window

logger = logging.getLogger(__name__)

LOG_EVERY = 50
# The JAX Trainer's checkpoint file in --dump_path
# (selavi_tpu/train/checkpoint.py::CKPT_NAME).
JAX_CKPT_NAME = "checkpoint.msgpack"

class Trainer:
    def __init__(self, args, dataset, device=None, writer=None):
        self.args = args
        self.dataset = dataset
        self.writer = writer  # a TensorBoard SummaryWriter, or None
        self.device = resolve_device(device)
        self.compute_dtype = (
            torch.bfloat16
            if getattr(args, "compute_dtype", "float32") == "bfloat16"
            else torch.float32
        )
        # None in one process; raises unless M divides world and headcount
        self.grid = mesh.make_grid(getattr(args, "model_axis", 1),
                                   args.headcount)
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
            grid=self.grid,
            num_frames=args.num_frames,
            crop_size=args.train_crop_size,
        )
        self.rank, self.world_size, _ = mesh.world()
        self.shard = (self.rank, self.world_size)
        # the model's forward in the train step
        self.net = self.model
        if self.grid is not None:
            self.net = mesh.grid_parallel(self.model, self.grid, self.device)
            logger.info("data parallel: rank %d of %d, backend %s, %s with "
                        "global BatchNorm", self.rank, self.world_size,
                        torch.distributed.get_backend(),
                        type(self.net).__name__)
            first, count = self.grid.heads(args.headcount)
            logger.info("grid [%d, %d]: data row %d, model column %d, heads "
                        "%d-%d of %d", self.grid.data_size,
                        self.grid.model_size, self.grid.data_index,
                        self.grid.model_index, first, first + count - 1,
                        args.headcount)
        # --batch_size per process: the JAX Trainer's batch_size *
        # n_devices // n_proc with one device a process
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
            self.net, self.optimizer, colorjitter=args.colorjitter,
            grayscale=args.use_grayscale, compute_dtype=self.compute_dtype,
            audio_cfg=self.audio_cfg, video_clips=self.video_clips,
            shard=self.shard, grid=self.grid,
        )
        self.stop_vote = StopVote()
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
        )
        self.sk_schedule = make_sk_schedule(
            args.epochs, self.batches_per_epoch, args.nopts,
            args.schedulepower,
        )
        self.true_labels = getattr(dataset, "labels", None)
        self.history: list[dict] = []
        self._eval_iter_count = 0

    def _loader(self, **kwargs) -> DataLoader:
        """A loader of this rank's stride of the dataset on the Trainer's
        device, with the args' workers, worker mode and transfer mode."""
        return DataLoader(
            self.dataset, num_workers=getattr(self.args, "workers", 0),
            device=self.device, rank=self.rank, world_size=self.world_size,
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
                self.compute_dtype, self.audio_cfg, self.video_clips,
                self.shard)

    def _make_eval_iter(self) -> Iterator[dict]:
        """A fresh sequential iterator over this rank's stride of the
        dataset for SK aggregation (``--sk_agg_batch`` per process); its
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
            video_clips=self.video_clips, shard=self.shard,
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
            grid=self.grid,
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
                f"global batch ({self.loader.batch_size} per process x "
                f"{self.world_size} processes with drop_last)"
            )
        self.loader.set_epoch(epoch)
        losses = AverageMeter()
        batch_time = AverageMeter()  # trainer.step's seconds
        data_time = AverageMeter()  # trainer.data's seconds
        batches_thusfar = epoch * self.batches_per_epoch
        labels_dev = torch.from_numpy(self.sl_state.selflabels).to(self.device)
        metrics = None
        batches = self._device_batches()
        for it in itertools.count():
            # kept out of the trace: a caller's loader may stop its
            # profiler inside next() (utils/profiling.py)
            with span("trainer.data", annotate=False) as data:
                batch = next(batches, None)
            if batch is None:
                break
            data_time.update(data.seconds)
            if self.maybe_cluster(batches_thusfar + it):
                labels_dev = torch.from_numpy(self.sl_state.selflabels).to(
                    self.device)
            # the JAX schedule, indexed by the optimizer step: right after
            # a mid-epoch resume too
            set_lr(self.optimizer, warmup_lr(
                self.step // self.batches_per_epoch, self.args.base_lr,
                float(self.world_size), self.args.warmup_epochs,
                self.args.use_warmup_scheduler))
            with span("trainer.step") as step:
                metrics = self.train_step(batch, labels_dev[batch["index"]],
                                          self.step_gen)
            self.step += 1
            # the loss is read (a host sync; the mean over the ranks) only
            # at the logging cadence
            batch_time.update(step.seconds)
            if it % LOG_EVERY == 0:
                loss = self._global_loss(metrics["loss"])
                # weighted by the global batch, as the JAX Trainer's
                losses.update(loss, batch["video"].shape[0] * self.world_size)
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
            if self.stop_vote.poll():
                # mid-epoch: stamp the CURRENT epoch as the resume point so
                # the interrupted epoch re-runs in full, with its scheduled
                # SK steps
                self.checkpoint(epoch, completed=False)
                wait_for_pending_checkpoint()  # flush before exiting
                sync_hosts()  # no rank exits before rank 0's file is whole
                logger.warning("preemption checkpoint written; exiting")
                raise SystemExit(0)
        # the last step's loss, weight 1, as the JAX Trainer's epoch loss
        losses.update(self._global_loss(metrics["loss"]), 1)
        return losses.avg

    def _global_loss(self, loss: torch.Tensor) -> float:
        """The global batch's loss from this rank's (a host sync)."""
        return float(loss if self.grid is None else self.grid.loss(loss))

    def checkpoint(self, epoch: int, completed: bool = True) -> None:
        """Rank 0 writes the inner module's state (the file of a one-GPU
        run, every head gathered by data row 0); then the ranks meet."""
        # one source for the resume point, shared with the file
        resume_epoch = epoch + 1 if completed else epoch
        self.sl_state.epoch = resume_epoch
        if self.grid is None or self.grid.data_index == 0:
            save_checkpoint(
                self.args.dump_path, self.model, self.optimizer,
                self.sl_state, epoch, step=self.step,
                checkpoint_freq=self.args.checkpoint_freq,
                total_epochs=self.args.epochs,
                dump_checkpoints=getattr(self.args, "dump_checkpoints", None),
                async_write=self.args.async_checkpoint,
                resume_epoch=resume_epoch, grid=self.grid,
            )
        sync_hosts()

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
        # each rank its own trace: rank r > 0 under {dump_path}/rank{r}
        trace_dir = (self.args.dump_path if self.rank == 0 else
                     os.path.join(self.args.dump_path, f"rank{self.rank}"))
        try:
            if start_epoch == 0:
                self.warmup_batchnorm()
            for epoch in range(start_epoch, self.args.epochs):
                logger.info("============ Starting epoch %i ============",
                            epoch)
                with trace_window(trace_dir,
                                  enabled=(self.args.trace_profile
                                           and epoch == start_epoch)):
                    loss = self.train_epoch(epoch)
                self.checkpoint(epoch)
                self.history.append({"epoch": epoch, "loss": loss})
        finally:
            self.loader.close()  # the worker processes, if any
        self.stop_vote.drain()  # the last step's vote: the run is done
        wait_for_pending_checkpoint()  # flush the final async write
        return self.history
