"""Finetune orchestration: the pretrained tower, the epoch loop and the
folds (``selavi_tpu/eval/finetune_runner.py``).

``run_fold`` trains and evaluates one fold and keeps
``{output_dir}/checkpoints/checkpoint_fold{fold}.pth`` (the model's state,
the optimizer's state, the optimizer steps taken and ``epoch + 1``);
``--resume`` continues from it, at the LR of the step it stopped at. The
train step draws its flips and dropout masks from a generator seeded with
the epoch, so a resumed run continues as the uninterrupted run would.

Under a process group (``parallel/dist.py``) the fold's loaders are
rank-strided (``--batch_size`` per process), the model trains under
``DistributedDataParallel`` with BatchNorm over the global batch and the
global batch's flips and dropout masks, ``evaluate`` gathers every rank's
rows, and rank 0 writes the checkpoints.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from selavi_tpu_torch.data.loader import DataLoader, decode_wire_batches
from selavi_tpu_torch.device import DeviceLike, resolve_device
from selavi_tpu_torch.eval.finetune import (
    NUM_CLASSES,
    FinetuneConfig,
    FinetuneModel,
    evaluate,
    lr_factor_table,
    make_finetune_optimizer,
    make_finetune_steps,
    set_finetune_lr,
)
from selavi_tpu_torch.parallel import mesh
from selavi_tpu_torch.parallel.dist import sync_hosts
from selavi_tpu_torch.utils.meters import AverageMeter, topk_accuracy

logger = logging.getLogger(__name__)

TOWER_PREFIX = "video_network."
LOG_EVERY = 50


def load_pretrained_tower(model: FinetuneModel, ckpt_path: str
                          ) -> FinetuneModel:
    """Copy a port checkpoint's (``checkpoint.pth`` or ``ckp-*.pth``) video
    tower, weights and BN statistics, into ``model.base``, key for key.
    Raises before any tensor is copied when the keys or shapes differ."""
    payload = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    state = payload.get("model") if isinstance(payload, dict) else None
    if not isinstance(state, dict):
        raise ValueError(f"{ckpt_path} is no port checkpoint (no 'model')")
    tower = {k[len(TOWER_PREFIX):]: v for k, v in state.items()
             if k.startswith(TOWER_PREFIX)}
    target = model.base.state_dict()
    missing = sorted(set(target) - set(tower))
    unexpected = sorted(set(tower) - set(target))
    shapes = sorted(k for k in set(target) & set(tower)
                    if tuple(target[k].shape) != tuple(tower[k].shape))
    if missing or unexpected or shapes:
        raise ValueError(
            f"{ckpt_path}: the video tower does not fit the finetune model "
            f"(--tpu_aligned_midplanes?): missing {missing[:5]}, unexpected "
            f"{unexpected[:5]}, shapes differ {shapes[:5]}")
    model.base.load_state_dict(tower)
    return model


def finetune_config(args) -> FinetuneConfig:
    return FinetuneConfig(
        num_classes=NUM_CLASSES.get(args.dataset,
                                    getattr(args, "num_classes", 101)),
        head_lr=args.head_lr,
        base_lr=args.base_lr,
        weight_decay=args.weight_decay,
        wd_base=args.wd_base,
        momentum=args.momentum,
        optim_name=args.optim_name,
        feature_extract=args.feature_extract,
        use_dropout=args.use_dropout,
        use_bn=args.use_bn,
        use_l2_norm=args.use_l2_norm,
        lr_warmup_epochs=args.lr_warmup_epochs,
        lr_milestones=tuple(
            int(m) for m in str(args.lr_milestones).split(",")),
        lr_gamma=args.lr_gamma,
        use_scheduler=args.use_scheduler,
        epochs=args.epochs,
    )


def build_datasets(args, fold: int):
    """(train, test) of the fold: the synthetic set has 4 classes at crop
    64; a real one is cropped at 128 (``--augtype 1``) or 224, without
    audio, its test split ``num_spatial_crops x val_clips_per_video``
    views a video."""
    if args.dataset == "synthetic":
        from selavi_tpu_torch.data.synthetic import SyntheticAVDataset

        n = getattr(args, "num_data_samples", None) or 32
        return (SyntheticAVDataset(num_samples=n, num_frames=args.clip_len,
                                   crop_size=64, num_classes=4, mode="train"),
                SyntheticAVDataset(num_samples=n, num_frames=args.clip_len,
                                   crop_size=64, num_classes=4, mode="test",
                                   seed=1))
    from selavi_tpu_torch.data.dataset import AVideoDataset

    crop = 128 if args.augtype == 1 else 224
    common = dict(ds_name=args.dataset, root_dir=args.root_dir,
                  num_frames=args.clip_len, sample_rate=args.steps_bet_clips,
                  fold=fold, decode_audio=False,
                  path_to_data_dir=args.data_path)
    train = AVideoDataset(mode="train",
                          num_train_clips=args.train_clips_per_video,
                          train_crop_size=crop, colorjitter=args.colorjitter,
                          **common)
    test = AVideoDataset(mode="test", test_crop_size=crop,
                         num_spatial_crops=args.num_spatial_crops,
                         num_ensemble_views=args.val_clips_per_video,
                         **common)
    return train, test


def build_model(cfg: FinetuneConfig, args, device) -> FinetuneModel:
    """The finetune model with its initial weights, on ``device``."""
    model = FinetuneModel(
        cfg.num_classes, use_dropout=cfg.use_dropout, use_bn=cfg.use_bn,
        use_l2_norm=cfg.use_l2_norm,
        midplanes_mode="aligned" if getattr(
            args, "tpu_aligned_midplanes", False) else "parity",
        generator=torch.Generator().manual_seed(0))
    return model.to(device)


def run_fold(args, fold: int, writer=None, dataset=None, dataset_test=None,
             device: DeviceLike = None) -> tuple[float, float, int]:
    """Train and evaluate one fold; returns (best video acc@1, its acc@5,
    its epoch), or the test split's accuracies and the start epoch with
    ``--test_only``."""
    if (args.dataset not in NUM_CLASSES and args.dataset != "synthetic"
            and not hasattr(args, "num_classes")):
        raise ValueError(
            f"finetune class count unknown for dataset '{args.dataset}' "
            f"(known: {sorted(NUM_CLASSES)}); pass a dataset with a "
            "defined class count")
    device = resolve_device(device)
    cfg = finetune_config(args)
    if dataset is None:
        dataset, dataset_test = build_datasets(args, fold)
        if args.dataset == "synthetic":
            cfg.num_classes = 4
    model = build_model(cfg, args, device)
    compute_dtype = (torch.bfloat16 if getattr(
        args, "compute_dtype", "float32") == "bfloat16" else torch.float32)
    if args.weights_path and args.weights_path != "None":
        logger.info("loading pretrained tower from %s", args.weights_path)
        load_pretrained_tower(model, args.weights_path)

    rank, world_size, _ = mesh.world()
    loader = DataLoader(dataset, batch_size=args.batch_size, shuffle=True,
                        drop_last=True, num_workers=args.workers, seed=0,
                        device=device, rank=rank, world_size=world_size)
    loader_test = DataLoader(dataset_test, batch_size=args.batch_size,
                             shuffle=False, drop_last=False,
                             num_workers=args.workers, device=device,
                             rank=rank, world_size=world_size)
    try:
        return _train_fold(args, fold, cfg, model, loader, loader_test,
                           compute_dtype, device, writer)
    finally:
        loader.close()
        loader_test.close()


def _train_fold(args, fold, cfg, model, loader, loader_test, compute_dtype,
                device, writer) -> tuple[float, float, int]:
    optimizer = make_finetune_optimizer(cfg, model)
    table = lr_factor_table(cfg)
    rank, world_size, group = mesh.world()
    train_model = model if group is None else mesh.data_parallel(model,
                                                                 device)
    train_step, _, eval_step = make_finetune_steps(
        model, optimizer, compute_dtype, train_model=train_model,
        shard=(rank, world_size))
    bpe = len(loader)

    ckpt_path = None
    start_epoch, step = 0, 0
    if getattr(args, "output_dir", None):
        ckpt_dir = os.path.join(args.output_dir, "checkpoints")
        os.makedirs(ckpt_dir, exist_ok=True)
        ckpt_path = os.path.join(ckpt_dir, f"checkpoint_fold{fold}.pth")
        if getattr(args, "resume", "") and os.path.isfile(ckpt_path):
            blob = torch.load(ckpt_path, map_location=device,
                              weights_only=True)
            model.load_state_dict(blob["model"])
            optimizer.load_state_dict(blob["optimizer"])
            start_epoch, step = int(blob["epoch"]), int(blob["step"])
            logger.info("resumed finetune fold %d at epoch %d", fold,
                        start_epoch)

    def run_eval(epoch):
        return evaluate(eval_step, decode_wire_batches(loader_test),
                        writer=writer, epoch=epoch, ds=args.dataset)

    if getattr(args, "test_only", False):
        _, vid1, vid5 = run_eval(start_epoch)
        return vid1, vid5, start_epoch

    best1, best5, best_epoch = -1.0, -1.0, 0
    for epoch in range(start_epoch, args.epochs):
        loader.set_epoch(epoch)
        generator = torch.Generator(device=device).manual_seed(epoch)
        losses, top1 = AverageMeter(), AverageMeter()
        for it, batch in enumerate(decode_wire_batches(loader)):
            set_finetune_lr(optimizer, table, step, bpe)
            loss, logits = train_step(batch["video"], batch["label"],
                                      generator)
            step += 1
            # read the loss only at the logging cadence: a read every step
            # would wait for the card every step
            if it % LOG_EVERY == 0:
                labels = batch["label"].cpu().numpy()
                losses.update(float(loss), len(labels))
                acc1, _ = topk_accuracy(logits.float().cpu().numpy(), labels,
                                        (1, 5))
                top1.update(acc1, len(labels))
                logger.info("Epoch[%d] Iter %d/%d Loss %.4f (%.4f) Prec %.3f",
                            epoch, it, bpe, losses.val, losses.avg, top1.avg)
        _, vid1, vid5 = run_eval(epoch)
        if vid1 > best1:
            best1, best5, best_epoch = vid1, vid5, epoch
        if ckpt_path is not None:
            if rank == 0:
                tmp = ckpt_path + ".tmp"
                torch.save({"model": model.state_dict(),
                            "optimizer": optimizer.state_dict(),
                            "step": step, "epoch": epoch + 1}, tmp)
                os.replace(tmp, ckpt_path)
            sync_hosts()
    return best1, best5, best_epoch


def run_folds(args, writer=None, device: DeviceLike = None,
              **dataset_kw) -> dict:
    """Every fold of ``--fold`` (comma-separated); the per-fold and mean
    video accuracies and the best epochs."""
    folds = [int(f) for f in str(args.fold).split(",")]
    accs1, accs5, epochs = [], [], []
    for fold in folds:
        a1, a5, be = run_fold(args, fold, writer=writer, device=device,
                              **dataset_kw)
        accs1.append(a1)
        accs5.append(a5)
        epochs.append(be)
        logger.info("fold %d: vid acc@1 %.3f acc@5 %.3f", fold, a1, a5)
    result = {
        "folds": folds,
        "acc1": accs1,
        "acc5": accs5,
        "avg_acc1": float(np.mean(accs1)),
        "avg_acc5": float(np.mean(accs5)),
        "best_epochs": epochs,
    }
    logger.info("%d-Fold (%s): Vid Acc@1 %.3f, Vid Acc@5 %.3f", len(folds),
                args.dataset, result["avg_acc1"], result["avg_acc5"])
    return result
