"""Pretraining entry point (``selavi_tpu/cli/main.py``): the JAX command
line, run by the port's Trainer on one card,

    python -m selavi_tpu_torch.cli.main --ds_name synthetic --mlp_dim 309 \
        --headcount 10 ... --dump_path runs/x

or data-parallel on N cards of a host, one process each, with
``--batch_size`` and ``--sk_agg_batch`` per process:

    torchrun --nproc_per_node N -m selavi_tpu_torch.cli.main ...

Running the same command again resumes from ``{dump_path}/checkpoint.pth``
(after a preemption: at the interrupted epoch). Where tensorboardX imports,
rank 0 also writes TensorBoard events into ``{dump_path}``; without it the
run goes on with no writer, as the JAX CLI does.
"""

from __future__ import annotations

from selavi_tpu_torch.config import parse_arguments
from selavi_tpu_torch.data.factory import build_dataset
from selavi_tpu_torch.device import resolve_device
from selavi_tpu_torch.parallel.dist import (
    distributed,
    init_memory_watchdog,
    init_signal_handler,
)
from selavi_tpu_torch.train.loop import Trainer
from selavi_tpu_torch.utils.experiment import fix_random_seeds, initialize_exp


def main(argv=None, device=None):
    """Train on the card, or on ``device`` when the caller names one (the
    tests pass ``device="cpu"``, and gloo is then the group's backend).
    Returns the Trainer's history."""
    parser = parse_arguments()
    args = parser.parse_args(argv)
    with distributed(args, device) as (rank, _):
        return _train(args, rank, resolve_device(device))


def _train(args, rank, device):
    init_signal_handler()
    if args.max_host_mem_gb:
        init_memory_watchdog(args.max_host_mem_gb)
    fix_random_seeds(args.seed)
    logger, training_stats = initialize_exp(args, "epoch", "loss")

    writer = None
    if rank == 0:
        try:
            from tensorboardX import SummaryWriter

            writer = SummaryWriter(args.dump_path)
        except ImportError:
            pass

    dataset = build_dataset(args)
    logger.info("Loaded data with %d videos.", len(dataset))

    trainer = Trainer(args, dataset, device=device, writer=writer)
    logger.info("Device %s, batch %d", trainer.device,
                trainer.loader.batch_size)
    try:
        history = trainer.fit()
    finally:
        if writer is not None:
            writer.close()
    # one row per epoch: the Trainer also records the logged iterations
    for rec in history:
        if "epoch" in rec and "iter" not in rec:
            training_stats.update([rec["epoch"], rec["loss"]])
    return history


if __name__ == "__main__":
    main()
