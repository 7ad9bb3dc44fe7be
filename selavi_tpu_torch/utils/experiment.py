"""Experiment bootstrap (``selavi_tpu/utils/experiment.py``): dump the
params, create the checkpoint directory, the logger and the stats file.

The rank is ``params.rank`` (``parallel/dist.py::init_distributed_mode``
records it; 0 without one): rank 0 dumps ``params.pkl`` and logs to
``train.log``, rank r to ``train.log-{r}``, and each rank keeps
``stats{r}.pkl``.
"""

from __future__ import annotations

import os
import pickle
from pathlib import Path

import numpy as np
import torch

from selavi_tpu_torch.utils.logger import PDStats, create_logger


def initialize_exp(params, *stat_columns, dump_params: bool = True):
    """Returns (logger, PDStats). ``params`` is any object with a
    ``dump_path`` attribute (an argparse Namespace)."""
    rank = getattr(params, "rank", 0)
    dump_path = Path(params.dump_path)
    dump_path.mkdir(parents=True, exist_ok=True)

    if dump_params and rank == 0:
        with open(dump_path / "params.pkl", "wb") as f:
            pickle.dump(params, f)

    params.dump_checkpoints = str(dump_path / "checkpoints")
    os.makedirs(params.dump_checkpoints, exist_ok=True)

    training_stats = PDStats(
        str(dump_path / f"stats{rank}.pkl"), list(stat_columns)
    )
    logger = create_logger(str(dump_path / "train.log"), rank=rank)
    logger.info("============ Initialized logger ============")
    logger.info(
        "\n".join(
            "%s: %s" % (k, str(v))
            for k, v in sorted(dict(vars(params)).items())
        )
    )
    logger.info("The experiment will be stored in %s\n" % params.dump_path)
    return logger, training_stats


def fix_random_seeds(seed: int = 31) -> np.random.Generator:
    """Seeds numpy's and torch's global generators; returns a numpy
    Generator. The Trainer draws from its own explicit generators."""
    np.random.seed(seed)
    torch.manual_seed(seed)
    return np.random.default_rng(seed)
