"""Single-file checkpoints with the whole SeLaVi state
(``selavi_tpu/train/checkpoint.py``).

``{dump_path}/checkpoint.pth``, written by ``torch.save``, holds the JAX
checkpoint's fields: ``epoch`` (the epoch to resume at), ``selflabels``
([N, H] int32), ``dist`` (the cached marginals, ``{"dists": [H, K]
float64 or None}``), ``sk_counter``, ``step`` (optimizer steps taken),
``model`` (the port's ``state_dict``) and ``optimizer``
(``optimizer.state_dict()``). Every value is a tensor or a plain Python
value, so ``torch.load(..., weights_only=True)`` reads it. A completed
epoch is archived as ``{dump_checkpoints}/ckp-{epoch}.pth`` every
``checkpoint_freq`` epochs and at the last.

Unlike JAX arrays, the model's and the optimizer's tensors change in place
at the next step, so ``save_checkpoint`` copies every tensor to host
memory before it returns; only ``torch.save`` and the disk write may run
on the background thread.
"""

from __future__ import annotations

import concurrent.futures as cf
import logging
import os
import shutil
import threading
import time
from typing import Optional

import numpy as np
import torch

from selavi_tpu_torch.selflabel.marginals import MarginalState
from selavi_tpu_torch.train.state import SelfLabelState

logger = logging.getLogger(__name__)

CKPT_NAME = "checkpoint.pth"

# One writer thread (started at the first async save), at most one write in
# flight; its Future re-raises a failed write at the next wait.
_writer = cf.ThreadPoolExecutor(1, thread_name_prefix="ckpt-write")
_pending_lock = threading.Lock()
_pending_write: Optional[cf.Future] = None

# One record per save since reset_timings(): the seconds save_checkpoint
# held its caller ("hold_s") and, once written, the seconds torch.save and
# the archive copy took ("write_s") and the file's size ("bytes").
timings: list[dict] = []


def reset_timings() -> None:
    timings.clear()


def wait_for_pending_checkpoint():
    """Wait for the in-flight async write, if any; re-raise its error.
    Call before process exit (preemption) and before reading a
    just-written checkpoint."""
    with _pending_lock:
        pending = _pending_write
    if pending is not None:
        pending.result()


def _to_host(obj):
    """A copy of ``obj`` with every tensor copied to host memory."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def save_checkpoint(
    dump_path: str,
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    sl_state: SelfLabelState,
    epoch: int,
    step: int = 0,
    checkpoint_freq: int = 5,
    total_epochs: Optional[int] = None,
    dump_checkpoints: Optional[str] = None,
    async_write: bool = False,
    resume_epoch: Optional[int] = None,
):
    """Write the checkpoint, atomically (``.tmp``, then ``os.replace``).

    With ``async_write`` only serialization and the disk write run on the
    background thread, over the host copy taken here; at most one write is
    in flight."""
    global _pending_write
    t0 = time.perf_counter()
    if resume_epoch is None:
        resume_epoch = epoch + 1  # epoch completed
    dists = sl_state.marginals.dists
    payload = {
        # resume_epoch == epoch (mid-epoch preemption): restart AT this
        # epoch so its remaining batches and scheduled SK steps re-run
        "epoch": int(resume_epoch),
        "selflabels": torch.from_numpy(
            np.array(sl_state.selflabels, np.int32, copy=True)),
        "dist": {"dists": None if dists is None else torch.from_numpy(
            np.array(dists, np.float64, copy=True))},
        "sk_counter": int(sl_state.sk_counter),
        "step": int(step),
        "model": _to_host(model.state_dict()),
        "optimizer": _to_host(optimizer.state_dict()),
    }
    record = {"epoch": epoch}
    timings.append(record)

    def _write():
        t = time.perf_counter()
        os.makedirs(dump_path, exist_ok=True)
        path = os.path.join(dump_path, CKPT_NAME)
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        if dump_checkpoints and resume_epoch > epoch and (
            epoch % checkpoint_freq == 0
            or (total_epochs is not None and epoch == total_epochs - 1)
        ):
            shutil.copyfile(
                path, os.path.join(dump_checkpoints, f"ckp-{epoch}.pth"))
        record["bytes"] = os.path.getsize(path)
        record["write_s"] = time.perf_counter() - t
        logger.info("checkpoint (resume epoch %d) written to %s: %d bytes "
                    "in %.3f s", resume_epoch, path, record["bytes"],
                    record["write_s"])

    wait_for_pending_checkpoint()  # at most one write in flight
    if async_write:
        with _pending_lock:
            _pending_write = _writer.submit(_write)
    else:
        _write()
    record["hold_s"] = time.perf_counter() - t0


def restore_checkpoint(
    dump_path: str,
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    sl_state: SelfLabelState,
    step: int = 0,
) -> tuple[SelfLabelState, int, int]:
    """Load the model and optimizer in place from ``{dump_path}/
    checkpoint.pth`` (or from ``dump_path`` itself when it ends in
    ``.pth``). Returns (sl_state, start_epoch, step); ``sl_state``, 0 and
    ``step`` unchanged when there is no file."""
    wait_for_pending_checkpoint()
    path = (dump_path if dump_path.endswith(".pth")
            else os.path.join(dump_path, CKPT_NAME))
    if not os.path.isfile(path):
        return sl_state, 0, step
    logger.info("Found checkpoint at %s", path)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(payload["model"])
    optimizer.load_state_dict(payload["optimizer"])
    dists = payload["dist"]["dists"]
    sl_state = SelfLabelState(
        selflabels=payload["selflabels"].numpy().astype(np.int32),
        marginals=MarginalState(
            dists=None if dists is None else dists.numpy().astype(np.float64)),
        sk_counter=int(payload["sk_counter"]),
        epoch=int(payload["epoch"]),
    )
    return sl_state, int(payload["epoch"]), int(payload["step"])


# Where the weights of a JAX run (or the reference's own) enter the port.
REFERENCE_IMPORT_ROUTE = (
    "export_torch.py writes them in the reference .pth layout, which "
    "cli.get_clusters --weights_path imports (train/torch_import.py)")


def load_model_parameters(model: torch.nn.Module, ckpt_path: str):
    """Eval-tool loader: the model's weights and BN statistics only, from a
    port ``checkpoint.pth`` or ``ckp-*.pth``. A JAX ``*.msgpack`` or a
    reference-layout ``.pth`` (no ``model`` entry holding the model's keys)
    raises ``NotImplementedError`` before any tensor is copied; the latter
    goes through ``train/torch_import.py`` instead."""
    refusal = (
        f"{ckpt_path} holds no port state_dict of this model's "
        f"architecture (a JAX checkpoint or a reference-layout .pth?). The "
        f"weights of a JAX run move as follows: {REFERENCE_IMPORT_ROUTE}")
    if ckpt_path.endswith(".msgpack"):
        raise NotImplementedError(refusal)
    payload = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    state = payload.get("model") if isinstance(payload, dict) else None
    if not isinstance(state, dict) or set(state) != set(model.state_dict()):
        raise NotImplementedError(refusal)
    model.load_state_dict(state)
    return model
