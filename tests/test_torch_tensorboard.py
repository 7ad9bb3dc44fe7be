"""TensorBoard events of the port against the JAX package's, on the CPU.

A recording writer (``add_scalar`` / ``add_histogram`` logging ``(tag,
step)``) goes to the JAX Trainer and to the port's on the same TINY run:
16 synthetic samples, 2 epochs of 2 steps (the JAX batch is 1 a device on
the 8-device CPU mesh, the port's 8), one SK step at iteration 0 with
``sk_counter`` at 9, so that the engine's every-10th-step histograms are
written. The writers must see the same tags at the same steps, in the same
order; the port's only extra tags are its SK iteration counts. Then the
port's CLI writes an event file where tensorboardX imports, and none, with
no error, where it does not.
"""

import logging
import shutil
import signal
import sys

import numpy as np
import pytest
import torch

from selavi_tpu.config import parse_arguments as jax_parse_arguments
from selavi_tpu.data.synthetic import SyntheticAVDataset as JaxSynthetic
from selavi_tpu.train.loop import Trainer as JaxTrainer
from selavi_tpu_torch.cli import main as cli_main
from selavi_tpu_torch.config import parse_arguments
from selavi_tpu_torch.data.synthetic import SyntheticAVDataset
from selavi_tpu_torch.parallel import dist
from selavi_tpu_torch.train.loop import Trainer

torch.set_num_threads(1)

RUN = (
    "--ds_name synthetic --num_data_samples 16 --mlp_dim 8 --headcount 2 "
    "--epochs 2 --num_frames 4 --train_crop_size 32 --aud_sample_rate 16000 "
    "--aud_spec_type 1 --nopts 1 --match true --bn_warmup_batches 1 "
    "--workers 0 --compute_dtype float32 --base_lr 0.01 --wd 0.00001"
)
# The tags only the port writes: its SK metrics' iteration counts.
PORT_ONLY = {"train/sk_iters_max", "train/sk_iters_total"}


class RecordingWriter:
    def __init__(self):
        self.events = []

    def add_scalar(self, tag, value, step):
        assert np.isfinite(float(value)), tag
        self.events.append((tag, step))

    def add_histogram(self, tag, values, step):
        assert np.asarray(values).ndim == 1, tag
        self.events.append((tag, step))


def _dataset(cls, args):
    return cls(num_samples=16, num_classes=4, num_frames=4, crop_size=32,
               aud_sample_rate=16000, aud_spec_type=1, seed=args.seed)


def _events(trainer_cls, args, dataset, **kw):
    writer = RecordingWriter()
    trainer = trainer_cls(args, dataset, writer=writer, **kw)
    trainer.sl_state.sk_counter = 9  # this SK step writes the histograms
    trainer.fit()
    return writer.events


def test_trainers_write_the_same_tags_at_the_same_steps(tmp_path):
    jargs = jax_parse_arguments().parse_args(
        RUN.split() + ["--batch_size", "1", "--sk_agg_batch", "1",
                       "--dump_path", str(tmp_path / "jax")])
    jax_events = _events(JaxTrainer, jargs, _dataset(JaxSynthetic, jargs))
    args = parse_arguments().parse_args(
        RUN.split() + ["--batch_size", "8", "--sk_agg_batch", "8",
                       "--dump_path", str(tmp_path / "port")])
    events = _events(Trainer, args, _dataset(SyntheticAVDataset, args),
                     device="cpu")

    assert {tag for tag, _ in events} - {tag for tag, _ in jax_events} \
        == PORT_ONLY
    assert [e for e in events if e[0] not in PORT_ONLY] == jax_events
    assert ("train/entropies", 9) in events
    assert ("train/anmi_vs_gt", 9) in events
    assert [s for tag, s in events if tag == "loss/iter"] == [0, 2]


@pytest.fixture
def restore_process_state():
    """The CLI installs signal handlers and log handlers: put them back."""
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    usr1 = signal.getsignal(signal.SIGUSR1)
    term = signal.getsignal(signal.SIGTERM)
    yield
    for h in root.handlers:
        if h not in handlers:
            h.close()
    root.handlers[:] = handlers
    root.setLevel(level)
    signal.signal(signal.SIGUSR1, usr1)
    signal.signal(signal.SIGTERM, term)
    dist._SIGNAL_FLAG["received"] = False


@pytest.mark.parametrize("tensorboardx", [True, False])
def test_cli_writes_events_where_tensorboardx_imports(
        tmp_path, monkeypatch, restore_process_state, tensorboardx):
    if not tensorboardx:
        monkeypatch.setitem(sys.modules, "tensorboardX", None)
    dump = tmp_path / "run"
    history = cli_main.main(
        RUN.split() + ["--epochs", "1", "--batch_size", "8",
                       "--sk_agg_batch", "8", "--dump_path", str(dump)],
        device="cpu")
    assert any("sk_cost" in h for h in history)
    files = sorted(dump.glob("events.out.tfevents.*"))
    assert len(files) == int(tensorboardx)
    if tensorboardx:
        from tensorboard.backend.event_processing.event_accumulator import (
            EventAccumulator,
        )

        acc = EventAccumulator(str(dump))
        acc.Reload()
        assert {"loss/iter", "train/sk_cost", "train/nmi_vs_gt",
                "train/anmi_vs_gt"} <= set(acc.Tags()["scalars"])
        assert [e.step for e in acc.Scalars("loss/iter")] == [0]
    shutil.rmtree(dump, ignore_errors=True)
