"""The port's pretraining CLI and what it sets up, on the CPU, against the
JAX package's counterparts where there is one:

* ``cli/main.py``: the files a run writes, resume on a second call, a
  SIGUSR1 at a fixed step of epoch 1 (exit 0, resume at epoch 1, no BN
  warmup and no SK step on the resumed run), and the refusal of the CPU
  without an explicit request;
* ``parallel/dist.py``: the signal flag and the host-RSS watchdog
  (``tests/test_preemption.py``'s checks), one process only;
* ``utils/{logger,meters}.py``: the log line layout, ``AverageMeter`` and
  the stats rows against JAX's;
* ``utils/profiling.py::trace_window`` writes a trace on the CPU.
"""

import json
import logging
import os
import pickle
import re
import shutil
import signal

import pytest
import torch

from selavi_tpu.utils.logger import PDStats as JaxPDStats
from selavi_tpu.utils.logger import create_logger as jax_create_logger
from selavi_tpu.utils.meters import AverageMeter as JaxAverageMeter
from selavi_tpu_torch.cli import main as cli_main
from selavi_tpu_torch.parallel import dist
from selavi_tpu_torch.train.checkpoint import CKPT_NAME
from selavi_tpu_torch.train.loop import Trainer
from selavi_tpu_torch.utils.logger import PDStats, create_logger
from selavi_tpu_torch.utils.meters import AverageMeter
from selavi_tpu_torch.utils.profiling import TRACE_NAME, trace_window

torch.set_num_threads(1)

TINY = (
    "--ds_name synthetic --num_data_samples 16 --mlp_dim 8 --headcount 2 "
    "--epochs 1 --batch_size 4 --num_frames 4 --train_crop_size 32 "
    "--aud_sample_rate 16000 --aud_spec_type 1 --nopts 1 --match true "
    "--bn_warmup_batches 1 --workers 0 --compute_dtype float32 "
    "--sk_agg_batch 8 --base_lr 0.01 --wd 0.00001"
)


@pytest.fixture(autouse=True)
def _process_state(tmp_path):
    """The CLI installs signal handlers and replaces the root logger's
    handlers: put both back after each test, and delete its checkpoints
    (~300 MB each: the towers have their full widths)."""
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
    dist.init_memory_watchdog(0)
    shutil.rmtree(tmp_path, ignore_errors=True)


def _argv(dump, extra=""):
    return TINY.split() + extra.split() + ["--dump_path", str(dump)]


def _load(path):
    return torch.load(path, weights_only=True)


def _stats_rows(dump):
    with open(dump / "stats0.pkl", "rb") as f:
        saved = pickle.load(f)
    assert saved["columns"] == ["epoch", "loss"]
    return saved["rows"]


# -------------------------------------------------------------- the CLI

def test_cli_trains_writes_and_resumes(tmp_path):
    dump = tmp_path / "run"
    history = cli_main.main(_argv(dump), device="cpu")
    epochs = [h for h in history if "epoch" in h and "iter" not in h]
    assert [h["epoch"] for h in epochs] == [0]
    assert any("sk_cost" in h for h in history)
    for name in ("params.pkl", "train.log", "stats0.pkl", CKPT_NAME,
                 "checkpoints/ckp-0.pth"):
        assert (dump / name).is_file(), name
    assert _stats_rows(dump) == [[0, epochs[0]["loss"]]]
    assert _load(dump / CKPT_NAME)["epoch"] == 1
    with open(dump / "params.pkl", "rb") as f:
        params = pickle.load(f)
    assert (params.rank, params.world_size) == (0, 1)
    log = (dump / "train.log").read_text()
    assert "Loaded data with 16 videos." in log
    assert re.search(r"Epoch: \[0\]\[0\]\tTime [\d.]+ \([\d.]+\)\tData "
                     r"[\d.]+ \([\d.]+\)\tLoss [\d.]+ \([\d.]+\)", log)

    # the same command again: resumes after the last epoch, trains none
    again = cli_main.main(_argv(dump), device="cpu")
    assert again == []
    assert _stats_rows(dump) == [[0, epochs[0]["loss"]]]
    assert "resumed at epoch 1 (1 SK steps done)" in (
        dump / "train.log").read_text()


def test_cli_is_preempted_and_resumes(tmp_path, monkeypatch):
    dump = tmp_path / "run"
    warmups = []

    class Preempted(Trainer):
        """SIGUSR1 right after the second train step of epoch 1."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            inner, calls = self.train_step, []

            def train_step(*a):
                out = inner(*a)
                calls.append(1)
                if len(calls) == self.batches_per_epoch + 2:
                    os.kill(os.getpid(), signal.SIGUSR1)
                return out

            self.train_step = train_step

        def warmup_batchnorm(self, batches=None):
            warmups.append(1)
            super().warmup_batchnorm(batches)

    monkeypatch.setattr(cli_main, "Trainer", Preempted)
    with pytest.raises(SystemExit) as exit_info:
        cli_main.main(_argv(dump, "--epochs 2"), device="cpu")
    assert exit_info.value.code == 0
    saved = _load(dump / CKPT_NAME)
    # stamped with the interrupted epoch, after 4 + 2 steps
    assert (saved["epoch"], saved["step"], saved["sk_counter"]) == (1, 6, 1)
    assert sorted(os.listdir(dump / "checkpoints")) == ["ckp-0.pth"]
    assert not (dump / "stats0.pkl").exists()  # no epoch finished here
    assert warmups == [1]

    class Resumed(Trainer):
        def warmup_batchnorm(self, batches=None):
            warmups.append(2)
            super().warmup_batchnorm(batches)

    monkeypatch.setattr(cli_main, "Trainer", Resumed)
    history = cli_main.main(_argv(dump, "--epochs 2"), device="cpu")
    assert warmups == [1]  # no BN warmup on resume
    assert not any("sk_cost" in h for h in history)  # no SK step
    assert [h["epoch"] for h in history if "iter" not in h] == [1]
    saved = _load(dump / CKPT_NAME)
    # epoch 1 re-ran in full from the preempted state, as in JAX
    assert (saved["epoch"], saved["step"]) == (2, 10)
    assert sorted(os.listdir(dump / "checkpoints")) == ["ckp-0.pth",
                                                        "ckp-1.pth"]
    assert [row[0] for row in _stats_rows(dump)] == [1]


def test_cli_refuses_the_cpu_without_a_request(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_main.main(_argv(tmp_path / "run"))
    assert not (tmp_path / "run").exists()  # before anything is written


def test_cli_refuses_datasets_it_does_not_have(tmp_path):
    argv = _argv(tmp_path / "run") + ["--ds_name", "packed"]
    with pytest.raises(NotImplementedError,
                       match="'packed'.*ROADMAP Queue 1 item 2"):
        cli_main.main(argv, device="cpu")


# -------------------------------------------------- signals and watchdog

def test_signal_flag_roundtrip():
    dist.init_signal_handler()
    assert not dist.signal_received()
    os.kill(os.getpid(), signal.SIGUSR1)
    assert dist.signal_received()
    # SIGTERM is ignored, not fatal, and does not set the flag
    dist.init_signal_handler()
    os.kill(os.getpid(), signal.SIGTERM)
    assert not dist.signal_received()


def test_memory_watchdog_trips_preemption_path():
    dist.init_signal_handler()
    dist.init_memory_watchdog(0)  # disabled
    assert dist.memory_pressure() is False

    rss = dist.host_rss_bytes()
    assert rss > 10_000_000  # this test process is well above 10 MB

    dist.init_memory_watchdog((rss + 10e9) / 1e9)  # above current
    assert dist.memory_pressure() is False
    assert dist.signal_received() is False

    dist.init_memory_watchdog(0.001)  # 1 MB: below current RSS
    assert dist.memory_pressure() is True
    assert dist.signal_received() is True  # preemption path armed


def test_one_process_only(monkeypatch):
    class Args:
        pass

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    args = Args()
    assert dist.init_distributed_mode(args) == (0, 1)
    assert (args.rank, args.world_size) == (0, 1)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 11"):
        dist.init_distributed_mode(Args())


# ------------------------------------------------ logger, meter and stats

_STAMP = re.compile(r" - \S+ \S+ - \d+:\d\d:\d\d - ")


def test_log_lines_have_the_jax_layout(tmp_path):
    lines = {}
    for side, make in (("jax", jax_create_logger), ("port", create_logger)):
        path = tmp_path / f"{side}.log"
        log = make(str(path), rank=0)
        log.info("epoch %d\nsecond line", 3)
        log.debug("debug only in the file")
        for h in log.handlers:
            h.flush()
        lines[side] = path.read_text().splitlines()
    assert [_STAMP.sub(" - T - ", line) for line in lines["port"]] == [
        _STAMP.sub(" - T - ", line) for line in lines["jax"]] == [
        "INFO - T - epoch 3", "    second line",
        "DEBUG - T - debug only in the file"]


def test_average_meter_matches_jax():
    ours, ref = AverageMeter(), JaxAverageMeter()
    for val, n in ((2.5, 4), (1.25, 4), (0.75, 3), (3.0, 1)):
        ours.update(val, n)
        ref.update(val, n)
        assert (ours.val, ours.avg, ours.sum, ours.count) == (
            ref.val, ref.avg, ref.sum, ref.count)


def test_stats_rows_match_jax_dataframe(tmp_path):
    rows = [[0, 2.25], [1, 1.5], [2, 0.875]]
    ours = PDStats(str(tmp_path / "ours.pkl"), ["epoch", "loss"])
    ref = JaxPDStats(str(tmp_path / "ref.pkl"), ["epoch", "loss"])
    for row in rows[:2]:
        ours.update(row)
        ref.update(row)
    # a resumed run appends to the saved rows
    ours = PDStats(str(tmp_path / "ours.pkl"), ["epoch", "loss"])
    ref = JaxPDStats(str(tmp_path / "ref.pkl"), ["epoch", "loss"])
    ours.update(rows[2])
    ref.update(rows[2])
    assert ours.columns == list(ref.stats.columns)
    assert ours.rows == ref.stats.values.tolist() == rows
    with open(tmp_path / "ours.pkl", "rb") as f:
        assert pickle.load(f) == {"columns": ["epoch", "loss"], "rows": rows}
    with pytest.raises(ValueError, match="columns"):
        PDStats(str(tmp_path / "ours.pkl"), ["epoch", "accuracy"])


# --------------------------------------------------------------- trace

def test_trace_window_writes_a_trace_on_cpu(tmp_path):
    a = torch.randn(64, 64)
    with trace_window(str(tmp_path)):
        (a @ a).sum()
    with open(tmp_path / "profile" / TRACE_NAME) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    with trace_window(str(tmp_path / "off"), enabled=False):
        pass
    assert not (tmp_path / "off").exists()
    assert os.listdir(tmp_path / "profile") == [TRACE_NAME]
