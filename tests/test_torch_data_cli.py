"""The port's CLI on the datasets it now reads, on the CPU: a packed
yuv420/int16 shard written by ``python -m selavi_tpu_torch.cli.pack_dataset``,
the synthetic set with ``--device_spectrogram true``, and cv2-encoded real
media (``scripts/make_real_media.py``) as ``--ds_name folder`` and
``kinetics``. Each run trains one epoch with BN warmup and an SK step; the
PCM runs resume for a second epoch. The audio tower's input is recorded:
on the PCM paths it is the device frontend's ``[B, 40, 99, 1]`` fp32
spectrogram.
"""

import logging
import os
import shutil
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_tmp import tmp_path  # noqa: F401
from selavi_tpu_torch.cli import main as cli_main
from selavi_tpu_torch.cli import pack_dataset
from selavi_tpu_torch.parallel import dist
from selavi_tpu_torch.train.checkpoint import CKPT_NAME
from selavi_tpu_torch.train.loop import Trainer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = (
    "--mlp_dim 8 --headcount 2 --batch_size 4 --num_frames 4 "
    "--train_crop_size 32 --aud_sample_rate 16000 --aud_spec_type 1 "
    "--nopts 1 --match true --bn_warmup_batches 1 --workers 0 "
    "--compute_dtype float32 --sk_agg_batch 8 --base_lr 0.01 --wd 0.00001"
)


@pytest.fixture(autouse=True)
def _process_state(tmp_path):
    """Put back the log handlers and signal handlers the CLI installs, and
    delete its checkpoints (~300 MB each)."""
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
    shutil.rmtree(tmp_path, ignore_errors=True)


def _run(monkeypatch, argv):
    """The CLI on the CPU; returns (history, the audio tower's inputs)."""
    fed = []

    class Recorded(Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.model.audio_network.register_forward_pre_hook(
                lambda mod, inp: fed.append((tuple(inp[0].shape),
                                             inp[0].dtype)))

    monkeypatch.setattr(cli_main, "Trainer", Recorded)
    return cli_main.main(argv, device="cpu"), fed


def _epochs(history):
    return [h["epoch"] for h in history if "epoch" in h and "iter" not in h]


def _train_and_resume(monkeypatch, dump, argv):
    history, fed = _run(monkeypatch, argv + ["--epochs", "1",
                                             "--dump_path", str(dump)])
    assert _epochs(history) == [0]
    sk = [h for h in history if "sk_cost" in h]
    assert len(sk) == 1 and np.isfinite(sk[0]["sk_cost"])
    assert all(np.isfinite(h["loss"]) for h in history if "loss" in h)
    assert torch.load(dump / CKPT_NAME, weights_only=True)["epoch"] == 1
    again, fed2 = _run(monkeypatch, argv + ["--epochs", "2",
                                            "--dump_path", str(dump)])
    assert _epochs(again) == [1]
    assert not any("sk_cost" in h for h in again)
    assert "resumed at epoch 1 (1 SK steps done)" in (
        dump / "train.log").read_text()
    return fed + fed2


def test_cli_trains_and_resumes_on_a_packed_yuv_int16_shard(tmp_path,
                                                             monkeypatch,
                                                             capsys):
    shard = tmp_path / "s.pack"
    meta = pack_dataset.main(
        ("--ds_name synthetic --num_data_samples 16 --num_frames 4 "
         "--train_crop_size 40 --aud_sample_rate 16000 --aud_spec_type 1 "
         "--mlp_dim 8 --pack_video_format yuv420 --pack_pcm_dtype int16 "
         f"--output {shard}").split())
    assert meta["video_shape"] == [4, 40, 40, 3] and meta["pcm_len"] == 16000
    fed = _train_and_resume(monkeypatch, tmp_path / "run",
                            TINY.split() + ["--ds_name", "packed",
                                            "--root_dir", str(shard)])
    # warmup, aggregation (batch 8, then the tail) and train steps: the
    # card's frontend fed every one
    assert fed and all(dtype == torch.float32 and shape[1:] == (40, 99, 1)
                       for shape, dtype in fed)
    assert (4, 40, 99, 1) in [shape for shape, _ in fed]


def test_cli_trains_and_resumes_with_device_spectrogram(tmp_path,
                                                         monkeypatch):
    fed = _train_and_resume(
        monkeypatch, tmp_path / "run",
        TINY.split() + ["--ds_name", "synthetic", "--num_data_samples", "16",
                        "--device_spectrogram", "true"])
    assert fed and all(shape[1:] == (40, 99, 1) for shape, _ in fed)


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    pytest.importorskip("cv2")
    root = tmp_path_factory.mktemp("media")
    subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "make_real_media.py"),
         "--output", str(root), "--num_videos", "8", "--num_classes", "2",
         "--frame_size", "48", "--duration", "1.5", "--aud_sample_rate",
         "16000", "--seed", "1"],
        check=True, capture_output=True, timeout=300)
    yield root
    shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("ds_name", ["folder", "kinetics"])
def test_cli_trains_on_real_media(tmp_path, monkeypatch, media, ds_name):
    monkeypatch.setattr(shutil, "which", lambda name: None)  # no ffprobe
    dump = tmp_path / "run"
    history, fed = _run(monkeypatch, TINY.split() + [
        "--ds_name", ds_name, "--root_dir", str(media), "--data_path",
        str(tmp_path / "meta"), "--epochs", "1", "--dump_path", str(dump)])
    assert _epochs(history) == [0]
    sk = [h for h in history if "sk_cost" in h]
    assert len(sk) == 1 and np.isfinite(sk[0]["sk_cost"])
    assert (dump / CKPT_NAME).is_file()
    assert (tmp_path / "meta" / f"{ds_name}_train.txt").is_file()
    assert "Loaded data with 8 videos." in (dump / "train.log").read_text()
    # host spectrograms: [B, 40, 99, 1] from the loader
    assert fed and all(shape[1:] == (40, 99, 1) for shape, _ in fed)
