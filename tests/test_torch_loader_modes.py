"""The loader modes and the Trainer flags of the port's data path, on the
CPU at small sizes: process workers, coalesced transfers, data echo and
dual_data, each held against the thread loader, per-field copies or the
JAX package on the same inputs.

Tolerances: loader batches, synthetic examples and the SK schedule are
exact; the dual-clip augmentation holds JAX's draws, injected, to 1e-5
(``tests/test_torch_preprocess.py``); the 2-channel audio tower holds
JAX's to 1e-4 of the output scale (``tests/test_torch_models.py``). Tests
that spawn worker processes run under a deadline.
"""

import contextlib
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selavi_tpu.data import synthetic as jsynthetic
from selavi_tpu.data.loader import DataLoader as JaxLoader
from selavi_tpu.models import load_model as jax_load_model
from selavi_tpu.ops import preprocess as jpre
from selavi_tpu.selflabel import schedule as jschedule
from selavi_tpu.train.step import _match_audio_channels
from selavi_tpu_torch.config import parse_arguments
from selavi_tpu_torch.data import factory as pfactory
from selavi_tpu_torch.data import packed as ppacked
from selavi_tpu_torch.data import synthetic as psynthetic
from selavi_tpu_torch.data.loader import DataLoader, coalesce_batch
from selavi_tpu_torch.models.av_model import load_model
from selavi_tpu_torch.models.convert import (
    jax_audio_channels,
    load_jax_variables,
)
from selavi_tpu_torch.ops import preprocess as tpre
from selavi_tpu_torch.ops.preprocess import draw_augmentations
from selavi_tpu_torch.train import loop
from selavi_tpu_torch.train import step as steps
from selavi_tpu_torch.train import torch_export
from selavi_tpu_torch.train.checkpoint import CKPT_NAME
from selavi_tpu_torch.train.loop import Trainer

from test_torch_models import _close, _random_variables
from test_torch_preprocess import _jax_draws

torch.set_num_threads(1)

SR = 16000
WORKER_DEADLINE_S = 240  # spawning two workers imports torch in each
TINY = (
    "--ds_name synthetic --num_data_samples 16 --mlp_dim 8 --headcount 2 "
    "--epochs 1 --batch_size 4 --num_frames 4 --train_crop_size 32 "
    "--aud_sample_rate 16000 --aud_spec_type 1 --nopts 1 --match true "
    "--bn_warmup_batches 1 --workers 0 --compute_dtype float32 "
    "--sk_agg_batch 8 --base_lr 0.01 --wd 0.00001"
)


@contextlib.contextmanager
def deadline(seconds):
    """Raise TimeoutError in the test if it runs past ``seconds``."""
    def expire(signum, frame):
        raise TimeoutError(f"past the {seconds} s deadline")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)


def _synthetic(mod, n=12, classes=4, pcm=False, dual=False, crop=32):
    return mod.SyntheticAVDataset(num_samples=n, num_classes=classes,
                                  num_frames=4, crop_size=crop,
                                  aud_sample_rate=SR, aud_spec_type=1,
                                  seed=3, return_pcm=pcm, dual_data=dual)


def _epoch(loader, epoch=1):
    loader.set_epoch(epoch)
    return [{k: v.clone() for k, v in b.items()} for b in loader]


def _assert_batches_equal(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert sorted(a) == sorted(b)
        for key in b:
            assert a[key].dtype == b[key].dtype, key
            assert torch.equal(a[key], b[key]), key


# ------------------------------------------------------ process workers

@pytest.mark.parametrize("pcm,dual", [(False, False), (True, True)],
                         ids=["spec", "dual_pcm"])
def test_process_workers_yield_the_thread_batches(pcm, dual):
    dataset = _synthetic(psynthetic, pcm=pcm, dual=dual)
    kw = dict(batch_size=4, num_workers=2, seed=5, prefetch=2)
    threads = _epoch(DataLoader(dataset, worker_mode="thread", **kw))
    loader = DataLoader(dataset, worker_mode="process", **kw)
    try:
        with deadline(WORKER_DEADLINE_S):
            processes = _epoch(loader)
            again = _epoch(loader, epoch=2)  # the pool serves a 2nd epoch
    finally:
        loader.close()
    assert loader._pool is None
    assert len(processes) == 3
    _assert_batches_equal(processes, threads)
    _assert_batches_equal(again, _epoch(DataLoader(dataset, **kw), epoch=2))
    # the JAX loader's order and per-example rng
    ref = JaxLoader(dataset, batch_size=4, num_workers=0, seed=5)
    ref.set_epoch(1)
    ref = list(ref)
    assert len(ref) == len(processes)
    for a, b in zip(processes, ref):
        np.testing.assert_array_equal(a["index"].numpy(), b["index"])
        np.testing.assert_array_equal(a["video"].numpy(), b["video"])


def test_process_workers_refuse_a_packed_shard_as_jax_does(tmp_path):
    """A packed dataset holds an mmap, which does not pickle: process mode
    fails at the first epoch in both packages (the JAX package has no
    re-open path for workers, and neither has the port)."""
    path = str(tmp_path / "s.pack")
    ppacked.write_packed_shard(_synthetic(psynthetic, n=4, pcm=True), path)
    dataset = ppacked.PackedAVDataset(path, crop_size=32, num_sec=1,
                                      sample_rate=SR)
    loader = DataLoader(dataset, batch_size=2, num_workers=2,
                        worker_mode="process")
    try:
        with deadline(WORKER_DEADLINE_S), pytest.raises(TypeError,
                                                        match="pickle"):
            next(iter(loader))
    finally:
        loader.close()
    ref = JaxLoader(dataset, batch_size=2, num_workers=2,
                    worker_mode="process")
    try:
        with deadline(WORKER_DEADLINE_S), pytest.raises(TypeError,
                                                        match="pickle"):
            next(iter(ref))
    finally:
        ref.close()


# -------------------------------------------------- coalesced transfers

def _yuv_shard(tmp_path):
    path = str(tmp_path / "yuv.pack")
    ppacked.write_packed_shard(_synthetic(psynthetic, n=8, pcm=True, crop=40),
                               path, video_format="yuv420",
                               pcm_dtype="int16")
    return ppacked.PackedAVDataset(path, crop_size=32, num_sec=1,
                                   sample_rate=SR)


@pytest.mark.parametrize("kind", ["rgb_spec", "yuv420_int16", "dual_spec"])
def test_coalesced_batches_equal_per_field_copies(kind, tmp_path):
    dataset = {"rgb_spec": lambda: _synthetic(psynthetic),
               "yuv420_int16": lambda: _yuv_shard(tmp_path),
               "dual_spec": lambda: _synthetic(psynthetic, dual=True)}[kind]()
    kw = dict(batch_size=4, seed=2, drop_last=False)
    fields = _epoch(DataLoader(dataset, coalesce=False, **kw))
    coalesced = _epoch(DataLoader(dataset, coalesce=True, **kw))
    _assert_batches_equal(coalesced, fields)
    wire = {"rgb_spec": {"video": torch.uint8, "audio": torch.float32},
            "yuv420_int16": {"video_y": torch.uint8, "video_uv": torch.uint8,
                             "audio_pcm": torch.int16},
            "dual_spec": {"video": torch.uint8, "audio": torch.float32}}[kind]
    batch = next(iter(DataLoader(dataset, coalesce=True, **kw)))
    for key, dtype in wire.items():
        assert batch[key].dtype == dtype
    # every field a contiguous view of one buffer: no copy per field
    ptrs = {t.untyped_storage().data_ptr() for t in batch.values()}
    assert len(ptrs) == 1
    assert all(t.is_contiguous() for t in batch.values())
    assert all(t.data_ptr() % 64 == 0 for t in batch.values())


def test_coalesce_batch_of_odd_sizes():
    rng = np.random.default_rng(0)
    host = {"a": rng.integers(0, 256, (3, 5, 7), np.uint8),
            "b": rng.standard_normal((3, 11)).astype(np.float32),
            "c": rng.integers(-300, 300, (3, 13), np.int16),
            "d": np.arange(3, dtype=np.int64)}
    out = coalesce_batch(host, "cpu")
    for key, value in host.items():
        np.testing.assert_array_equal(out[key].numpy(), value)
        assert out[key].dtype == torch.from_numpy(value).dtype


# ------------------------------------------------------------ data echo

def _trainer(extra=""):
    args = parse_arguments().parse_args(TINY.split() + extra.split())
    return Trainer(args, pfactory.build_dataset(args), device="cpu")


def test_data_echo_takes_twice_the_steps_with_fresh_draws(monkeypatch):
    trainer = _trainer("--data_echo 2 --epochs 3 --nopts 4")
    loader_batches = len(trainer.loader)
    assert trainer.batches_per_epoch == 2 * loader_batches == 8
    # the SK schedule of the scaled epoch, as JAX's functions make it
    assert trainer.sk_schedule == jschedule.make_sk_schedule(
        3, 2 * loader_batches, 4, trainer.args.schedulepower)
    steps_seen = []

    def train_step(batch, labels, gen):
        draws = draw_augmentations(batch["video"].shape[0], gen)
        steps_seen.append((tuple(batch["index"].tolist()), draws["bf"]))
        return {"loss": torch.tensor(1.0)}

    monkeypatch.setattr(trainer, "train_step", train_step)
    monkeypatch.setattr(trainer, "maybe_cluster", lambda iteration: False)
    trainer.train_epoch(0)
    assert len(steps_seen) == 2 * loader_batches
    indexes = [s[0] for s in steps_seen]
    assert indexes[0::2] == indexes[1::2]  # each batch twice in a row
    assert len(set(indexes)) == loader_batches
    assert not any(torch.equal(a[1], b[1])  # fresh augmentations
                   for a, b in zip(steps_seen[0::2], steps_seen[1::2]))

    warmed = []
    monkeypatch.setattr(steps, "bn_warmup_step", lambda model, video, *a:
                        warmed.append(tuple(video.shape)))
    trainer.warmup_batchnorm(batches=2)
    assert len(warmed) == 2


@pytest.mark.parametrize("start_epoch", [1, 2])
def test_data_echo_fast_forward_matches_jax(monkeypatch, start_epoch):
    trainer = _trainer("--data_echo 2 --epochs 3 --nopts 5")

    def restored(dump, model, optimizer, sl_state, step):
        return sl_state, start_epoch, 0

    monkeypatch.setattr(loop, "restore_checkpoint", restored)
    assert trainer.resume() == start_epoch
    bpe = 2 * len(trainer.loader)
    ref, done = jschedule.fast_forward_schedule(
        jschedule.make_sk_schedule(3, bpe, 5, trainer.args.schedulepower),
        bpe, start_epoch)
    assert trainer.sk_schedule == ref
    assert trainer.sl_state.sk_counter == done > 0


# ------------------------------------------------------------- dual_data

@pytest.mark.parametrize("pcm", [False, True])
@pytest.mark.parametrize("classes", [4, 20])  # signature v1 and v2
def test_dual_data_examples_match_jax(pcm, classes):
    ours = _synthetic(psynthetic, n=4, classes=classes, pcm=pcm, dual=True)
    ref = _synthetic(jsynthetic, n=4, classes=classes, pcm=pcm, dual=True)
    for i in range(len(ours)):
        rngs = [np.random.default_rng((9, i)), np.random.default_rng((9, i))]
        a, b = ours.get_example(i, rngs[0]), ref.get_example(i, rngs[1])
        assert sorted(a) == sorted(b)
        for key in b:
            np.testing.assert_array_equal(np.asarray(a[key]),
                                          np.asarray(b[key]), err_msg=key)
        assert a["video"].shape == (8, 32, 32, 3)
        if pcm:
            assert a["audio_pcm"].shape == (2, SR)
        else:
            assert a["audio"].shape == (40, 99, 2)
        assert rngs[0].integers(1 << 30) == rngs[1].integers(1 << 30)


@pytest.mark.parametrize("colorjitter,grayscale", [(False, False),
                                                   (True, True)])
def test_augment_two_clips_matches_jax(colorjitter, grayscale):
    frames = np.random.default_rng(1).integers(0, 256, (3, 8, 16, 16, 3),
                                               np.uint8)
    key = jax.random.PRNGKey(4)
    ref = jpre.augment_video_batch(jnp.asarray(frames), key,
                                   colorjitter=colorjitter,
                                   grayscale=grayscale, clips=2)
    ours = tpre.augment_video_batch(torch.from_numpy(frames),
                                    colorjitter=colorjitter,
                                    grayscale=grayscale,
                                    draws=_jax_draws(key, 6), clips=2)
    assert ours.shape == (3, 8, 16, 16, 3)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    # the draws are per clip, sample-major: flip only clip 1 of sample 0
    flip = torch.tensor([False, True, False, False, False, False])
    out = tpre.augment_video_batch(torch.from_numpy(frames),
                                   draws={"flip": flip}, clips=2)
    norm = tpre.normalize_video(torch.from_numpy(frames))
    assert torch.equal(out[0, :4], norm[0, :4])
    assert torch.equal(out[0, 4:], norm[0, 4:].flip(2))
    assert torch.equal(out[1:], norm[1:])


def test_two_channel_audio_stem_matches_jax():
    video, audio = (2, 4, 32, 32, 3), (2, 40, 51, 2)
    jmodel = jax_load_model(headcount=2, num_classes=8, use_mlp=False)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros(video), jnp.zeros(audio), train=False))
    variables = _random_variables(shapes, 0)
    params, stats = variables["params"], variables.get("batch_stats", {})
    assert jax_audio_channels(params) == 2
    model = load_model(headcount=2, num_classes=8, use_mlp=False,
                       device="cpu", audio_channels=2)
    load_jax_variables(model, params, stats)
    rng = np.random.default_rng(2)
    x_v = rng.normal(0, 1, video).astype(np.float32)
    x_a = rng.normal(0, 1, audio).astype(np.float32)
    ref_v, ref_a = jmodel.apply(variables, x_v, x_a, train=False,
                                return_features=True)
    with torch.no_grad():
        feat_v, feat_a = model.eval()(torch.from_numpy(x_v),
                                      torch.from_numpy(x_a),
                                      return_features=True)
    _close(feat_a, ref_a)
    _close(feat_v, ref_v)
    # a one-channel clip tiled onto the 2-channel stem, as JAX tiles it
    one = x_a[..., :1]
    np.testing.assert_array_equal(
        steps.match_audio_channels(torch.from_numpy(one), 2).numpy(),
        np.asarray(_match_audio_channels(jnp.asarray(one), 2)))
    assert steps.match_audio_channels(torch.from_numpy(x_a), 2).shape[-1] == 2


@pytest.mark.parametrize("pcm", [False, True])
def test_example_shapes_match_jax(pcm):
    from selavi_tpu.data.factory import example_shapes as jax_example_shapes

    args = parse_arguments().parse_args(
        TINY.split() + ["--dual_data", "true", "--device_spectrogram",
                        str(pcm)])
    dataset = pfactory.build_dataset(args)
    assert pfactory.example_shapes(args, dataset) == jax_example_shapes(
        args, dataset) == ((2, 8, 32, 32, 3), (2, 40, 99, 2))


def test_dual_data_trainer_trains_and_exports_two_channel_stem(
        monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)  # fit() writes into the default "."
    trainer = _trainer("--dual_data true")
    assert trainer.video_clips == 2
    assert trainer.model.audio_network.stem.conv.weight.shape[1] == 2
    fed = []
    trainer.model.audio_network.register_forward_pre_hook(
        lambda mod, inp: fed.append(tuple(inp[0].shape)))
    history = trainer.fit()
    sk = [h for h in history if "sk_cost" in h]
    assert len(sk) == 1 and np.isfinite(sk[0]["sk_cost"])
    losses = [h["loss"] for h in history if "loss" in h]
    assert losses and all(np.isfinite(losses))
    assert (4, 40, 99, 2) in fed  # train steps: batch 4, two channels
    out = tmp_path / "export.pth.tar"
    torch_export.export_our_checkpoint(str(tmp_path / CKPT_NAME), str(out))
    sd = torch.load(out, map_location="cpu", weights_only=False)["model"]
    conv1 = [v for k, v in sd.items()
             if k.endswith("audio_network.base.conv1.weight")]
    assert len(conv1) == 1 and tuple(conv1[0].shape) == (64, 2, 7, 7)
    model = torch_export.model_for_state_dict(
        torch.load(tmp_path / CKPT_NAME, map_location="cpu",
                   weights_only=True)["model"])
    assert model.audio_network.stem.conv.weight.shape[1] == 2
