"""The port's video retrieval against the JAX package's, on the CPU.

* the pooled truncated-tower features (max and avg) of the same weights
  (JAX's init, moved by ``load_jax_variables``) on the same uint8 clips,
  within 1e-4 of the features' scale (fp32 towers, sums in another order);
  a feature map smaller than the pool window raises in both;
* ``collect_features`` with duplicated batch indices (exact) and
  ``average_features`` (1e-6 relative: the same numpy arithmetic);
* ``retrieval()`` against JAX's sklearn path on random features at
  several sizes, fewer than 50 train rows among them: equal recalls, and
  ``nearest_neighbors`` equal to sklearn's neighbour lists;
* ``cli.video_retrieval`` v-v and a-v on the synthetic set (16 frames at
  64 px, the smallest input the 2x2x2 pool takes) with the weights that
  root ``video_retrieval.py`` initialises: the a-v features against that
  CLI's cache and the v-v features against JAX's functions, within 1e-4 of
  scale with equal video ids and labels; each CLI reads the cache that the
  other package's wrote and reports the same recalls.
"""

import importlib
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.neighbors import NearestNeighbors

import video_retrieval as jax_cli
from selavi_tpu.data.loader import DataLoader as JaxDataLoader
from selavi_tpu.data.synthetic import SyntheticAVDataset as JaxSynthetic
from selavi_tpu.models import load_model as jax_load_model
from selavi_tpu.train.optim import make_optimizer as jax_make_optimizer
from selavi_tpu.train.state import create_train_state
from selavi_tpu_torch.cli import video_retrieval
from selavi_tpu_torch.models.av_model import load_model
from selavi_tpu_torch.models.convert import load_jax_variables

# the packages' eval/__init__ export a function named retrieval
jax_retrieval = importlib.import_module("selavi_tpu.eval.retrieval")
retrieval = importlib.import_module("selavi_tpu_torch.eval.retrieval")

torch.set_num_threads(1)

FEAT_RTOL = 1e-4  # of max |feature|: fp32 towers, sums in another order
AVG_RTOL = 1e-6
H, K, N = 2, 8, 6
CLIP = (16, 64, 64, 3)  # the synthetic set's default crop is 64
BATCH = 3
CLI = (f"--dataset synthetic --num_data_samples {N} --clip_len {CLIP[0]} "
       f"--batch_size {BATCH} --workers 0 --headcount {H} --num_clusters {K} "
       "--aud_sample_rate 24000 --aud_spec_type 1")


def _close(ours, ref, rtol=FEAT_RTOL):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-12)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=rtol * scale)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """JAX's init as root video_retrieval.py makes it (PRNGKey(0)), the
    same weights in a port checkpoint, and both models."""
    jmodel = jax_load_model(headcount=H, num_classes=K)
    example = JaxSynthetic(num_samples=N, num_frames=CLIP[0]).get_example(
        0, np.random.default_rng(0))
    state = create_train_state(
        jmodel, jax_make_optimizer(0.01, 0.0), jax.random.PRNGKey(0),
        (2,) + example["video"].shape, (2,) + example["audio"].shape + (1,))
    params = jax.tree.map(np.asarray, state.params)
    bs = jax.tree.map(np.asarray, state.batch_stats)
    model = load_model(headcount=H, num_classes=K, device="cpu")
    load_jax_variables(model, params, bs)
    path = tmp_path_factory.mktemp("weights") / "checkpoint.pth"
    torch.save({"model": model.state_dict()}, path)
    return {"jmodel": jmodel, "params": params, "bs": bs, "model": model,
            "path": str(path)}


def _clips(seed):
    return np.random.default_rng(seed).integers(
        0, 256, (BATCH,) + CLIP, dtype=np.uint8)


@pytest.mark.parametrize("pool_op", ["max", "avg"])
def test_pooled_features_match_jax(weights, pool_op):
    video = _clips(1)
    jenc = jax_retrieval.make_retrieval_encode_fn(weights["jmodel"], pool_op)
    ref = np.asarray(jenc(weights["params"], weights["bs"], video))
    enc = retrieval.make_retrieval_encode_fn(weights["model"], pool_op)
    got = enc(torch.from_numpy(video)).numpy()
    # a [2, 4, 4] x 512 map pooled to [1, 2, 2] x 512
    assert got.shape == (BATCH, 2048) and got.dtype == np.float32
    _close(got, ref)


def test_a_map_smaller_than_the_window_raises(weights):
    video = np.zeros((1, 8, 64, 64, 3), np.uint8)  # t = 1 after layer4
    enc = retrieval.make_retrieval_encode_fn(weights["model"])
    with pytest.raises(ValueError, match="smaller than pool window"):
        enc(torch.from_numpy(video))
    jenc = jax_retrieval.make_retrieval_encode_fn(weights["jmodel"])
    with pytest.raises(ValueError, match="smaller than pool window"):
        jenc(weights["params"], weights["bs"], video)


@pytest.mark.parametrize("mode", ["separate", "joint", "video_only"])
def test_collect_features_dedups_like_jax(mode):
    rng = np.random.default_rng(3)
    # the second batch repeats rows 2 and 5 (a padded ragged tail)
    index = [np.array([4, 2, 0]), np.array([5, 2, 1, 3, 5])]
    batches = []
    for idx in index:
        batches.append({
            "video": rng.normal(size=(len(idx), 3)).astype(np.float32),
            "audio": rng.normal(size=(len(idx), 2)).astype(np.float32),
            "vid_idx": idx // 2, "label": idx % 3, "index": idx})
    enc = (lambda v: v * 2.0)
    aenc = (lambda a: a - 1.0)
    joint = (lambda v, a: (v * 2.0, a - 1.0))
    kw = {"separate": dict(audio_encode_fn=aenc),
          "joint": dict(joint_encode_fn=joint), "video_only": {}}[mode]
    ref = jax_retrieval.collect_features(
        None if mode == "joint" else enc, iter(batches), **kw)
    tbatches = [{k: torch.from_numpy(v) for k, v in b.items()}
                for b in batches]
    got = retrieval.collect_features(
        None if mode == "joint" else enc, iter(tbatches), **kw)
    assert len(got) == len(ref) == (3 if mode == "video_only" else 4)
    for ours, theirs in zip(got, ref):
        np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(got[1], [0, 0, 1, 1, 2, 2])  # 6 rows


@pytest.mark.parametrize("norm", [True, False])
def test_average_features_matches_jax(norm):
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(40, 16)).astype(np.float32)
    vids = rng.integers(0, 9, 40)
    labels = vids % 4
    got = retrieval.average_features(feats, vids, labels, norm)
    ref = jax_retrieval.average_features(feats, vids, labels, norm)
    np.testing.assert_allclose(got[0], ref[0], rtol=AVG_RTOL)
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[2], ref[2])


@pytest.mark.parametrize("n_train,n_val,dim", [(7, 5, 3), (49, 20, 16),
                                               (50, 13, 2048),
                                               (300, 64, 40)])
def test_retrieval_matches_sklearn(n_train, n_val, dim):
    rng = np.random.default_rng(n_train)
    centers = rng.normal(size=(6, dim))
    tl = rng.integers(0, 6, n_train)
    vl = rng.integers(0, 6, n_val)
    train = (centers[tl] + rng.normal(size=(n_train, dim))).astype(np.float32)
    val = (centers[vl] + rng.normal(size=(n_val, dim))).astype(np.float32)
    got = retrieval.retrieval(train, tl, val, vl, device="cpu")
    ref = jax_retrieval.retrieval(train, tl, val, vl)
    assert got == ref
    k = min(50, n_train)
    _, ref_idx = NearestNeighbors(n_neighbors=k).fit(train).kneighbors(val, k)
    np.testing.assert_array_equal(
        retrieval.nearest_neighbors(train, val, k, device="cpu"), ref_idx)


def test_retrieval_with_few_train_rows_trims_thresholds():
    rng = np.random.default_rng(0)
    train = rng.normal(size=(12, 4))
    val = rng.normal(size=(5, 4))
    got = retrieval.retrieval(train, np.arange(12) % 3, val,
                              np.arange(5) % 3, device="cpu")
    assert list(got) == [1, 5, 10]


def test_select_task_features():
    tv, ta, vv, va = "tv", "ta", "vv", "va"
    for task, want in (("v-v", ("tv", "vv")), ("v-a", ("ta", "vv")),
                       ("a-v", ("tv", "va")), ("a-a", ("ta", "va"))):
        assert retrieval.select_task_features(task, tv, ta, vv, va) == want
        assert jax_retrieval.select_task_features(task, tv, ta, vv,
                                                  va) == want
    with pytest.raises(ValueError, match="needs audio"):
        retrieval.select_task_features("a-v", tv, None, vv, None)


def _jax_vv_features(weights):
    """v-v features through JAX's functions on JAX's synthetic splits, as
    root video_retrieval.py computes them."""
    enc = jax_retrieval.make_retrieval_encode_fn(weights["jmodel"], "max")
    out = {}
    for split, ds in (("train", JaxSynthetic(num_samples=N,
                                             num_frames=CLIP[0],
                                             mode="train")),
                      ("val", JaxSynthetic(num_samples=N, num_frames=CLIP[0],
                                           mode="test", seed=1))):
        batches = ({k: jnp.asarray(v) for k, v in b.items()}
                   for b in JaxDataLoader(ds, batch_size=BATCH,
                                          shuffle=False, drop_last=False))
        f, v, lab = jax_retrieval.collect_features(
            lambda x: enc(weights["params"], weights["bs"], x), batches)
        out[split] = jax_retrieval.average_features(f, v, lab)
    return out


def _read(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def test_cli_features_and_caches_match_jax(weights, tmp_path, capsys):
    port_vv = str(tmp_path / "port_vv.pkl")
    recalls_vv = video_retrieval.main(
        CLI.split() + ["--task", "v-v", "--weights_path", weights["path"],
                       "--feature_cache", port_vv], device="cpu")
    cache = _read(port_vv)
    assert cache["_video_feature_kind"] == "pooled:max|norm:True"
    ref = _jax_vv_features(weights)
    for split in ("train", "val"):
        _close(cache[split][0], ref[split][0])
        np.testing.assert_array_equal(cache[split][1], ref[split][1])
        np.testing.assert_array_equal(cache[split][2], ref[split][2])
    # root video_retrieval.py reads the port's cache (no model built)
    assert jax_cli.main(CLI.split() + ["--task", "v-v", "--feature_cache",
                                       port_vv]) == recalls_vv
    assert f"loaded cached features from {port_vv}" in capsys.readouterr().out

    # a-v: root video_retrieval.py from its own init, then the port on the
    # same weights; each reads the other's cache
    jax_av, port_av = str(tmp_path / "jax_av.pkl"), str(tmp_path / "av.pkl")
    jax_recalls = jax_cli.main(CLI.split() + ["--task", "a-v",
                                              "--feature_cache", jax_av])
    recalls_av = video_retrieval.main(
        CLI.split() + ["--task", "a-v", "--weights_path", weights["path"],
                       "--feature_cache", port_av], device="cpu")
    ours, theirs = _read(port_av), _read(jax_av)
    assert ours["_video_feature_kind"] == theirs["_video_feature_kind"] == (
        "gap|norm:True")
    assert sorted(ours) == sorted(theirs) == [
        "_video_feature_kind", "train", "train_audio", "val", "val_audio"]
    for key in ("train", "train_audio", "val", "val_audio"):
        assert ours[key][0].shape == (N, 512)
        _close(ours[key][0], theirs[key][0])
        np.testing.assert_array_equal(ours[key][1], theirs[key][1])
        np.testing.assert_array_equal(ours[key][2], theirs[key][2])
    assert recalls_av == jax_recalls
    capsys.readouterr()
    assert video_retrieval.main(CLI.split() + ["--task", "a-v",
                                               "--feature_cache", jax_av],
                                device="cpu") == jax_recalls
    assert jax_cli.main(CLI.split() + ["--task", "a-v", "--feature_cache",
                                       port_av]) == recalls_av
    out = capsys.readouterr().out
    assert out.count("loaded cached features") == 2

    # a cache of another feature kind is recomputed, not reused
    video_retrieval.main(CLI.split() + ["--task", "v-v", "--weights_path",
                                        weights["path"], "--feature_cache",
                                        jax_av], device="cpu")
    assert "recomputing" in capsys.readouterr().out
    assert _read(jax_av)["_video_feature_kind"] == "pooled:max|norm:True"


def test_cli_without_a_card_refuses_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        video_retrieval.main(CLI.split())


def test_cli_dual_data_tiles_the_spectrogram(monkeypatch):
    """--dual_data: the model's audio stem takes 2 channels, and the eval
    set's one-channel spectrograms are tiled onto them (as in
    cli.get_clusters); a random init (no --weights_path)."""
    built = []
    load = video_retrieval.load_model

    def recorded(**kw):
        built.append(load(**kw))
        return built[-1]

    monkeypatch.setattr(video_retrieval, "load_model", recorded)
    recalls = video_retrieval.main(CLI.split() + ["--task", "a-v",
                                                  "--dual_data", "true"],
                                   device="cpu")
    assert set(recalls) == {1, 5}
    assert built[0].audio_network.stem.conv.weight.shape[1] == 2
