"""The port's cluster-browser export against the JAX package's, on the CPU:
``clusters.js`` byte for byte from the same self-labels (a port
``checkpoint.pth`` on one side, JAX's pickle on the other) over the same
dataset, for synthetic samples, YouTube-named and plain file paths, with
and without meta-classes; the filename parser; the row-count
``ValueError``; and ``cli.cluster_vis`` on a port checkpoint against the
JAX CLI."""

import json
import pickle
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _torch_tmp import tmp_path  # noqa: F401
from selavi_tpu.eval import cluster_vis as jax_cv
from selavi_tpu_torch.cli import cluster_vis as cli
from selavi_tpu_torch.data.factory import build_dataset
from selavi_tpu_torch.eval import cluster_vis as cv

torch.set_num_threads(1)

N, K = 48, 8
FLAGS = (f"--ds_name synthetic --num_data_samples {N} --mlp_dim {K} "
         "--num_frames 4 --train_crop_size 32 --aud_sample_rate 16000 "
         "--aud_spec_type 1")


def _checkpoints(tmp_path, selflabels):
    """The same self-labels as a port checkpoint and as JAX's pickle."""
    port = tmp_path / "checkpoint.pth"
    torch.save({"selflabels": torch.from_numpy(selflabels), "epoch": 1},
               port)
    jax_ckpt = tmp_path / "checkpoint.msgpack"
    with open(jax_ckpt, "wb") as f:
        pickle.dump({"selflabels": selflabels, "epoch": 1}, f)
    return str(port), str(jax_ckpt)


def _labels(n, heads=2, seed=0):
    return np.random.default_rng(seed).integers(0, K, (n, heads)).astype(
        np.int32)


class _Paths(SimpleNamespace):
    def __len__(self):
        return len(self.valid_indices)


YOUTUBE = [
    "/data/train/dog_barking/ytA_-x_10_20.mp4",
    "/data/train/dog_barking/ytB_30_40.mp4",
    "/data/train/car_horn/ytC_5_15.mp4",
    "/data/train/car_horn/oddname.mp4",  # no window: a generic id
    "/data/train/car_horn/yt_D_0_10.mp4",
]


def _path_dataset(ds_name, n=40):
    paths = [YOUTUBE[i % len(YOUTUBE)].replace(".mp4", f"{i}.mp4")
             if i >= len(YOUTUBE) else YOUTUBE[i] for i in range(n)]
    classes = sorted({p.split("/")[-2] for p in paths})
    return _Paths(
        ds_name=ds_name, _path_to_videos=["/skipped.mp4"] + paths,
        valid_indices=list(range(1, n + 1)),
        labels=np.asarray([classes.index(p.split("/")[-2]) for p in paths]),
        class_to_idx={c: i for i, c in enumerate(classes)})


@pytest.mark.parametrize("meta", [False, True])
@pytest.mark.parametrize("kind", ["synthetic", "vggsound", "ucf101"])
def test_clusters_js_is_byte_identical_to_jax(tmp_path, kind, meta):
    if kind == "synthetic":
        dataset = build_dataset(cli.parse_args(
            FLAGS.split() + ["--weights_path", "x"]), eval_mode=True)
    else:
        dataset = _path_dataset(kind)
    port, jax_ckpt = _checkpoints(tmp_path, _labels(len(dataset)))
    meta_path = None
    if meta:
        meta_path = tmp_path / "meta.json"
        meta_path.write_text(json.dumps({"dog barking": "animals",
                                         "car horn": "vehicle",
                                         "1": "one"}))
        meta_path = str(meta_path)
    for head in (0, 1):
        got = cv.export_from_checkpoint(port, dataset, str(tmp_path / "p"),
                                        head, meta_path)
        ref = jax_cv.export_from_checkpoint(jax_ckpt, dataset,
                                            str(tmp_path / "j"), head,
                                            meta_path)
        assert got == ref
        assert ((tmp_path / "p/clusters.js").read_bytes()
                == (tmp_path / "j/clusters.js").read_bytes())
    if kind == "vggsound":  # YouTube ids and clip windows
        ids = {s["id"] for c in got for s in c["samples"]}
        assert {"ytA_-x", "ytB", "oddname"} <= ids


def test_write_clusters_js_shuffles_and_truncates_like_jax(tmp_path):
    rng = np.random.default_rng(3)
    clusters = {int(c): [(f"v{c}_{i}", float(i), float(i + 10),
                          f"class{rng.integers(0, 4)}")
                         for i in range(int(rng.integers(1, 70)))]
                for c in rng.permutation(12)}
    for seed, cap in ((0, 30), (5, 7)):
        got = cv.write_clusters_js(clusters, str(tmp_path / "a.js"), seed,
                                   cap)
        ref = jax_cv.write_clusters_js(clusters, str(tmp_path / "b.js"),
                                       seed, cap)
        assert got == ref
        assert (tmp_path / "a.js").read_bytes() == (
            tmp_path / "b.js").read_bytes()
    assert cv.extract_clusters(_labels(30), [str(i) for i in range(30)],
                               ["g"] * 30, head=1) == jax_cv.extract_clusters(
        _labels(30), [str(i) for i in range(30)], ["g"] * 30, head=1)


def test_parse_youtube_filename_and_meta_classes(tmp_path):
    for path in YOUTUBE + ["/d/x/vid_0_10.avi", "/d/x/clip_one.mp4",
                           "/d/x/short.mp4", "/d/x/a_b_c_1_2.mp4"]:
        assert cv.parse_youtube_filename(path) == (
            jax_cv.parse_youtube_filename(path))
    meta = tmp_path / "meta.json"
    meta.write_text(json.dumps({"dog barking": "animals", "x y z": "w"}))
    assert cv.load_meta_classes(str(meta)) == jax_cv.load_meta_classes(
        str(meta)) == {"dog_barking": "animals", "x_y_z": "w"}


def test_row_count_mismatch_raises(tmp_path):
    dataset = _path_dataset("vggsound", n=10)
    port, jax_ckpt = _checkpoints(tmp_path, _labels(11))
    with pytest.raises(ValueError, match="11 selflabel rows.*10 samples"):
        cv.export_from_checkpoint(port, dataset, str(tmp_path))
    with pytest.raises(ValueError, match="11 selflabel rows.*10 samples"):
        jax_cv.export_from_checkpoint(jax_ckpt, dataset, str(tmp_path))


def test_cli_on_a_port_checkpoint_matches_the_jax_cli(tmp_path, capsys):
    port, jax_ckpt = _checkpoints(tmp_path, _labels(N, heads=3))
    args = FLAGS.split() + ["--head", "2"]
    got = cli.main(args + ["--weights_path", port, "--out_dir",
                           str(tmp_path / "p")])
    ref = jax_cv.main(args + ["--weights_path", jax_ckpt, "--out_dir",
                              str(tmp_path / "j")])
    assert got == ref and 1 < len(got) <= K
    assert (tmp_path / "p/clusters.js").read_bytes() == (
        tmp_path / "j/clusters.js").read_bytes()
    out = capsys.readouterr().out
    assert f"wrote {tmp_path / 'p' / 'clusters.js'} ({len(got)} clusters)" in (
        out)
