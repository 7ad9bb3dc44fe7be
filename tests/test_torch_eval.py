"""The port's cluster-quality evaluation against the JAX package's, on the
CPU:

* ``eval/clustering.py``: every metric of the report against
  ``selavi_tpu/eval/clustering.py`` and sklearn, to 1e-10 absolute, on
  random labels, a perfect permutation, one cluster, all singletons and
  more clusters than classes; the expected-MI term chunked and not;
* ``eval/get_clusters.py``: the dump of a TINY model with weights from
  JAX's init (moved by ``load_jax_variables``) over the same synthetic
  eval dataset, within 1e-4 absolute in fp32 with equal labels; each
  package's ``evaluate_dump`` reads the other's pickle and gives the same
  report (1e-10);
* the CLI chain ``cli.main`` -> ``cli.get_clusters`` ->
  ``cli.clustering_metrics`` on the CPU, the refusal of a JAX checkpoint
  (a reference-layout ``.pth`` is imported: ``tests/
  test_torch_pth_import.py``), and ``cli.plot_distributions``.
"""

import logging
import pickle
import shutil
import signal
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import (
    adjusted_mutual_info_score,
    adjusted_rand_score,
    normalized_mutual_info_score,
)
from sklearn.metrics.cluster._expected_mutual_info_fast import (
    expected_mutual_information,
)

from selavi_tpu.data.factory import build_dataset as jax_build_dataset
from selavi_tpu.data.loader import DataLoader as JaxDataLoader
from selavi_tpu.eval import clustering as jax_clustering
from selavi_tpu.eval.get_clusters import (
    dump_cluster_matrices as jax_dump_cluster_matrices,
)
from selavi_tpu.eval.get_clusters import evaluate_dump as jax_evaluate_dump
from selavi_tpu.models import load_model as jax_load_model
from selavi_tpu.selflabel.engine import (
    cluster_entropy_purity as jax_cluster_entropy_purity,
)
from selavi_tpu.train.step import make_encode_fn, make_head_logits_fn
from selavi_tpu_torch.cli import clustering_metrics, get_clusters
from selavi_tpu_torch.cli import main as cli_main
from selavi_tpu_torch.cli import plot_distributions
from selavi_tpu_torch.data.factory import audio_cfg_from_args, build_dataset
from selavi_tpu_torch.data.loader import DataLoader, decode_wire_batches
from selavi_tpu_torch.eval import clustering
from selavi_tpu_torch.eval.get_clusters import (
    dump_cluster_matrices,
    evaluate_dump,
)
from selavi_tpu_torch.models.av_model import load_model
from selavi_tpu_torch.models.convert import load_jax_variables
from selavi_tpu_torch.parallel import dist
from selavi_tpu_torch.train import step as steps
from selavi_tpu_torch.train.checkpoint import CKPT_NAME

torch.set_num_threads(1)

METRIC_ATOL = 1e-10
DUMP_ATOL = 1e-4  # fp32 towers, sums in another order
H, K, N = 2, 8, 16
TINY = (
    f"--ds_name synthetic --num_data_samples {N} --mlp_dim {K} "
    f"--headcount {H} --num_frames 4 --train_crop_size 32 "
    "--aud_sample_rate 16000 --aud_spec_type 1"
)
TRAIN = TINY + (
    " --epochs 1 --batch_size 4 --nopts 1 --match true "
    "--bn_warmup_batches 1 --workers 0 --compute_dtype float32 "
    "--sk_agg_batch 8 --base_lr 0.01 --wd 0.00001"
)
EVAL = TINY + " --batch_size 8 --workers 0"


def _cases():
    """(preds, targets, number of clusters for the Hungarian matching)."""
    rng = np.random.default_rng(0)
    targets = rng.integers(0, 9, 200)
    return {
        "random": (rng.integers(0, 7, 300), rng.integers(0, 5, 300), 7),
        "permutation": ((targets * 4 + 3) % 9, targets, 9),
        "one_cluster": (np.zeros(50, np.int64), np.zeros(50, np.int64), 1),
        "one_cluster_vs_classes": (np.zeros(50, np.int64),
                                   rng.integers(0, 4, 50), 4),
        "singletons": (np.arange(60), np.arange(60)[::-1].copy(), 60),
        "singletons_vs_classes": (np.arange(60), rng.integers(0, 5, 60), 60),
        "more_clusters_than_classes": (rng.integers(0, 12, 500),
                                       rng.integers(0, 3, 500), 12),
        "skewed": (rng.integers(0, 6, 1000),
                   np.where(rng.random(1000) < 0.9, 0,
                            rng.integers(1, 5, 1000)), 6),
    }


CASES = _cases()
SKLEARN = {"nmi": normalized_mutual_info_score,
           "anmi": adjusted_mutual_info_score, "ari": adjusted_rand_score}


@pytest.mark.parametrize("metric", ["nmi", "anmi", "ari", "entropy",
                                    "purity", "accuracy"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_metric_matches_jax_and_sklearn(case, metric):
    preds, targets, k = CASES[case]
    got = clustering.clustering_report(preds, targets, k)[metric]
    ref = jax_clustering.clustering_report(preds, targets, k)[metric]
    assert isinstance(got, float)
    assert abs(got - ref) <= METRIC_ATOL, (got, ref)
    if metric in SKLEARN:
        assert abs(got - SKLEARN[metric](preds, targets)) <= METRIC_ATOL
        # symmetric in its two labelings, as sklearn's
        swapped = clustering.clustering_report(targets, preds, k)[metric]
        assert abs(swapped - got) <= METRIC_ATOL


@pytest.mark.parametrize("chunk_terms", [1, 97, 1 << 21])
def test_expected_mutual_info_matches_sklearn_in_chunks(monkeypatch,
                                                         chunk_terms):
    """The expected-MI sum over row chunks of any size (one row a chunk
    when a row alone exceeds it) against sklearn's loop."""
    rng = np.random.default_rng(4)
    a = rng.integers(0, 11, 700)
    b = np.where(rng.random(700) < 0.4, a % 7, rng.integers(0, 7, 700))
    table = clustering.contingency(a, b)
    monkeypatch.setattr(clustering, "EMI_CHUNK_TERMS", chunk_terms)
    got = clustering.expected_mutual_info(table)
    ref = expected_mutual_information(table, int(table.sum()))
    assert abs(got - ref) <= 1e-12 * max(1.0, abs(ref)), (got, ref)


def test_hungarian_entropy_purity_and_best_head_match_jax():
    rng = np.random.default_rng(2)
    preds = rng.integers(0, 10, 400)
    targets = np.where(rng.random(400) < 0.5, (preds * 3) % 10,
                       rng.integers(0, 10, 400))
    assert (clustering.hungarian_match(preds, targets, 10)
            == jax_clustering.hungarian_match(preds, targets, 10))
    assert (clustering.cluster_accuracy(preds, targets, 10)
            == jax_clustering.cluster_accuracy(preds, targets, 10))
    ents, purs = clustering.cluster_entropy_purity(preds, targets)
    jents, jpurs = jax_cluster_entropy_purity(preds, targets)
    np.testing.assert_allclose(ents, jents, rtol=0, atol=METRIC_ATOL)
    np.testing.assert_allclose(purs, jpurs, rtol=0, atol=METRIC_ATOL)

    logits_v = rng.standard_normal((3, 400, 10)).astype(np.float32)
    logits_a = rng.standard_normal((3, 400, 10)).astype(np.float32)
    logits_v[1] += np.eye(10, dtype=np.float32)[targets] * 4  # the best
    labels, head = clustering.best_head_labels(logits_v, logits_a, targets)
    jlabels, jhead = jax_clustering.best_head_labels(logits_v, logits_a,
                                                     targets)
    assert head == jhead == 1
    np.testing.assert_array_equal(labels, jlabels)


# ------------------------------------------------------------ the dump

def _eval_args():
    return get_clusters.parse_args(EVAL.split() + ["--weights_path",
                                                   "None"])


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """Both packages' dumps of one TINY model (weights from JAX's init)
    over the same synthetic eval dataset."""
    tmp = tmp_path_factory.mktemp("dumps")
    args = _eval_args()
    jdataset = jax_build_dataset(args, eval_mode=True)
    dataset = build_dataset(args, eval_mode=True)
    example = dataset.get_example(0, np.random.default_rng(0))
    video = np.zeros((2,) + example["video"].shape, np.float32)
    audio = np.zeros((2,) + example["audio"].shape + (1,), np.float32)

    jmodel = jax_load_model(headcount=H, num_classes=K)
    variables = jmodel.init({"params": jax.random.PRNGKey(0),
                             "dropout": jax.random.PRNGKey(1)},
                            video, audio, train=False)
    params, bs = variables["params"], variables["batch_stats"]
    encode = make_encode_fn(jmodel, audio_cfg=audio_cfg_from_args(args))
    head_logits = make_head_logits_fn(jmodel)
    jbatches = ({k: jnp.asarray(v) for k, v in b.items()}
                for b in JaxDataLoader(jdataset, batch_size=8, shuffle=False,
                                       drop_last=False))
    jax_out = jax_dump_cluster_matrices(
        lambda v, a: encode(params, bs, v, a),
        lambda f, m: head_logits(params, bs, f, m), jbatches, len(jdataset),
        str(tmp / "jax.pkl"))

    model = load_model(headcount=H, num_classes=K, device="cpu")
    load_jax_variables(model, jax.tree.map(np.asarray, params),
                       jax.tree.map(np.asarray, bs))
    loader = DataLoader(dataset, batch_size=8, shuffle=False,
                        drop_last=False, device="cpu")
    port_out = dump_cluster_matrices(
        lambda v, a: steps.encode(model, v, a, augment=False,
                                  audio_cfg=audio_cfg_from_args(args)),
        lambda f, m: steps.head_logits(model, f, m),
        decode_wire_batches(loader), len(dataset), str(tmp / "port.pkl"),
        device="cpu")
    yield {"jax": jax_out, "port": port_out, "labels": dataset.labels,
           "paths": {"jax": str(tmp / "jax.pkl"),
                     "port": str(tmp / "port.pkl")}}
    shutil.rmtree(tmp, ignore_errors=True)


def test_dump_matches_jax(dumps):
    (ps_v, labels, ps_a), (jps_v, jlabels, jps_a) = dumps["port"], dumps["jax"]
    assert ps_v.shape == ps_a.shape == (H, N, K) and ps_v.dtype == np.float32
    assert labels.dtype == np.int64
    np.testing.assert_array_equal(labels, jlabels)
    np.testing.assert_array_equal(labels, dumps["labels"])
    np.testing.assert_allclose(ps_v, jps_v, rtol=0, atol=DUMP_ATOL)
    np.testing.assert_allclose(ps_a, jps_a, rtol=0, atol=DUMP_ATOL)
    with open(dumps["paths"]["port"], "rb") as f:
        payload = pickle.load(f)
    assert [type(m) for m in payload[0] + [payload[1]] + payload[2]] == [
        torch.Tensor] * (2 * H + 1)
    assert [m.shape for m in payload[0] + payload[2]] == [(N, K)] * (2 * H)
    assert payload[1].dtype == torch.int64
    for ours, got in zip(payload[0], ps_v):
        assert ours.dtype == torch.float32
        np.testing.assert_array_equal(ours.numpy(), got)


@pytest.mark.parametrize("use_all_heads", [True, False])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_evaluate_dump_reads_either_pickle(dumps, capsys, writer,
                                           use_all_heads):
    path = dumps["paths"][writer]
    got = evaluate_dump(path, K, use_all_heads)
    ref = jax_evaluate_dump(path, K, use_all_heads)
    assert list(got) == list(ref)
    for key, value in ref.items():
        assert abs(got[key] - value) <= METRIC_ATOL, key
    printed = capsys.readouterr().out.splitlines()
    assert printed[:6] == printed[6:]  # the same lines, in the same order


# ------------------------------------------------------------ the CLIs

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One TINY epoch of the port's CLI on the CPU; its process state (log
    and signal handlers) is put back, and its dump path deleted, after the
    module."""
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    usr1 = signal.getsignal(signal.SIGUSR1)
    term = signal.getsignal(signal.SIGTERM)
    dump = tmp_path_factory.mktemp("trained")
    try:
        cli_main.main(TRAIN.split() + ["--dump_path", str(dump)],
                      device="cpu")
    finally:
        for h in root.handlers:
            if h not in handlers:
                h.close()
        root.handlers[:] = handlers
        root.setLevel(level)
        signal.signal(signal.SIGUSR1, usr1)
        signal.signal(signal.SIGTERM, term)
        dist._SIGNAL_FLAG["received"] = False
    yield dump
    shutil.rmtree(dump, ignore_errors=True)


def test_cli_chain_dumps_and_reports(trained, tmp_path, capsys):
    out = str(tmp_path / "ps.pkl")
    for weights in (trained / CKPT_NAME, trained / "checkpoints/ckp-0.pth"):
        ps_v, labels, ps_a = get_clusters.main(
            EVAL.split() + ["--weights_path", str(weights), "--output_path",
                            out], device="cpu")
        assert ps_v.shape == ps_a.shape == (H, N, K)
        assert np.isfinite(ps_v).all() and np.isfinite(ps_a).all()
        np.testing.assert_array_equal(
            labels, build_dataset(_eval_args(), eval_mode=True).labels)
    report = clustering_metrics.main(["--path", out, "--ncentroids",
                                      str(K)])
    assert list(report) == ["nmi", "anmi", "ari", "entropy", "purity",
                            "accuracy"]
    printed = capsys.readouterr().out
    assert f"wrote {out}" in printed
    for key, value in report.items():
        assert f"{key}: {value:.4f}" in printed
    ref = jax_evaluate_dump(out, K)
    for key, value in ref.items():
        assert abs(report[key] - value) <= METRIC_ATOL, key

    # the trained weights, not a random init: the logits differ
    random_v, _, _ = get_clusters.main(
        EVAL.split() + ["--weights_path", "None", "--output_path", out],
        device="cpu")
    assert not np.allclose(random_v, ps_v)


@pytest.mark.parametrize("kind", ["jax_msgpack"])
def test_get_clusters_refuses_foreign_checkpoints(trained, tmp_path, kind):
    """A JAX checkpoint is refused; a reference-layout .pth is imported
    (tests/test_torch_pth_import.py)."""
    weights = tmp_path / "checkpoint.msgpack"
    weights.write_bytes(b"\x80\x04")
    out = tmp_path / "ps.pkl"
    with pytest.raises(NotImplementedError,
                       match=r"export_torch\.py.*reference \.pth layout.*"
                             r"cli\.get_clusters --weights_path"):
        get_clusters.main(EVAL.split() + ["--weights_path", str(weights),
                                          "--output_path", str(out)],
                          device="cpu")
    assert not out.exists()


def test_plot_distributions(trained, tmp_path, monkeypatch):
    out = tmp_path / "dist.png"
    plot_distributions.main(["--checkpoints", str(trained / CKPT_NAME),
                             "--output", str(out)])
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    labels, dists = plot_distributions.load_selflabels(
        str(trained / CKPT_NAME))
    assert labels.shape == (N, H) and dists is None  # default marginals

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        plot_distributions.main(["--checkpoints", str(trained / CKPT_NAME),
                                 "--output", str(tmp_path / "b.png")])


@pytest.mark.parametrize("flags", ["--dual_data true",
                                   "--tpu_aligned_midplanes true",
                                   "--aud_base_arch resnet50"])
def test_get_clusters_builds_the_architecture_of_its_flags(tmp_path, flags,
                                                           monkeypatch):
    """A random init (``--weights_path None``) of each architecture flag:
    a 2-channel audio stem fed tiled spectrograms, the aligned midplanes,
    the 2048-d audio features."""
    built = []
    load = get_clusters.load_model

    def recorded(**kw):
        built.append(load(**kw))
        return built[-1]

    monkeypatch.setattr(get_clusters, "load_model", recorded)
    ps_v, labels, ps_a = get_clusters.main(
        EVAL.split() + flags.split() + ["--weights_path", "None",
                                        "--output_path",
                                        str(tmp_path / "ps.pkl")],
        device="cpu")
    assert ps_v.shape == ps_a.shape == (H, N, K)
    assert np.isfinite(ps_v).all() and np.isfinite(ps_a).all()
    model = built[0]
    stem = model.audio_network.stem.conv.weight.shape
    assert stem[1] == (2 if "dual" in flags else 1)
    assert model.audio_network.feature_dim == (
        2048 if "resnet50" in flags else 512)
    mid = model.video_network.layer1_block0.conv1.spatial.weight.shape[0]
    ref = load_model(headcount=H, num_classes=K, device="cpu")
    ref_mid = ref.video_network.layer1_block0.conv1.spatial.weight.shape[0]
    assert (mid != ref_mid) == ("aligned" in flags)
