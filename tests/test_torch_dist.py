"""The port's data parallelism on the CPU: 2 and 3 ranks in gloo groups
(``tests/_torch_dist.py`` spawns them), held against the JAX package and
against the port's own one-process path.

* (a) ``data/loader.py``: each rank's order and length equal
  ``selavi_tpu.data.loader.DataLoader``'s, and the ``valid`` rows cover
  the dataset once;
* (b) ``models/common.py::GlobalBatchNorm`` on 2 ranks equals the port's
  BatchNorm on the concatenated batch: outputs, running statistics, input
  gradients and the weight gradients summed over the ranks, to 1e-9 of
  scale in fp64 and 1e-5 in fp32;
* (c) a 2-rank DDP train step equals JAX's step on a 2-device ``data``
  mesh (``tests/test_torch_step.py``'s flip-invariant clips and linear
  heads, and its tolerances), and, with dropout, color jitter and an
  asymmetric clip, the port's 1-rank step at twice the batch;
* (d) the LR of every step of a 2-rank run, preempted mid-epoch and
  resumed, is the JAX optimizer's schedule at multiplier 2;
* (e) a 2-rank CLI epoch with an SK step and ``--match true`` leaves the
  labels, parameters and BN buffers equal on both ranks, only rank 0
  writes the checkpoint and TensorBoard events, and SIGUSR1 sent to one
  rank stops both through the preemption checkpoint.
"""

import glob
import math
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from _torch_dist import Ranks, spawn
from _torch_tmp import tmp_path  # noqa: F401
from selavi_tpu.data.loader import DataLoader as JaxDataLoader
from selavi_tpu.models import load_model as jax_load_model
from selavi_tpu.parallel.mesh import data_sharding, make_mesh
from selavi_tpu.train import optim as jax_optim
from selavi_tpu.train.state import TrainState
from selavi_tpu.train.step import make_train_step as jax_make_train_step
from selavi_tpu_torch.data.loader import DataLoader
from selavi_tpu_torch.models.av_model import load_model
from selavi_tpu_torch.models.common import flax_batch_norm
from selavi_tpu_torch.models.convert import load_jax_variables
from selavi_tpu_torch.train.checkpoint import CKPT_NAME
from selavi_tpu_torch.train.optim import make_optimizer, set_lr
from selavi_tpu_torch.train.step import make_train_step
from test_torch_step import _random_variables

torch.set_num_threads(1)


def _close(ours, ref, rtol):
    ours = np.asarray(torch.as_tensor(ours).double())
    ref = np.asarray(torch.as_tensor(ref).double())
    scale = max(float(np.abs(ref).max()), 1e-12)
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=rtol * scale)


# ------------------------------------------------------------ (a) loader

class _Rows:
    """The smallest dataset both loaders collate: its index as a 1-pixel
    clip."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def get_example(self, i, rng):
        return {"video": np.full((1, 1, 1, 3), i, np.uint8), "label": 0,
                "index": i, "vid_idx": i}


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("n", [16, 17])
def test_rank_stride_matches_jax(n, world, drop_last):
    kept = []
    for rank in range(world):
        kw = dict(batch_size=3, shuffle=True, drop_last=drop_last, seed=5,
                  rank=rank, world_size=world)
        ours, ref = DataLoader(_Rows(n), **kw), JaxDataLoader(_Rows(n), **kw)
        for epoch in (0, 3):
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            np.testing.assert_array_equal(ours._order(), ref._order())
        assert len(ours) == len(ref) == len(list(ours))
        for batch in ours:
            index = batch["index"].numpy()
            np.testing.assert_array_equal(batch["video"][:, 0, 0, 0, 0],
                                          index)
            kept += index[batch["valid"].numpy()].tolist()
    # every sample at most once; all of them where nothing is dropped
    assert len(kept) == len(set(kept))
    if not drop_last:
        assert sorted(kept) == list(range(n))


# ----------------------------------------------------- (b) global BatchNorm

BN_SHAPES = {"conv": (6, 3, 2, 3, 3), "heads": (6, 5)}


@pytest.fixture(scope="module")
def bn_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bn")
    rng = np.random.default_rng(0)
    inputs = {}
    for dtype in ("float64", "float32"):
        for name, shape in BN_SHAPES.items():
            c = shape[1]
            x, r = (torch.from_numpy(rng.normal(1.0, 2.0, shape))
                    for _ in range(2))
            w, b = (torch.from_numpy(rng.normal(0.0, 1.0, c))
                    for _ in range(2))
            inputs[(name, dtype)] = tuple(
                t.to(getattr(torch, dtype)) for t in (x, w, b, r))
    torch.save(inputs, tmp / "bn_inputs.pt")
    yield inputs, spawn("bn", 2, tmp, timeout=60)
    shutil.rmtree(tmp, ignore_errors=True)


@pytest.mark.parametrize("dtype,rtol", [("float64", 1e-9), ("float32", 1e-5)])
@pytest.mark.parametrize("name", sorted(BN_SHAPES))
def test_global_batch_norm_equals_the_concatenated_batch(bn_runs, name,
                                                         dtype, rtol):
    inputs, ranks = bn_runs
    x, w, b, r = (t.clone().requires_grad_(True) for t in inputs[(name,
                                                                  dtype)])
    rm = torch.zeros(x.shape[1], dtype=x.dtype)
    rv = torch.ones(x.shape[1], dtype=x.dtype)
    y = flax_batch_norm(x, w, b, rm, rv, training=True)
    (y * r).sum().backward()
    got = [out[(name, dtype)] for out in ranks]
    for rank, out in enumerate(got):
        _close(out["y"], y.detach()[rank::2], rtol)
        _close(out["dx"], x.grad[rank::2], rtol)
        _close(out["rm"], rm, rtol)
        _close(out["rv"], rv, rtol)
    _close(sum(out["dw"] for out in got), w.grad, rtol)
    _close(sum(out["db"] for out in got), b.grad, rtol)


# ---------------------------------------------------- (c) the train step

H, K = 2, 8
VIDEO = (4, 4, 32, 32, 3)  # the global batch: 2 rows a rank
AUDIO = (4, 40, 51, 1)
BASE_LR, WD = 0.5, 1e-3


def _global_batch(symmetric, seed=0):
    rng = np.random.default_rng(seed)
    if symmetric:  # mirror-symmetric along W: the flip draw cannot matter
        half = rng.integers(0, 256, size=VIDEO[:3] + (VIDEO[3] // 2, 3),
                            dtype=np.uint8)
        video = np.concatenate([half, half[:, :, :, ::-1]], axis=3)
    else:
        video = rng.integers(0, 256, size=VIDEO, dtype=np.uint8)
    audio = rng.normal(0, 1, AUDIO).astype(np.float32)
    labels = rng.integers(0, K, size=(VIDEO[0], H)).astype(np.int32)
    return video, audio, labels


def _variables(use_mlp):
    jmodel = jax_load_model(headcount=H, num_classes=K, use_mlp=use_mlp)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros(VIDEO), jnp.zeros(AUDIO), train=False))
    variables = _random_variables(shapes, 0)
    return variables["params"], variables["batch_stats"]


def _write_step_inputs(tmp, params, bs, video, audio, labels):
    np.savez(tmp / "step_inputs.npz", video=video, audio=audio,
             labels=labels, heads=H, k=K, lr=BASE_LR, wd=WD, seed=7)
    torch.save((params, bs), tmp / "step_weights.pt")


def _step_results(ranks, tmp):
    """The ranks' results; their full-width weights file deleted."""
    out = ranks.results(timeout=120)
    os.remove(tmp / "step_weights.pt")
    return out


def _jax_mesh_step(params, bs, video, audio, labels, dtype):
    """JAX's train step on a 2-device data mesh: the global batch sharded,
    the state replicated; returns (loss, new variables as float64)."""
    jdtype = jnp.float64 if dtype == "float64" else jnp.float32
    mesh = make_mesh(jax.devices()[:2])
    with jax.enable_x64(dtype == "float64"):
        jmodel = jax_load_model(headcount=H, num_classes=K, use_mlp=False,
                                dtype=jdtype)
        jparams = jax.tree.map(lambda a: jnp.asarray(a, jdtype), params)
        tx = jax_optim.make_optimizer(BASE_LR, WD, warmup_epochs=10,
                                      batches_per_epoch=1)
        state = TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                           batch_stats=bs, opt_state=tx.init(jparams), tx=tx)
        state = jax.device_put(state, NamedSharding(mesh, P()))
        dsh = data_sharding(mesh)
        jstep = jax_make_train_step(jmodel, compute_dtype=jdtype,
                                    donate=False)
        new_state, metrics = jstep(
            state, {"video": jax.device_put(video, dsh),
                    "audio": jax.device_put(audio, dsh)},
            jax.device_put(labels, dsh), jax.random.PRNGKey(3))
        loss = float(metrics["loss"])
        new_params = jax.tree.map(lambda a: np.asarray(a, np.float64),
                                  new_state.params)
        new_bs = jax.tree.map(lambda a: np.asarray(a, np.float64),
                              new_state.batch_stats)
    ref = load_model(headcount=H, num_classes=K, use_mlp=False,
                     device="cpu").to(torch.float64)
    load_jax_variables(ref, new_params, new_bs)
    return loss, ref.state_dict()


@pytest.fixture(scope="module")
def jax_mesh_runs(tmp_path_factory):
    """Both dtypes' 2-rank steps run while JAX computes its own."""
    params, bs = _variables(use_mlp=False)
    video, audio, labels = _global_batch(symmetric=True)
    started = {}
    for dtype in ("float64", "float32"):
        tmp = tmp_path_factory.mktemp(f"step_{dtype}")
        _write_step_inputs(tmp, params, bs, video, audio, labels)
        started[dtype] = (Ranks("step", 2, tmp, dtype=dtype, use_mlp=False,
                                colorjitter=False), tmp)
    out = {}
    for dtype, (ranks, tmp) in started.items():
        before = load_model(headcount=H, num_classes=K, use_mlp=False,
                            device="cpu")
        load_jax_variables(before, params, bs)
        out[dtype] = (_jax_mesh_step(params, bs, video, audio, labels,
                                     dtype), _step_results(ranks, tmp),
                      before.to(getattr(torch, dtype)).state_dict())
    yield out
    for _, tmp in started.values():
        shutil.rmtree(tmp, ignore_errors=True)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_two_rank_step_matches_jax_on_a_two_device_mesh(jax_mesh_runs, dtype):
    (jloss, ref), ranks, before = jax_mesh_runs[dtype]
    # DDP leaves every rank with the same state, bit for bit
    for name, value in ranks[0]["state"].items():
        assert torch.equal(value, ranks[1]["state"][name]), name
    # JAX's loss is the global batch's mean, the ranks' losses the halves'
    loss = (ranks[0]["loss"] + ranks[1]["loss"]) / 2
    np.testing.assert_allclose(loss, jloss,
                               rtol=1e-6 if dtype == "float64" else 1e-5)
    for name, value in ranks[0]["state"].items():
        if "running" in name:
            _close(value, ref[name], 1e-4)
        elif dtype == "float64":
            _close(value - before[name], ref[name] - before[name], 1e-4)
        elif not name.startswith("video_network."):
            # the fp32 video-tower gradient at this tiny input is held to
            # the fp64 comparison (tests/test_torch_step.py)
            _close(value - before[name], ref[name] - before[name], 2e-3)


def test_two_rank_step_equals_one_rank_at_twice_the_batch(tmp_path):
    """Dropout masks, flips and color jitter drawn for the global batch
    and sliced per rank: the 2-rank step is the 1-rank step on both
    ranks' rows."""
    params, bs = _variables(use_mlp=True)
    video, audio, labels = _global_batch(symmetric=False, seed=1)
    _write_step_inputs(tmp_path, params, bs, video, audio, labels)
    ranks = _step_results(Ranks("step", 2, tmp_path, dtype="float64",
                                use_mlp=True, colorjitter=True), tmp_path)

    model = load_model(headcount=H, num_classes=K, use_mlp=True,
                       device="cpu")
    load_jax_variables(model, params, bs)
    model = model.to(torch.float64)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = make_optimizer(model, BASE_LR, WD)
    set_lr(opt, BASE_LR)
    step = make_train_step(model, opt, colorjitter=True,
                           compute_dtype=torch.float64)
    metrics = step({"video": torch.from_numpy(video),
                    "audio": torch.from_numpy(audio)},
                   torch.from_numpy(labels).long(),
                   torch.Generator().manual_seed(7))

    # the same fp64 arithmetic, the BatchNorm and gradient sums split over
    # the ranks: 1e-9 of scale (2e-13 seen at the worst tensor)
    np.testing.assert_allclose((ranks[0]["loss"] + ranks[1]["loss"]) / 2,
                               float(metrics["loss"]), rtol=1e-9)
    for name, value in model.state_dict().items():
        got = ranks[0]["state"][name]
        assert torch.equal(got, ranks[1]["state"][name]), name
        if "running" in name:
            _close(got, value, 1e-9)
        else:
            _close(got - before[name], value - before[name], 1e-9)


# ------------------------------------------------------------- (d) the LR

def _jax_lrs(steps, multiplier, warmup_epochs, batches_per_epoch, base_lr):
    """The JAX optimizer's LR at each step: with momentum 0, no decay and a
    unit gradient its update is -lr."""
    tx = jax_optim.make_optimizer(base_lr, 0.0, momentum=0.0,
                                  multiplier=multiplier,
                                  warmup_epochs=warmup_epochs,
                                  batches_per_epoch=batches_per_epoch)
    params = {"w": jnp.ones(())}
    opt_state = tx.init(params)
    lrs = []
    for _ in range(steps):
        updates, opt_state = tx.update({"w": jnp.ones(())}, opt_state,
                                       params)
        lrs.append(-float(updates["w"]))
    return lrs


def test_lr_of_every_step_with_a_mid_epoch_resume(tmp_path):
    ranks = spawn("lr", 2, tmp_path, timeout=90,
                  extra="--epochs 4 --warmup_epochs 3 --base_lr 0.1 "
                        "--use_warmup_scheduler true",
                  stop_rank=1, stop_step=5)
    shutil.rmtree(tmp_path / "dump")  # full-width checkpoints
    assert ranks[0] == ranks[1]
    first, resumed = ranks[0]
    bpe = first["batches_per_epoch"]
    assert bpe == 4  # 16 samples, 2 ranks of batch 2
    # SIGUSR1 on rank 1 during step 5: both stop after step 6, mid-epoch 1
    assert first["exit"] == 0 and resumed["exit"] is None
    assert [s for s, _ in first["lrs"]] == list(range(7))
    # the resumed run re-runs epoch 1 from the restored step on
    assert [s for s, _ in resumed["lrs"]] == list(range(7, 7 + 3 * bpe))
    ref = _jax_lrs(7 + 3 * bpe, 2.0, 3, bpe, 0.1)
    for step, lr in first["lrs"] + resumed["lrs"]:
        np.testing.assert_allclose(lr, ref[step], rtol=1e-6)
    assert math.isclose(ref[-1], 0.2, rel_tol=1e-6)  # warmed up to x2


# ------------------------------------------------------------ (e) the CLI

@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    ranks = spawn("cli", 2, tmp, timeout=150, extra="")
    dump = tmp / "dump"
    saved = torch.load(dump / CKPT_NAME, map_location="cpu",
                       weights_only=True)
    files = sorted(os.listdir(dump))
    events = glob.glob(str(dump / "events.out.tfevents.*"))
    shutil.rmtree(dump)
    yield ranks, saved, files, events
    shutil.rmtree(tmp, ignore_errors=True)


def test_two_rank_epoch_with_sk_keeps_the_ranks_equal(cli_run):
    ranks, saved, _, _ = cli_run
    a, b = ranks
    assert a["net"] == b["net"] == "DistributedDataParallel"
    assert a["exit"] is b["exit"] is None and a["step"] == b["step"] == 4
    # the same SK metrics on both ranks, all but the wall time
    sk = [[{k: v for k, v in h.items() if k != "sk_time"}
           for h in r["history"] if "sk_cost" in h] for r in ranks]
    assert len(sk[0]) == 1 and sk[0] == sk[1]
    np.testing.assert_array_equal(a["labels"], b["labels"])
    assert all(len(np.unique(a["labels"][:, h])) > 1 for h in range(2))
    for key in ("heads", "buffers", "params"):
        assert a[key].keys() == b[key].keys()
        for name, value in a[key].items():
            assert torch.equal(value, b[key][name]), (key, name)
    # the file is a one-GPU run's: the inner module's keys, rank 0's state
    assert not any(k.startswith("module.") for k in saved["model"])
    assert saved["model"].keys() == {**a["params"], **a["buffers"]}.keys()
    np.testing.assert_array_equal(saved["selflabels"].numpy(), a["labels"])


def test_only_rank_zero_writes(cli_run):
    ranks, _, files, events = cli_run
    assert ranks[0]["written"] == [0] and ranks[1]["written"] == []
    assert {"train.log", "train.log-1", "stats0.pkl", "stats1.pkl",
            "params.pkl", CKPT_NAME} <= set(files)
    try:
        import tensorboardX  # noqa: F401
    except ImportError:
        assert events == []
    else:
        assert len(events) == 1  # rank 0's writer only


def test_sigusr1_on_one_rank_stops_both(tmp_path):
    ranks = spawn("cli", 2, tmp_path, timeout=150, extra="--epochs 2",
                  stop_rank=1, stop_step=5)
    saved = torch.load(tmp_path / "dump" / CKPT_NAME, map_location="cpu",
                       weights_only=True)
    shutil.rmtree(tmp_path / "dump")
    # rank 1 saw the signal after step 5; both exit 0 after step 6,
    # through the checkpoint stamped with the interrupted epoch
    assert [r["exit"] for r in ranks] == [0, 0]
    assert [r["step"] for r in ranks] == [6, 6]
    assert ranks[0]["written"] == [0, 1] and ranks[1]["written"] == []
    assert saved["epoch"] == 1 and saved["step"] == 6
