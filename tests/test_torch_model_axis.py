"""Head sharding over ``--model_axis`` on the CPU: gloo ranks as a
``[N / M, M]`` process grid (``tests/_torch_dist.py`` spawns them), held
against the port's own ``--model_axis 1`` on the same ranks and against
JAX on a ``('data', 'model')`` mesh.

* the dropout masks a rank keeps (its heads, its data row's gathered rows)
  are the one-process masks of the global batch;
* a train step at ``M = 2`` on 2 ranks (1x2) and on 4 (2x2) equals the
  ``M = 1`` step on the same ranks: the global loss, every parameter with
  the heads gathered, the BN running statistics and the momentum, to 1e-9
  of scale in fp64 and 1e-5 in fp32 (or, for a tensor whose fp32 rounding
  is larger, as close to the fp64 step as the fp32 ``M = 1`` step), with
  MLP heads (their BN over the data group, their dropout) and color
  jitter; each rank holds and optimizes ``H / M`` heads;
* the 2x2 step equals JAX's step on ``make_mesh(devices[:4],
  model_axis=2)`` with ``state_shardings`` (flip-invariant clips and
  linear heads, as ``tests/test_torch_dist.py`` holds the data mesh);
* a 2x2 CLI epoch with an SK step, matching and ``--distribution gauss``
  keeps the labels, marginals, host RNG state and audio permutations
  equal on every rank and to the 4-rank ``M = 1`` run, each rank solving
  its own head; its checkpoint equals the ``M = 1`` file, and each file
  restores into a Trainer at the other ``M`` and is written back bit for
  bit;
* ``M`` not dividing the world size or the headcount raises.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from _torch_dist import Ranks
from selavi_tpu.models import load_model as jax_load_model
from selavi_tpu.parallel.mesh import data_sharding, make_mesh, state_shardings
from selavi_tpu.train import optim as jax_optim
from selavi_tpu.train.state import TrainState
from selavi_tpu.train.step import make_train_step as jax_make_train_step
from selavi_tpu_torch.models.av_model import load_model
from selavi_tpu_torch.models.convert import load_jax_variables
from selavi_tpu_torch.models.heads import head_dropout, shard_rows
from selavi_tpu_torch.parallel.mesh import Grid, make_grid
from selavi_tpu_torch.train.checkpoint import CKPT_NAME
from test_torch_dist import _close, _variables

torch.set_num_threads(1)

H, K = 2, 8
BASE_LR, WD = 0.5, 1e-3
RTOL = {"float64": 1e-9, "float32": 1e-5}
FP32_RATIO = 2.0
# [name, model_axis, dtype, use_mlp, colorjitter, inputs] of each rank step:
# against M = 1, 2 rows a rank of asymmetric clips; against JAX, 1 row a
# rank of flip-invariant clips (the 4 rows of tests/test_torch_dist.py's
# comparison with JAX's data mesh)
STEPS = [[f"m{m}_{dtype}", m, dtype, True, True, "asym"]
         for dtype in RTOL for m in (1, 2)]
JAX_STEP = ["m2_linear", 2, "float64", False, False, "sym"]
ROWS = {"asym": 2, "sym": 1}
# The CLI runs skip the BN warmup, as chip_smoke.py's DIST_ARGS do: the
# heads' warmup statistics are fp32 sums over the data group at M = 2 and
# over all ranks at M = 1, and at this size the SK step's matching is
# decided by near-ties of saturated softmaxes that such last bits move
# (with one warmup batch one perm swapped two clusters). The warmup is
# held on its own (test_bn_warmup_equals_model_axis_1). The epoch is one
# step of the 16 samples: at these widths a second fp32 step grows last
# bits into percents of some BatchNorm biases of the towers' last blocks
# (at M = 1 as well, from a change in the heads' last bits), so the files
# are compared after one.
CLI_ARGS = "--distribution gauss --bn_warmup_batches 0 --batch_size 4"


# ------------------------------------------------------------ the masks

@pytest.mark.parametrize("world,model_axis", [(2, 2), (4, 2), (4, 4)])
def test_owned_masks_are_the_one_process_masks(world, model_axis):
    heads, rows, width = 4, 3, 5
    total = rows * world
    full = head_dropout(torch.ones(heads, total, width), 0.3,
                        torch.Generator().manual_seed(1), (0, heads),
                        shard_rows(total))
    for rank in range(world):
        # M = 1: every head, rows rank::world
        index, n = shard_rows(rows, (rank, world))
        one = head_dropout(torch.ones(heads, rows, width), 0.3,
                           torch.Generator().manual_seed(1), (0, heads),
                           (index, n))
        assert torch.equal(one, full[:, index])
        d, m = divmod(rank, model_axis)
        grid = Grid(rank, world, model_axis, d, m, None, None)
        first, count = grid.heads(heads)
        gathered = grid.gathered_rows(rows)
        # the data row's ranks' rows, in gather order
        assert gathered.tolist() == [
            i * world + d * model_axis + j
            for j in range(model_axis) for i in range(rows)]
        own = head_dropout(torch.ones(count, rows * model_axis, width), 0.3,
                           torch.Generator().manual_seed(1), (first, heads),
                           (gathered, n))
        assert torch.equal(own, full[first:first + count][:, gathered])


# ------------------------------------------------------------ the steps

def _global_batch(rows, symmetric, seed):
    rng = np.random.default_rng(seed)
    shape = (rows, 4, 32, 32, 3)
    if symmetric:  # mirror-symmetric along W: the flip draw cannot matter
        half = rng.integers(0, 256, size=(rows, 4, 32, 16, 3),
                            dtype=np.uint8)
        video = np.concatenate([half, half[:, :, :, ::-1]], axis=3)
    else:
        video = rng.integers(0, 256, size=shape, dtype=np.uint8)
    audio = rng.normal(0, 1, (rows, 40, 51, 1)).astype(np.float32)
    labels = rng.integers(0, K, size=(rows, H)).astype(np.int32)
    return video, audio, labels


def _start_steps(tmp, world, configs, variables):
    """Write the inputs and the weights (``variables[use_mlp]``) that
    ``configs`` read, and start the ranks."""
    batches = {}
    for inputs in {c[5] for c in configs}:
        batches[inputs] = _global_batch(world * ROWS[inputs], inputs == "sym",
                                        world)
        video, audio, labels = batches[inputs]
        np.savez(tmp / f"step_inputs_{inputs}.npz", video=video, audio=audio,
                 labels=labels, heads=H, k=K, lr=BASE_LR, wd=WD, seed=7)
    for use_mlp in {c[3] for c in configs}:
        kind = "mlp" if use_mlp else "linear"
        torch.save(variables[use_mlp], tmp / f"step_weights_{kind}.pt")
    return Ranks("grid_steps", world, tmp, configs=configs), batches


def _jax_grid_step(params, bs, video, audio, labels):
    """JAX's fp64 step on a 2x2 ('data', 'model') mesh, the heads sharded
    by ``state_shardings``: (loss, the new variables as an fp64 port
    state)."""
    mesh = make_mesh(jax.devices()[:4], model_axis=2)
    with jax.enable_x64(True):
        jmodel = jax_load_model(headcount=H, num_classes=K, use_mlp=False,
                                dtype=jnp.float64)
        jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        tx = jax_optim.make_optimizer(BASE_LR, WD, warmup_epochs=10,
                                      batches_per_epoch=1)
        state = TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                           batch_stats=bs, opt_state=tx.init(jparams), tx=tx)
        shardings = state_shardings(mesh, state, H)
        proj = shardings.params["heads_v"]["heads"]["proj"]["kernel"]
        assert proj == NamedSharding(mesh, P("model"))
        state = jax.device_put(state, shardings)
        dsh = data_sharding(mesh)
        jstep = jax_make_train_step(jmodel, compute_dtype=jnp.float64,
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
def runs(tmp_path_factory):
    """Every rank process of the module, started together: the 1x2 steps,
    the 2x2 steps (JAX's case among them) and the 2x2 CLI runs; JAX
    computes its own 2x2 step meanwhile."""
    tmpc = tmp_path_factory.mktemp("grid_cli")
    ranksc = Ranks("grid_cli", 4, tmpc, extra=CLI_ARGS)
    tmp2 = tmp_path_factory.mktemp("grid_steps_2")
    tmp4 = tmp_path_factory.mktemp("grid_steps_4")
    variables = {use_mlp: _variables(use_mlp) for use_mlp in (True, False)}
    ranks2, _ = _start_steps(tmp2, 2, STEPS, variables)
    ranks4, batches = _start_steps(tmp4, 4, STEPS + [JAX_STEP], variables)
    params, bs = variables[False]
    jax_out = _jax_grid_step(params, bs, *batches["sym"])
    before = load_model(headcount=H, num_classes=K, use_mlp=False,
                        device="cpu")
    load_jax_variables(before, params, bs)
    out = {2: ranks2.results(timeout=300), 4: ranks4.results(timeout=300),
           "cli": ranksc.results(timeout=300)}
    out["jax"] = (jax_out, before.to(torch.float64).state_dict())
    files = {}
    for name in ("dump1", "dump2", "cross1", "cross2"):
        files[name] = torch.load(tmpc / name / CKPT_NAME, map_location="cpu",
                                 weights_only=True)
    out["files"] = files
    for tmp in (tmp2, tmp4, tmpc):
        shutil.rmtree(tmp)
    return out


@pytest.fixture(scope="module")
def grid_steps(runs):
    return runs


@pytest.mark.parametrize("dtype", sorted(RTOL))
@pytest.mark.parametrize("world", [2, 4])
def test_step_equals_model_axis_1_on_the_same_ranks(grid_steps, world,
                                                    dtype):
    ranks = grid_steps[world]
    rtol = RTOL[dtype]
    one, two = ranks[0][f"m1_{dtype}"], ranks[0][f"m2_{dtype}"]
    assert one["net"] == "DistributedDataParallel"
    assert two["net"] == "GridParallel"
    # the global loss, on every rank
    for r in ranks:
        np.testing.assert_allclose(r[f"m2_{dtype}"]["loss"], one["loss"],
                                   rtol=rtol)
    # rank 0's comparison of every parameter's change, BN statistic and
    # momentum, the heads gathered (data row 0), with M = 1's:
    # _close(got, ref, rtol). In fp32 a BN scale's gradient in the towers'
    # last blocks sums products that nearly cancel (BatchNorm over 4 to 16
    # rows), and the two steps round apart by up to 2.4e-5 of scale, as
    # far as each is from the fp64 step: such a tensor is held to be no
    # farther from the fp64 step than FP32_RATIO times the M = 1 step.
    diffs = dict(two["vs_m1"])
    assert diffs.pop("keys") == (True, True)
    assert len(diffs) > 100 and any("heads_v.bn" in k for k in diffs)
    for name, err in diffs.items():
        assert err <= rtol or (
            dtype == "float32" and two["vs_fp64"][name]
            <= FP32_RATIO * two["fp32_error"][name]), (
                name, err, two.get("vs_fp64", {}).get(name),
                two.get("fp32_error", {}).get(name))


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_hold_and_optimize_their_heads_only(grid_steps, world):
    ranks = grid_steps[world]
    for dtype in RTOL:
        towers = [r[f"m2_{dtype}"]["towers"] for r in ranks]
        assert all(t == towers[0] for t in towers)  # DDP over all ranks
        for rank, r in enumerate(ranks):
            res = r[f"m2_{dtype}"]
            first = rank % 2  # M = 2: the model index
            for name, value in res["heads"].items():
                assert value.shape[0] == H // 2, name
                # the same heads in a model column hold the same values
                assert torch.equal(value,
                                   ranks[first][f"m2_{dtype}"]["heads"][name])
                if name in res["moment_shapes"]:
                    assert res["moment_shapes"][name] == value.shape
            assert set(res["moment_shapes"]) == {
                n for n in res["heads"] if "running" not in n}
            full = r[f"m1_{dtype}"]["heads"]["heads_v.proj_weight"]
            assert full.shape[0] == H


def test_two_by_two_step_matches_jax_on_a_two_by_two_mesh(grid_steps):
    (jloss, ref), before = grid_steps["jax"]
    got = grid_steps[4][0][JAX_STEP[0]]
    np.testing.assert_allclose(got["loss"], jloss, rtol=1e-6)
    for name, value in got["full"].items():
        if "running" in name:
            _close(value, ref[name], 1e-4)
        else:
            _close(value - before[name], ref[name] - before[name], 1e-4)


# ------------------------------------------------- the SK step, the file

@pytest.fixture(scope="module")
def grid_cli(runs):
    return runs["cli"], runs["files"]


def test_sk_step_keeps_every_rank_equal_to_model_axis_1(grid_cli):
    ranks, _ = grid_cli
    ref = ranks[0][1]
    assert ref["exit"] is None and ref["net"] == "DistributedDataParallel"
    assert len(ref["sk"]) == 1 and len(ref["perms"]) == H
    for r in ranks:
        for m in (1, 2):
            got = r[m]
            np.testing.assert_array_equal(got["labels"], ref["labels"])
            np.testing.assert_array_equal(got["dists"], ref["dists"])
            assert got["rng"] == ref["rng"]
            assert got["perms"] == ref["perms"]
            assert got["sk"] == ref["sk"]
        # each rank solves its own head at M = 2, every head at M = 1
        assert r[1]["solves"] == H and r[2]["solves"] == H // 2
        assert r[2]["net"] == "GridParallel"
        assert all(shape[0] == H // 2
                   for shape in r[2]["head_shapes"].values())
    assert all(len(np.unique(ref["labels"][:, h])) > 1 for h in range(H))


def test_bn_warmup_equals_model_axis_1(grid_cli):
    ranks, _ = grid_cli
    warmup = ranks[0]["warmup"]
    assert any(k.startswith("heads_v.") for k in warmup)
    for name, err in warmup.items():
        assert err <= RTOL["float32"], (name, err)


def _assert_files_equal(a, b, rtol=None):
    for part in ("model", "optimizer"):
        assert a[part].keys() == b[part].keys()
    assert a["model"].keys() == b["model"].keys()
    for name, value in a["model"].items():
        if rtol is None:
            assert torch.equal(value, b["model"][name]), name
        else:
            _close(value, b["model"][name], rtol)
    assert a["optimizer"]["state"].keys() == b["optimizer"]["state"].keys()
    for i, state in a["optimizer"]["state"].items():
        for key, value in state.items():
            if rtol is None:
                assert torch.equal(value, b["optimizer"]["state"][i][key])
            else:
                _close(value, b["optimizer"]["state"][i][key], rtol)
    for key in ("selflabels", "epoch", "step", "sk_counter"):
        assert torch.equal(torch.as_tensor(a[key]), torch.as_tensor(b[key]))
    assert torch.equal(a["dist"]["dists"], b["dist"]["dists"])


def test_checkpoint_is_the_model_axis_1_file(grid_cli):
    _, files = grid_cli
    one, two = files["dump1"], files["dump2"]
    assert two["model"]["heads_v.proj_weight"].shape[0] == H
    # the same steps, the reductions in another order: fp32
    _assert_files_equal(two, one, RTOL["float32"])


@pytest.mark.parametrize("written,restored", [(1, 2), (2, 1)])
def test_checkpoint_resumes_across_model_axis(grid_cli, written, restored):
    ranks, files = grid_cli
    for r in ranks:
        cross = r[f"cross{restored}"]
        assert cross["restored_equal"]
        assert cross["epoch"] == 1 and cross["step"] == 1
    # restored at the other M and written back: the same file
    _assert_files_equal(files[f"cross{restored}"], files[f"dump{written}"])


# ------------------------------------------------------------ refusals

def test_model_axis_must_divide_the_world_size():
    with pytest.raises(ValueError,
                       match="--model_axis 2 must divide the world size 1"):
        make_grid(2, headcount=2)


def test_model_axis_must_divide_the_headcount():
    with pytest.raises(ValueError,
                       match="--model_axis 4 must divide --headcount 10"):
        make_grid(4, headcount=10)
