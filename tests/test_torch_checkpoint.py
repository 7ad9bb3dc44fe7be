"""The port's checkpoints and weight export against the JAX package's, on
the CPU.

* ``train/checkpoint.py``: the host fields and the archive rule against
  ``selavi_tpu/train/checkpoint.py::save_checkpoint`` (a one-leaf
  ``TrainState`` over ``optax.sgd`` on the JAX side); a bit-exact round
  trip into a fresh Trainer; the host snapshot of an async save; the SK
  schedule's fast-forward on resume against JAX's rule
  (``selavi_tpu/train/loop.py::Trainer.resume``).
* ``models/convert.py::export_jax_variables`` and
  ``train/torch_export.py``: the flax trees back bit for bit, the
  reference state_dict equal to JAX's exporter's, and JAX's importer of
  the exported file giving back the trees.

Every comparison is exact: the values are copied, never computed.
"""

import math
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import serialization

from _torch_tmp import tmp_path  # noqa: F401
from selavi_tpu.models import load_model as jax_load_model
from selavi_tpu.selflabel.marginals import MarginalState as JaxMarginalState
from selavi_tpu.selflabel.schedule import (
    fast_forward_schedule as jax_fast_forward_schedule,
    make_sk_schedule as jax_make_sk_schedule,
)
from selavi_tpu.train import checkpoint as jax_checkpoint
from selavi_tpu.train.state import SelfLabelState as JaxSelfLabelState
from selavi_tpu.train.state import TrainState
from selavi_tpu.train.torch_export import (
    export_reference_state_dict as jax_export_reference_state_dict,
)
from selavi_tpu.train.torch_import import import_reference_checkpoint
from selavi_tpu_torch.config import parse_arguments
from selavi_tpu_torch.data.synthetic import SyntheticAVDataset
from selavi_tpu_torch.models.av_model import load_model
from selavi_tpu_torch.models.convert import (
    export_jax_variables,
    load_jax_variables,
)
from selavi_tpu_torch.selflabel.marginals import MarginalState
from selavi_tpu_torch.train import checkpoint
from selavi_tpu_torch.train import torch_export
from selavi_tpu_torch.train.loop import Trainer
from selavi_tpu_torch.train.state import SelfLabelState

torch.set_num_threads(1)

N, H, K = 16, 2, 8
TINY = (
    "--ds_name synthetic --num_data_samples 16 --mlp_dim 8 --headcount 2 "
    "--epochs 1 --batch_size 4 --num_frames 4 --train_crop_size 32 "
    "--aud_sample_rate 16000 --aud_spec_type 1 --nopts 1 --match true "
    "--bn_warmup_batches 1 --workers 0 --compute_dtype float32 "
    "--sk_agg_batch 8 --base_lr 0.01 --wd 0.00001"
)


@pytest.fixture(autouse=True)
def _delete_checkpoints(tmp_path):
    """A checkpoint of the full-width towers takes ~300 MB."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _trainer(tmp_path, extra=""):
    args = parse_arguments().parse_args(
        TINY.split() + extra.split() + ["--dump_path", str(tmp_path)])
    dataset = SyntheticAVDataset(
        num_samples=args.num_data_samples, num_classes=4,
        num_frames=args.num_frames, crop_size=args.train_crop_size,
        aud_sample_rate=args.aud_sample_rate,
        aud_spec_type=args.aud_spec_type, seed=args.seed)
    return Trainer(args, dataset, device="cpu")


def _host_fields(seed, with_dists):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, K, (N, H)).astype(np.int32)
    dists = rng.uniform(0.5, 1.5, (H, K)) * N / K if with_dists else None
    return labels, dists


# ---------------------------------------------------------------- the file

@pytest.mark.parametrize("with_dists", [True, False])
@pytest.mark.parametrize("completed", [True, False])
def test_host_fields_match_jax(tmp_path, completed, with_dists):
    labels, dists = _host_fields(0, with_dists)
    epoch, step, sk_counter = 2, 7, 3
    resume_epoch = epoch + 1 if completed else epoch

    tx = optax.sgd(0.1, momentum=0.9)
    params = {"w": jnp.arange(3, dtype=jnp.float32)}
    state = TrainState(step=jnp.asarray(step, jnp.int32), params=params,
                       batch_stats={}, opt_state=tx.init(params), tx=tx)
    jax_sl = JaxSelfLabelState(labels, JaxMarginalState(dists), sk_counter)
    jax_checkpoint.save_checkpoint(str(tmp_path / "jax"), state, jax_sl,
                                   epoch, resume_epoch=resume_epoch)
    with open(tmp_path / "jax" / jax_checkpoint.CKPT_NAME, "rb") as f:
        ref = pickle.load(f)
    ref_step = serialization.msgpack_restore(ref["device"])["step"]

    model = torch.nn.Linear(3, 2)
    optimizer = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    sl = SelfLabelState(labels, MarginalState(dists), sk_counter)
    checkpoint.save_checkpoint(str(tmp_path / "port"), model, optimizer, sl,
                               epoch, step=step, resume_epoch=resume_epoch)
    got = torch.load(tmp_path / "port" / checkpoint.CKPT_NAME,
                     weights_only=True)

    assert got["epoch"] == ref["epoch"] == resume_epoch
    assert got["sk_counter"] == ref["sk_counter"] == sk_counter
    assert got["step"] == int(ref_step) == step
    assert got["selflabels"].dtype == torch.int32
    np.testing.assert_array_equal(got["selflabels"].numpy(), ref["selflabels"])
    if with_dists:
        assert got["dist"]["dists"].dtype == torch.float64
        np.testing.assert_array_equal(got["dist"]["dists"].numpy(),
                                      ref["dist"]["dists"])
    else:
        assert got["dist"] == ref["dist"] == {"dists": None}
    assert set(got) == {"epoch", "selflabels", "dist", "sk_counter", "step",
                        "model", "optimizer"}


@pytest.mark.parametrize("freq,epochs", [(1, 3), (2, 5), (5, 7), (3, 3)])
def test_archive_rule_matches_jax(tmp_path, freq, epochs):
    labels, dists = _host_fields(1, True)
    tx = optax.sgd(0.1)
    params = {"w": jnp.zeros(2)}
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats={}, opt_state=tx.init(params), tx=tx)
    model = torch.nn.Linear(2, 1)
    optimizer = torch.optim.SGD(model.parameters(), lr=0.1)
    archived = {}
    for side in ("jax", "port"):
        dump = tmp_path / side
        (dump / "checkpoints").mkdir(parents=True)
        for epoch in range(epochs):
            kw = dict(checkpoint_freq=freq, total_epochs=epochs,
                      dump_checkpoints=str(dump / "checkpoints"))
            # a mid-epoch save, then the completed epoch's
            for resume in (epoch, epoch + 1):
                if side == "jax":
                    jax_checkpoint.save_checkpoint(
                        str(dump), state,
                        JaxSelfLabelState(labels, JaxMarginalState(dists)),
                        epoch, resume_epoch=resume, **kw)
                else:
                    checkpoint.save_checkpoint(
                        str(dump), model, optimizer,
                        SelfLabelState(labels, MarginalState(dists)), epoch,
                        resume_epoch=resume, **kw)
        archived[side] = sorted(
            int(name.split("-")[1].split(".")[0])
            for name in os.listdir(dump / "checkpoints"))
    assert archived["port"] == archived["jax"]
    assert archived["port"][-1] == epochs - 1 and 0 in archived["port"]


def _train_a_little(trainer, seed):
    """One SGD step on seeded gradients (fills the momentum buffers), and
    host state worth restoring."""
    g = torch.Generator().manual_seed(seed)
    for p in trainer.model.parameters():
        p.grad = torch.randn(p.shape, generator=g)
    trainer.optimizer.step()
    trainer.optimizer.zero_grad(set_to_none=True)
    with torch.no_grad():
        for name, b in trainer.model.named_buffers():
            b.add_(torch.rand(b.shape, generator=g))
    labels, dists = _host_fields(seed, True)
    trainer.sl_state = SelfLabelState(labels, MarginalState(dists), 4)
    trainer.step = 9


def _assert_same_state(trainer, ref_model, ref_opt):
    got = trainer.model.state_dict()
    for key, value in ref_model.items():
        assert torch.equal(got[key], value), key
    got_opt = trainer.optimizer.state_dict()
    assert got_opt["param_groups"] == ref_opt["param_groups"]
    assert set(got_opt["state"]) == set(ref_opt["state"]) != set()
    params = list(trainer.model.parameters())
    for idx, s in ref_opt["state"].items():
        buf = got_opt["state"][idx]["momentum_buffer"]
        assert buf.device == params[idx].device
        assert torch.equal(buf, s["momentum_buffer"]), idx


@pytest.mark.parametrize("async_write", [True, False])
def test_round_trip_into_a_fresh_trainer(tmp_path, async_write):
    trainer = _trainer(tmp_path, "--epochs 3")
    _train_a_little(trainer, seed=3)
    ref_model = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    ref_opt = trainer.optimizer.state_dict()
    ref_opt["state"] = {i: {"momentum_buffer": s["momentum_buffer"].clone()}
                        for i, s in ref_opt["state"].items()}
    trainer.args.async_checkpoint = async_write
    trainer.checkpoint(1)
    checkpoint.wait_for_pending_checkpoint()
    assert sorted(os.listdir(tmp_path)) == [checkpoint.CKPT_NAME]  # no .tmp

    fresh = _trainer(tmp_path, "--epochs 3")
    assert not torch.equal(fresh.model.heads_v.proj_weight,
                           ref_model["heads_v.proj_weight"])
    assert fresh.resume() == 2
    _assert_same_state(fresh, ref_model, ref_opt)
    assert fresh.step == 9
    assert fresh.sl_state.selflabels.dtype == np.int32
    np.testing.assert_array_equal(fresh.sl_state.selflabels,
                                  trainer.sl_state.selflabels)
    assert fresh.sl_state.marginals.dists.dtype == np.float64
    np.testing.assert_array_equal(fresh.sl_state.marginals.dists,
                                  trainer.sl_state.marginals.dists)
    assert fresh.sl_state.epoch == 2
    # restore_checkpoint also takes the file's path, and a missing file
    # changes nothing
    sl, start, step = checkpoint.restore_checkpoint(
        str(tmp_path / checkpoint.CKPT_NAME), fresh.model, fresh.optimizer,
        fresh.sl_state, 0)
    assert (start, step, sl.sk_counter) == (2, 9, 4)
    empty = SelfLabelState.init(N, H)
    assert checkpoint.restore_checkpoint(
        str(tmp_path / "none"), fresh.model, fresh.optimizer, empty, 5) == (
        empty, 0, 5)


def test_async_save_snapshots_before_it_returns(tmp_path):
    trainer = _trainer(tmp_path)
    _train_a_little(trainer, seed=4)
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    buffers = [s["momentum_buffer"].clone()
               for s in trainer.optimizer.state_dict()["state"].values()]
    checkpoint.save_checkpoint(
        str(tmp_path), trainer.model, trainer.optimizer, trainer.sl_state, 0,
        async_write=True)
    with torch.no_grad():  # the next step's in-place updates
        for p in trainer.model.parameters():
            p.add_(1.0)
            trainer.optimizer.state[p]["momentum_buffer"].mul_(-1.0)
    checkpoint.wait_for_pending_checkpoint()
    saved = torch.load(tmp_path / checkpoint.CKPT_NAME, weights_only=True)
    for key, value in before.items():
        assert torch.equal(saved["model"][key], value), key
    for i, buf in enumerate(buffers):
        assert torch.equal(saved["optimizer"]["state"][i]["momentum_buffer"],
                           buf)
    assert checkpoint.timings[-1]["bytes"] == os.path.getsize(
        tmp_path / checkpoint.CKPT_NAME)


@pytest.mark.parametrize("start_epoch", [0, 1, 2])
def test_resume_fast_forwards_the_schedule_as_jax(tmp_path, start_epoch):
    extra = "--epochs 3 --nopts 4"
    trainer = _trainer(tmp_path, extra)
    saved_counter = 1
    trainer.sl_state.sk_counter = saved_counter
    trainer.checkpoint(start_epoch, completed=False)  # stamps start_epoch
    checkpoint.wait_for_pending_checkpoint()

    fresh = _trainer(tmp_path, extra)
    assert fresh.resume() == start_epoch
    # selavi_tpu/train/loop.py::Trainer.resume
    bpe = fresh.batches_per_epoch
    schedule = jax_make_sk_schedule(3, bpe, 4, fresh.args.schedulepower)
    counter = saved_counter
    if start_epoch != 0:
        schedule, done = jax_fast_forward_schedule(schedule, bpe, start_epoch)
        counter = max(counter, done)
    assert fresh.sk_schedule == schedule
    assert fresh.sl_state.sk_counter == counter
    assert len(schedule) == {0: 5, 1: 3, 2: 2}[start_epoch]


# ----------------------------------------------------------------- export

def _random_variables(shapes, seed):
    """Numpy weights of the flax shapes: fan-in scaled kernels, non-trivial
    BN affine and running statistics."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        keys = [getattr(p, "key", None) for p in path]
        name = keys[-1]
        if name == "kernel":
            fan_in = s.shape[-2] if "heads" in keys else math.prod(s.shape[:-1])
            return rng.normal(0, math.sqrt(2.0 / fan_in), s.shape)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape)
        return rng.normal(0, 0.1, s.shape)  # bias, mean

    out = jax.tree_util.tree_map_with_path(fill, shapes)
    return jax.tree.map(lambda a: np.asarray(a, np.float32), out)


def _jax_trees(seed=0, **kw):
    model = jax_load_model(headcount=H, num_classes=K, **kw)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((2, 4, 32, 32, 3)), jnp.zeros((2, 40, 51, 1)),
        train=False))
    variables = _random_variables(shapes, seed)
    return variables["params"], variables.get("batch_stats", {})


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_same_trees(got, ref):
    got, ref = _leaves(got), _leaves(ref)
    assert set(got) == set(ref)
    for key in ref:
        assert got[key].dtype == ref[key].dtype == np.float32, key
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


@pytest.mark.parametrize("use_mlp", [True, False])
def test_export_jax_variables_inverts_load(use_mlp):
    params, batch_stats = _jax_trees(use_mlp=use_mlp)
    model = load_model(headcount=H, num_classes=K, use_mlp=use_mlp,
                       device="cpu")
    load_jax_variables(model, params, batch_stats)
    got_params, got_stats = export_jax_variables(model)
    _assert_same_trees(got_params, params)
    _assert_same_trees(got_stats, batch_stats)

    # and back into a fresh module, bit for bit
    fresh = load_model(headcount=H, num_classes=K, use_mlp=use_mlp, seed=1,
                       device="cpu")
    load_jax_variables(fresh, got_params, got_stats)
    ref = model.state_dict()
    for key, value in fresh.state_dict().items():
        assert torch.equal(value, ref[key]), key


@pytest.mark.parametrize("use_mlp", [True, False])
def test_reference_state_dict_matches_jax_exporter(use_mlp):
    params, batch_stats = _jax_trees(seed=1, use_mlp=use_mlp)
    model = load_model(headcount=H, num_classes=K, use_mlp=use_mlp,
                       device="cpu")
    load_jax_variables(model, params, batch_stats)
    got = torch_export.export_reference_state_dict(
        *export_jax_variables(model), H, use_mlp=use_mlp)
    ref = jax_export_reference_state_dict(params, batch_stats, H,
                                          use_mlp=use_mlp)
    assert list(got) == list(ref)
    for key, value in ref.items():
        assert got[key].dtype == value.dtype, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_exported_checkpoint_imports_into_jax(tmp_path):
    params, batch_stats = _jax_trees(seed=2)
    model = load_model(headcount=H, num_classes=K, device="cpu")
    load_jax_variables(model, params, batch_stats)
    optimizer = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    labels, dists = _host_fields(2, True)
    checkpoint.save_checkpoint(
        str(tmp_path), model, optimizer,
        SelfLabelState(labels, MarginalState(dists), 2), 4)
    out = str(tmp_path / "reference.pth.tar")
    torch_export.main([str(tmp_path / checkpoint.CKPT_NAME), out])

    got_params, got_stats = import_reference_checkpoint(out, headcount=H)
    _assert_same_trees(got_params, params)
    _assert_same_trees(got_stats, batch_stats)
    blob = torch.load(out, weights_only=True)
    assert set(blob) == {"epoch", "dist", "model", "selflabels"}
    assert blob["epoch"] == 5
    np.testing.assert_array_equal(blob["selflabels"].numpy(), labels)
    assert [d.shape for d in blob["dist"]] == [(K, 1)] * H
    np.testing.assert_array_equal(
        np.concatenate([d.numpy().T for d in blob["dist"]]), dists)


@pytest.mark.parametrize("mode", ["parity", "aligned"])
def test_export_rebuilds_the_architecture_and_warns_for_aligned(mode, caplog):
    model = load_model(headcount=3, num_classes=5, aud_base_arch="resnet18",
                       use_mlp=False, midplanes_mode=mode, device="cpu")
    rebuilt = torch_export.model_for_state_dict(model.state_dict())
    assert (rebuilt.heads_v.headcount, rebuilt.heads_v.use_mlp) == (3, False)
    assert len(rebuilt.audio_network.blocks) == 8
    for key, value in model.state_dict().items():
        assert torch.equal(rebuilt.state_dict()[key], value), key
    with caplog.at_level("WARNING", logger=torch_export.__name__):
        torch_export.export_reference_state_dict(
            *export_jax_variables(rebuilt), 3, use_mlp=False,
            audio_stage_blocks=(2, 2, 2, 2))
    warned = [r for r in caplog.records if "midplanes" in r.getMessage()]
    assert len(warned) == (mode == "aligned")
