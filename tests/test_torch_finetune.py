"""The port's action-recognition finetuning against the JAX package's, on
the CPU.

* ``finetune_lr_factor`` and the five schedulers of ``train/optim.py``
  against JAX's over a grid of epochs and metric sequences, exactly;
  ``ReduceOnPlateau`` also against ``torch.optim.lr_scheduler.
  ReduceLROnPlateau`` (LR 1, factors that are powers of two: exact);
* the ``FinetuneModel`` forward in eval mode for each of ``use_bn``,
  ``use_l2_norm`` and ``use_dropout``, with the same weights (moved by
  ``load_jax_finetune_variables``), within 1e-4 of the logits' scale (fp32,
  sums in another order);
* three optimizer steps across the warmup (factors 1, 4.5, 8), SGD and
  Adam, with and without ``feature_extract``, from the same gradients: the
  parameters within 1e-5 of each tensor's largest (fp32, rounded in
  another order; Adam's bias corrections),
  ``final_bn``'s parameters (and the tower's under ``feature_extract``)
  unchanged, each group's LR per step equal to JAX's schedule, across a
  resume too;
* one train step of the model in fp64 on both sides (SGD, with and
  without ``feature_extract``): the loss to 1e-5, every update within 1e-4
  of the largest in the tower (or the head), the BN statistics of every
  module, frozen ones included, within 1e-4 of scale (see
  ``MODEL_STEP_RTOL`` for why not per tensor, and why one step);
* ``evaluate`` on the same logit stream (ties included), exactly;
* ``load_pretrained_tower`` from a checkpoint that the Trainer's
  ``save_checkpoint`` wrote, bit for bit, and its refusal of a tower of
  other widths before any copy;
* ``cli.finetune_video --test_only true`` against root
  ``finetune_video.py`` on the same tower and classifier, on the synthetic
  set and on a UCF-layout tree of cv2 mp4s (``scripts/make_real_media.py
  --layout ucf``): the same fold line;
* a run of two epochs against one epoch and a ``--resume``: bit for bit.
"""

import logging
import math
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import finetune_video as jax_cli
from selavi_tpu.eval import finetune as jax_ft
from selavi_tpu.train import optim as jax_optim
from selavi_tpu_torch.cli import finetune_video
from selavi_tpu_torch.eval import finetune as ft
from selavi_tpu_torch.eval import finetune_runner
from selavi_tpu_torch.models.av_model import load_model
from selavi_tpu_torch.models.convert import load_jax_finetune_variables
from selavi_tpu_torch.ops.preprocess import normalize_video
from selavi_tpu_torch.selflabel.marginals import MarginalState
from selavi_tpu_torch.train import optim
from selavi_tpu_torch.train.checkpoint import save_checkpoint
from selavi_tpu_torch.train.state import SelfLabelState

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NC = 5
VIDEO = (4, 4, 32, 32, 3)
LOGIT_RTOL = 1e-4  # of max |logit|: fp32 towers, sums in another order


# ------------------------------------------------------------ schedules

def test_finetune_lr_factor_matches_jax():
    for use_scheduler in (True, False):
        for warm in (0, 1, 2, 5):
            for milestones in ((6, 10), (3,), (2, 4, 8)):
                for gamma in (0.05, 0.1, 0.5):
                    for epoch in range(16):
                        args = (epoch, warm, milestones, gamma, 8.0,
                                use_scheduler)
                        assert ft.finetune_lr_factor(*args) == (
                            jax_ft.finetune_lr_factor(*args))
    cfg = ft.FinetuneConfig(epochs=12)
    np.testing.assert_array_equal(ft.lr_factor_table(cfg), np.asarray(
        [jax_ft.finetune_lr_factor(e, 2, (6, 10), 0.05) for e in range(13)],
        np.float32))


def test_warmup_chain_and_multistep_match_jax():
    for mult in (1.0, 2.0, 8.0):
        for total in (1, 3, 10):
            for after in (None, (2, 5)):
                kw = dict(base_lr=0.1, multiplier=mult, total_epoch=total)
                ours = optim.GradualWarmupChain(
                    after=after and optim.multistep_factor(after, 0.1), **kw)
                ref = jax_optim.GradualWarmupChain(
                    after=after and jax_optim.multistep_factor(after, 0.1),
                    **kw)
                assert [ours.lr(e) for e in range(20)] == [
                    ref.lr(e) for e in range(20)]
    with pytest.raises(ValueError, match="multiplier"):
        optim.GradualWarmupChain(0.1, multiplier=0.5)


def _metric_sequences():
    rng = np.random.default_rng(0)
    return [
        [1.0] * 30,  # a flat plateau
        list(np.linspace(2.0, 0.1, 30)),  # steady progress
        [float(x) for x in rng.uniform(0.5, 1.5, 40)],
        [float(x) for x in np.r_[np.linspace(1, 0.5, 8), np.full(20, 0.5),
                                 np.linspace(0.5, 0.2, 6), np.full(20, 0.2)]],
    ]


PLATEAUS = [
    dict(),
    dict(mode="max", gamma=0.5, patience=2, cooldown=1),
    dict(gamma=0.5, patience=0, threshold=0.01, threshold_mode="abs"),
    dict(gamma=0.5, patience=3, cooldown=2, min_factor=0.125),
    dict(mode="max", gamma=0.25, patience=1, threshold=0.05,
         threshold_mode="abs"),
]


@pytest.mark.parametrize("kw", PLATEAUS, ids=range(len(PLATEAUS)))
def test_reduce_on_plateau_matches_jax_and_torch(kw):
    for metrics in _metric_sequences():
        ours, ref = optim.ReduceOnPlateau(**kw), jax_optim.ReduceOnPlateau(
            **kw)
        state, jstate = ours.init(), ref.init()
        param = torch.nn.Parameter(torch.zeros(1))
        opt = torch.optim.SGD([param], lr=1.0)
        sched = torch.optim.lr_scheduler.ReduceLROnPlateau(
            opt, mode=kw.get("mode", "min"), factor=kw.get("gamma", 0.1),
            patience=kw.get("patience", 10),
            threshold=kw.get("threshold", 1e-4),
            threshold_mode=kw.get("threshold_mode", "rel"),
            cooldown=kw.get("cooldown", 0), min_lr=kw.get("min_factor", 0.0),
            eps=0.0)  # torch skips reductions smaller than eps; ours none
        for m in metrics:
            state, jstate = ours.step(state, m), ref.step(jstate, m)
            sched.step(m)
            assert tuple(state) == tuple(jstate)
            assert state.factor == opt.param_groups[0]["lr"]
            assert state.num_bad_epochs == sched.num_bad_epochs
            assert state.cooldown_counter == sched.cooldown_counter


@pytest.mark.parametrize("mult,total", [(1.0, 3), (4.0, 2), (8.0, 5)])
def test_gradual_warmup_plateau_matches_jax(mult, total):
    kw = dict(base_lr=0.2, multiplier=mult, total_epoch=total)
    plateau = dict(gamma=0.5, patience=1)
    ours = optim.GradualWarmupPlateau(
        plateau=optim.ReduceOnPlateau(**plateau), **kw)
    ref = jax_optim.GradualWarmupPlateau(
        plateau=jax_optim.ReduceOnPlateau(**plateau), **kw)
    for metrics in _metric_sequences():
        state, jstate = ours.init(), ref.init()
        for epoch, m in enumerate(metrics):
            (state, lr), (jstate, jlr) = (ours.step(state, m, epoch),
                                          ref.step(jstate, m, epoch))
            assert lr == jlr and tuple(state) == tuple(jstate)


def test_lr_per_group_and_step_matches_jax():
    """JAX's schedule read off its optimizer (SGD, momentum 0, no decay, a
    unit gradient: the update is -lr of the step; Adam shares the
    schedule), against ``set_finetune_lr``
    step by step, and from a step restored mid-schedule."""
    cfg = ft.FinetuneConfig(num_classes=3, epochs=6, lr_warmup_epochs=2,
                            lr_milestones=(3, 5), head_lr=0.3, base_lr=0.02,
                            momentum=0.0, weight_decay=0.0, wd_base=0.0)
    bpe = 3
    tx = jax_ft.make_finetune_optimizer(cfg, batches_per_epoch=bpe)
    params = {"classifier": {"w": jnp.zeros(())}, "base": {"w": jnp.zeros(())}}
    grads = jax.tree.map(jnp.ones_like, params)
    opt_state = tx.init(params)
    jax_lrs = []
    for _ in range(24):
        updates, opt_state = tx.update(grads, opt_state, params)
        jax_lrs.append((-float(updates["classifier"]["w"]),
                        -float(updates["base"]["w"])))

    model = ft.FinetuneModel(3)
    opt = ft.make_finetune_optimizer(cfg, model)
    table = ft.lr_factor_table(cfg)
    assert [g["name"] for g in opt.param_groups] == ["head", "base"]
    for start in (0, 7):  # 7: a resume mid-epoch 2, after the warmup
        for step in range(start, 24):
            ft.set_finetune_lr(opt, table, step, bpe)
            got = tuple(g["lr"] for g in opt.param_groups)
            np.testing.assert_allclose(got, jax_lrs[step], rtol=1e-7)
            assert got == (float(np.float32(0.3) * table[min(step // bpe, 6)]),
                           float(np.float32(0.02) * table[min(step // bpe,
                                                              6)]))


# ------------------------------------------------------------ the model

def _random_variables(shapes, seed):
    rng = np.random.default_rng(seed)

    def fill(path, s):
        keys = [getattr(p, "key", None) for p in path]
        if keys[-1] == "kernel":
            return rng.normal(0, math.sqrt(2.0 / math.prod(s.shape[:-1])),
                              s.shape)
        if keys[-1] in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape)
        return rng.normal(0, 0.1, s.shape)

    out = jax.tree_util.tree_map_with_path(fill, shapes)
    return jax.tree.map(lambda a: np.asarray(a, np.float32), out)


def _jax_model(variant, dtype=jnp.float32):
    return jax_ft.FinetuneModel(num_classes=NC, dtype=dtype,
                                **{k: True for k in variant})


@pytest.fixture(scope="module")
def variables():
    """Random fp32 weights and BN statistics of the finetune model with
    ``final_bn`` (the other variants drop it)."""
    model = _jax_model(("use_bn",))
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros(VIDEO), train=False))
    return _random_variables(
        {"params": shapes["params"], "batch_stats": shapes["batch_stats"]}, 0)


def _subset(variables, variant):
    out = {c: dict(variables[c]) for c in ("params", "batch_stats")}
    if "use_bn" not in variant:
        out["params"].pop("final_bn")
        out["batch_stats"].pop("final_bn")
    return out


def _port_model(variant, variables, dtype=torch.float32):
    model = ft.FinetuneModel(NC, **{k: True for k in variant})
    v = _subset(variables, variant)
    load_jax_finetune_variables(model, v["params"], v["batch_stats"])
    return model.to(dtype)


def _video(seed):
    """uint8 clips mirror-symmetric along W, so the flip draw cannot
    matter; clip i's pixels lie in [0, 64 (i + 1)), so that the clips'
    pooled features differ well beyond their fp32 rounding (``final_bn``
    normalizes over the batch in train mode)."""
    rng = np.random.default_rng(seed)
    half = rng.integers(0, 64 * np.arange(1, VIDEO[0] + 1)[
        :, None, None, None, None], size=VIDEO[:3] + (VIDEO[3] // 2, 3))
    half = half.astype(np.uint8)
    return np.concatenate([half, half[:, :, :, ::-1]], axis=3)


def _close(ours, ref, rtol):
    ours = np.asarray(torch.as_tensor(ours).double())
    ref = np.asarray(torch.as_tensor(ref).double())
    scale = max(float(np.abs(ref).max()), 1e-12)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("variant", [(), ("use_bn",), ("use_l2_norm",),
                                     ("use_dropout",)],
                         ids=["plain", "use_bn", "use_l2_norm",
                              "use_dropout"])
def test_forward_matches_jax_in_eval_mode(variables, variant):
    video = _video(0)
    jmodel = _jax_model(variant)
    normalized = ((video.astype(np.float32) / 255.0 - 0.45) / 0.225)
    ref = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        _subset(variables, variant), normalized))
    model = _port_model(variant, variables).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(normalized)).numpy()
    assert got.shape == (VIDEO[0], NC)
    _close(got, ref, LOGIT_RTOL)
    # train mode draws the dropout mask from the generator given
    if "use_dropout" in variant:
        model.train()
        with pytest.raises(ValueError, match="generator"):
            model(torch.from_numpy(normalized))


STEPS = 3  # LR factors 1, 4.5 and 8 (warmup 2, one batch an epoch)
# of max |parameter|: fp32 parameters and updates rounded in another order,
# and Adam's bias corrections, fp32 in optax and fp64 in torch (1e-5 of an
# update); the three updates add up to 1e-3 of the largest parameter or
# more, so this holds each update to 1e-2 of itself or better
OPT_RTOL = 1e-5


def _config(optim_name, feature_extract, **kw):
    return ft.FinetuneConfig(num_classes=NC, epochs=4, lr_warmup_epochs=2,
                             optim_name=optim_name, use_bn=True,
                             feature_extract=feature_extract, **kw)


def _frozen(name, feature_extract):
    return name.startswith("final_bn.") or (feature_extract
                                            and name.startswith("base."))


@pytest.mark.parametrize("feature_extract", [False, True],
                         ids=["finetune", "feature_extract"])
@pytest.mark.parametrize("optim_name", ["sgd", "adam"])
def test_optimizer_steps_match_jax(variables, optim_name, feature_extract):
    """The two groups' updates over three steps across the warmup, from the
    same gradients (random, one tree a step) in both packages."""
    cfg = _config(optim_name, feature_extract)
    rng = np.random.default_rng(2)
    grads = [jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
        np.float32), variables["params"]) for _ in range(STEPS)]
    tx = jax_ft.make_finetune_optimizer(jax_ft.FinetuneConfig(**vars(cfg)),
                                        batches_per_epoch=1)
    params = jax.tree.map(jnp.asarray, variables["params"])
    opt_state = tx.init(params)
    for g in grads:
        updates, opt_state = tx.update(g, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
    ref_model = _port_model(("use_bn",), variables)
    load_jax_finetune_variables(ref_model, jax.tree.map(np.asarray, params),
                                variables["batch_stats"])
    ref = ref_model.state_dict()

    model = _port_model(("use_bn",), variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = ft.make_finetune_optimizer(cfg, model)
    table = ft.lr_factor_table(cfg)
    grad_model = _port_model(("use_bn",), variables)
    lrs = []
    for step, g in enumerate(grads):
        load_jax_finetune_variables(grad_model, g, variables["batch_stats"])
        for (name, p), gp in zip(model.named_parameters(),
                                 grad_model.parameters()):
            p.grad = gp.detach().clone() if p.requires_grad else None
        ft.set_finetune_lr(opt, table, step, 1)
        lrs.append([g["lr"] for g in opt.param_groups])
        opt.step()
    factors = (1.0, 4.5, 8.0)
    want = [[float(np.float32(cfg.head_lr) * np.float32(f))]
            + ([] if feature_extract else
               [float(np.float32(cfg.base_lr) * np.float32(f))])
            for f in factors]
    assert lrs == want
    for name, value in model.state_dict().items():
        if "running" in name:
            assert torch.equal(value, before[name])
        elif _frozen(name, feature_extract):
            assert torch.equal(value, before[name]), name
            assert torch.equal(ref[name], before[name]), name
        else:
            _close(value, ref[name], OPT_RTOL)
            assert not torch.equal(value, before[name]), name


# One fp64 step of the model: the fp32 roundings both packages keep (the
# clip, the pooled features, the cross-entropy) enter the backward, and at
# this size the layer4 BN gradients are near-cancelling sums over 16 values
# a channel, so their per-tensor error reaches a few percent while the
# error of every update stays under 1e-4 of the largest update of the tower
# (3.3e-5 measured for SGD from JAX's init). A second step at the finetune
# learning rates already moves the two trajectories apart by percents, so
# the multi-step comparison is the optimizer's, above, from equal
# gradients. Adam's first update, lr * g / |g|, turns the noise of
# near-zero gradients into sign flips, so the model step is held for SGD.
MODEL_STEP_RTOL = 1e-4  # of the largest update in the tower / the head


@pytest.mark.parametrize("feature_extract", [False, True],
                         ids=["finetune", "feature_extract"])
def test_model_step_matches_jax_fp64(feature_extract):
    cfg = _config("sgd", feature_extract)
    jmodel = _jax_model(("use_bn",))
    init = jmodel.init({"params": jax.random.PRNGKey(0),
                        "dropout": jax.random.PRNGKey(1)},
                       jnp.zeros(VIDEO), train=False)
    init = jax.tree.map(np.asarray, {"params": dict(init["params"]),
                                     "batch_stats": dict(init["batch_stats"])})
    video = _video(0)
    labels = np.arange(VIDEO[0], dtype=np.int32) % NC
    with jax.enable_x64(True):
        jmodel = _jax_model(("use_bn",), jnp.float64)
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                              init["params"])
        bs = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                          init["batch_stats"])
        tx = jax_ft.make_finetune_optimizer(
            jax_ft.FinetuneConfig(**vars(cfg)), batches_per_epoch=1)
        jstep, _ = jax_ft.make_finetune_steps(jmodel, tx, jnp.float64)
        params, bs, _, jloss, _ = jstep(
            params, bs, tx.init(params), jnp.asarray(video),
            jnp.asarray(labels), jax.random.PRNGKey(3))
        jloss = float(jloss)
        ref_model = _port_model(("use_bn",), init, torch.float64)
        load_jax_finetune_variables(ref_model,
                                    jax.tree.map(np.asarray, params),
                                    jax.tree.map(np.asarray, bs))
    ref = ref_model.state_dict()

    model = _port_model(("use_bn",), init, torch.float64)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = ft.make_finetune_optimizer(cfg, model)
    ft.set_finetune_lr(opt, ft.lr_factor_table(cfg), 0, 1)
    _, step_on, _ = ft.make_finetune_steps(model, opt, torch.float64)
    loss, logits = step_on(normalize_video(torch.from_numpy(video),
                                           torch.float64),
                           torch.from_numpy(labels))
    assert logits.shape == (VIDEO[0], NC)
    # the fp32 cross-entropy of logits that carry the fp32 roundings
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    after = model.state_dict()
    for part in ("base.", "classifier."):
        names = [n for n in after if n.startswith(part) and "running" not in n
                 and not _frozen(n, feature_extract)]
        if not names:
            continue
        scale = max(float((ref[n] - before[n]).abs().max()) for n in names)
        for n in names:
            np.testing.assert_allclose(
                (after[n] - before[n]).numpy(), (ref[n] - before[n]).numpy(),
                rtol=0, atol=MODEL_STEP_RTOL * scale, err_msg=n)
    for name, value in after.items():
        if "running" in name:  # train mode updates them, frozen or not
            _close(value, ref[name], MODEL_STEP_RTOL)
            assert not torch.equal(value, before[name]), name
        elif _frozen(name, feature_extract):
            assert torch.equal(value, before[name]), name
            assert torch.equal(ref[name], before[name]), name


# ------------------------------------------------------------ evaluate

class _Writer:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), step))


def test_evaluate_matches_jax_on_the_same_logits():
    rng = np.random.default_rng(2)
    batches, logits = [], []
    for idx in (np.arange(0, 6), np.arange(6, 12), np.array([12, 13, 2, 5])):
        n = len(idx)
        batches.append({"video": np.zeros((n, 1), np.uint8),
                        "label": rng.integers(0, 7, n), "index": idx,
                        "vid_idx": idx // 3})
        # integer logits: ties, which fall as numpy's argsort puts them
        logits.append(rng.integers(0, 4, (n, 7)).astype(np.float32))
    losses = [0.5, 1.25, 2.0]

    def stream():
        it = iter(zip(logits, losses))
        return lambda *a: next(it)

    jeval = stream()
    jwriter, writer = _Writer(), _Writer()
    ref = jax_ft.evaluate(lambda p, b, v, lab: jeval(), None, None,
                          iter(batches), writer=jwriter, epoch=3, ds="ucf101")
    peval = stream()
    got = ft.evaluate(lambda v, lab: tuple(map(torch.as_tensor, peval())),
                      iter([{k: torch.as_tensor(v) for k, v in b.items()}
                            for b in batches]),
                      writer=writer, epoch=3, ds="ucf101")
    assert got == ref
    assert writer.scalars == jwriter.scalars
    assert [t for t, _, _ in writer.scalars] == [
        "ucf101/val/vid_acc1/epoch", "ucf101/val/vid_acc5/epoch"]


# ------------------------------------------------------------ the tower

@pytest.fixture(scope="module")
def trainer_checkpoint(tmp_path_factory):
    """A checkpoint as the Trainer writes it (``save_checkpoint``) of an
    AVModel, and that model."""
    dump = tmp_path_factory.mktemp("trainer")
    model = load_model(headcount=2, num_classes=8, seed=3, device="cpu")
    with torch.no_grad():  # BN statistics that differ from the init
        for name, buf in model.named_buffers():
            buf.add_(torch.rand(buf.shape, generator=torch.Generator()
                                .manual_seed(len(name))))
    sl_state = SelfLabelState(selflabels=np.zeros((4, 2), np.int32),
                              marginals=MarginalState(dists=None),
                              sk_counter=0, epoch=0)
    save_checkpoint(str(dump), model, torch.optim.SGD(model.parameters(),
                                                      lr=0.1), sl_state, 0)
    return dump / "checkpoint.pth", model


def test_load_pretrained_tower_from_a_trainer_checkpoint(trainer_checkpoint):
    path, av = trainer_checkpoint
    model = ft.FinetuneModel(NC, use_bn=True)
    head = {k: v.clone() for k, v in model.state_dict().items()
            if not k.startswith("base.")}
    finetune_runner.load_pretrained_tower(model, str(path))
    tower = av.video_network.state_dict()
    assert set(model.base.state_dict()) == set(tower)
    for key, value in model.base.state_dict().items():
        assert torch.equal(value, tower[key]), key
    for key, value in head.items():  # the head is not touched
        assert torch.equal(model.state_dict()[key], value)

    aligned = ft.FinetuneModel(NC, midplanes_mode="aligned")
    before = {k: v.clone() for k, v in aligned.state_dict().items()}
    with pytest.raises(ValueError, match="does not fit"):
        finetune_runner.load_pretrained_tower(aligned, str(path))
    for key, value in aligned.state_dict().items():
        assert torch.equal(value, before[key]), key


# ------------------------------------------------------------ the CLI

@pytest.fixture
def restore_logging():
    """The CLIs' loggers replace the root handlers; put them back."""
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    yield
    for h in root.handlers:
        if h not in handlers:
            h.close()
    root.handlers[:] = handlers
    root.setLevel(level)


FT_CLI = ("--dataset synthetic --num_data_samples 4 --clip_len 4 "
          "--batch_size 4 --fold 1 --compute_dtype float32 --workers 0")


@pytest.fixture(scope="module")
def ucf_tree(tmp_path_factory):
    """A UCF-layout tree of cv2 mp4s (3 official-format folds; fold 1
    tests one video of each of the 2 classes)."""
    pytest.importorskip("cv2")
    root = tmp_path_factory.mktemp("ucf")
    subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "make_real_media.py"),
         "--output", str(root), "--layout", "ucf", "--num_videos", "6",
         "--num_classes", "2", "--frame_size", "128", "--duration", "1.0"],
        check=True, capture_output=True, timeout=300)
    return root


@pytest.mark.parametrize("dataset", ["synthetic", "ucf101"])
def test_cli_test_only_matches_root_finetune_video(
        tmp_path, capsys, monkeypatch, restore_logging, request, dataset):
    """Root finetune_video.py reads its tower from a JAX checkpoint and
    inits its classifier from PRNGKey(0); the port reads the same tower
    from a port checkpoint and takes that classifier. On the UCF tree
    (crop 128, no audio decoded) the test split has 3 spatial crops of
    each video."""
    argv = FT_CLI.split()
    classes = 4
    if dataset == "ucf101":
        tree = request.getfixturevalue("ucf_tree")
        argv = (FT_CLI.replace("synthetic", "ucf101")
                .replace("--batch_size 4", "--batch_size 6").split()
                + ["--root_dir", str(tree / "videos"),
                   "--train_clips_per_video", "1",
                   "--val_clips_per_video", "1"])
        classes = 101
    jmodel = jax_ft.FinetuneModel(num_classes=classes)
    key = jax.random.PRNGKey(0)  # root finetune_video.py's init
    init = jmodel.init({"params": key, "dropout": key},
                       jnp.zeros((2, 4, 64, 64, 3)), train=False)
    init = jax.tree.map(np.asarray, {"params": dict(init["params"]),
                                     "batch_stats": dict(init["batch_stats"])})
    # a pretrained tower: random weights and statistics
    tower = _random_variables({c: init[c]["base"] for c in init}, 5)
    jax_ckpt = tmp_path / "jax.pkl"
    with open(jax_ckpt, "wb") as f:
        pickle.dump({"device": serialization.to_bytes({
            "params": {"video_network": tower["params"]},
            "batch_stats": {"video_network": tower["batch_stats"]}})}, f)
    port = ft.FinetuneModel(classes)
    load_jax_finetune_variables(
        port, dict(init["params"], base=tower["params"]),
        dict(init["batch_stats"], base=tower["batch_stats"]))
    port_ckpt = tmp_path / "checkpoint.pth"
    torch.save({"model": {f"video_network.{k}": v for k, v in
                          port.base.state_dict().items()}}, port_ckpt)

    views = []
    inner_evaluate = finetune_runner.evaluate

    def evaluate(eval_step, loader, **kw):
        batches = list(loader)
        views.append([tuple(b["video"].shape) for b in batches])
        return inner_evaluate(eval_step, iter(batches), **kw)

    monkeypatch.setattr(finetune_runner, "evaluate", evaluate)
    ref = jax_cli.main(argv + [
        "--test_only", "true", "--weights_path", str(jax_ckpt),
        "--output_dir", str(tmp_path / "jax"), "--data_path",
        str(tmp_path / "jax_meta")])
    jax_line = capsys.readouterr().out.strip().splitlines()[-1]

    def build_model(cfg, args, device):
        model = ft.FinetuneModel(cfg.num_classes)
        load_jax_finetune_variables(model, init["params"],
                                    init["batch_stats"])
        return model.to(device)

    monkeypatch.setattr(finetune_runner, "build_model", build_model)
    got = finetune_video.main(argv + [
        "--test_only", "true", "--weights_path", str(port_ckpt),
        "--output_dir", str(tmp_path / "port"), "--data_path",
        str(tmp_path / "port_meta")], device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == jax_line and line.startswith(f"1-Fold ({dataset}): ")
    assert got == ref
    assert (tmp_path / "port" / "train.log").exists()
    if dataset == "ucf101":  # 2 test videos x 3 crops at 128 px
        assert views == [[(6, 4, 128, 128, 3)]]
    else:
        assert views == [[(4, 4, 64, 64, 3)]]


RESUME_CLI = FT_CLI.replace("--num_data_samples 4",
                            "--num_data_samples 8") + (
    " --use_bn true --use_dropout true --lr_warmup_epochs 1 "
    "--head_lr 0.05 --base_lr 0.01")


def test_resume_continues_bit_for_bit(tmp_path, capsys, restore_logging):
    def run(out, epochs, resume=""):
        argv = RESUME_CLI.split() + ["--epochs", str(epochs), "--output_dir",
                                     str(out)]
        if resume:
            argv += ["--resume", resume]
        return finetune_video.main(argv, device="cpu")

    straight = run(tmp_path / "a", 2)
    run(tmp_path / "b", 1)
    resumed = run(tmp_path / "b", 2, resume="true")
    a = torch.load(tmp_path / "a/checkpoints/checkpoint_fold1.pth",
                   weights_only=True)
    b = torch.load(tmp_path / "b/checkpoints/checkpoint_fold1.pth",
                   weights_only=True)
    assert a["epoch"] == b["epoch"] == 2 and a["step"] == b["step"] == 4
    assert set(a["model"]) == set(b["model"])
    for key, value in a["model"].items():
        assert torch.equal(value, b["model"][key]), key
    for pa, pb in zip(a["optimizer"]["state"].values(),
                      b["optimizer"]["state"].values()):
        assert torch.equal(pa["momentum_buffer"], pb["momentum_buffer"])
    assert a["optimizer"]["param_groups"] == b["optimizer"]["param_groups"]
    assert resumed["acc1"] == straight["acc1"]
    log = (tmp_path / "b/train.log").read_text()
    assert "resumed finetune fold 1 at epoch 1" in log


def test_run_fold_refuses_a_dataset_without_a_class_count():
    args = finetune_video.parse_args(["--dataset", "vggsound"])
    with pytest.raises(ValueError, match="class count unknown"):
        finetune_runner.run_fold(args, 1, device="cpu")


def test_cli_without_a_card_refuses_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        finetune_video.main(FT_CLI.split() + ["--output_dir",
                                              str(tmp_path)])
