"""The reference against the port at tiny sizes on the CPU, the control
(the reference in float8) failing the same limits, and runs with the timed
path broken underneath coming out not correct."""

import numpy as np
import pytest
import torch

from benchmark import control, flops, harness
from benchmark.tests import tiny


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    d = tmp_path_factory.mktemp("portbench")
    yield d
    import shutil

    shutil.rmtree(d, ignore_errors=True)


def test_pretrain_agrees_with_the_reference(cache):
    r = tiny.run("vggsound-pretrain", cache, trace=True)
    assert r.correct, r.checks
    first = abs(r.extra["losses"][0] - r.extra["ref_losses"][0])
    assert first < 1e-5  # the same weights and inputs: fp32 round-off
    assert r.attempted > 0 and r.units == r.attempted * 4
    assert len(r.extra["losses"]) == 3
    assert r.extra["leaves_moving"] == r.extra["leaves"]


def test_resnet50_pretrain_agrees_with_the_reference(cache, monkeypatch):
    """At this size the resnet50 tower is ill-conditioned (the reference's
    own fp32 and fp64 gradients part by 2.5% on some BatchNorm leaves),
    so the steps keep the weights (lr 0): the three losses and the first
    gradient are compared, and the change is zero on both sides."""
    monkeypatch.setitem(tiny.TINY, "base_lr", 0.0)
    r = tiny.run("kinetics400-r50-pretrain", cache,
                 config="kinetics400-r2p1d18-resnet50")
    assert r.correct, r.checks
    assert r.extra["readings"]["loss_gap"] < 1e-5


def test_selflabel_agrees_with_the_reference(cache):
    r = tiny.run("vggsound-selflabel", cache, trace=True)
    assert r.correct, r.checks
    assert r.checks["label_gap"][0] < 1e-6
    assert r.attempted >= 2 and len(r.timings) == r.attempted
    # every aggregation pass counts: one a group of heads
    clips = r.extra["n"] * r.config["ind_groups"] * r.attempted
    assert harness.reader("engine.mfu_pct")(r) == pytest.approx(
        100 * r.flops["forward"] * clips / r.window_s
        / flops.BF16_PEAK_FLOPS)


def _tiny_run(cell, cache, seed=7):
    cfg = dict(harness.load_cell(harness.spec(), cell)[1], **tiny.TINY)
    wl = harness.load_cell(harness.spec(), cell)[2]
    return harness.Run(cell=cell, seed=seed, seconds=0, trace=False,
                       config=cfg, workload=wl, device="cpu", cache=cache)


@pytest.mark.parametrize("cell", ["vggsound-pretrain", "vggsound-selflabel"])
def test_the_control_fails_the_limits(cell, cache):
    """The reference in float8 in the system's place fails at least one
    number's limit."""
    r = _tiny_run(cell, cache)
    got = control.READINGS[r.traffic](r, faults=False)
    readings = got["control_fp8"]
    limits = {k: tiny.LIMITS[k] for k in r.workload["limits"]}
    correct, checks = control.judge(readings, limits)
    assert not correct, checks
    assert set(checks) == set(limits)


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(
        cache, monkeypatch):
    monkeypatch.setattr(torch.optim.SGD, "step", lambda self, closure=None:
                        None)
    r = tiny.run("vggsound-pretrain", cache)
    assert not r.correct
    assert r.checks["change_gap_median"][0] == pytest.approx(1.0)


def test_half_the_batch_left_out_is_not_correct(cache, monkeypatch):
    """The step takes the mean over the first half of each batch."""
    from selavi_tpu_torch.train import step as steps

    make = steps.make_train_step

    def halved(*args, **kwargs):
        inner = make(*args, **kwargs)

        def step(batch, labels, generator):
            half = labels.shape[0] // 2
            batch = {k: v[:half] if torch.is_tensor(v) and v.ndim else v
                     for k, v in batch.items()}
            return inner(batch, labels[:half], generator)
        return step

    monkeypatch.setattr(steps, "make_train_step", halved)
    r = tiny.run("vggsound-pretrain", cache)
    assert not r.correct, r.checks


def test_altered_labels_are_not_correct(cache, monkeypatch):
    """The SK solve's labels moved to the next cluster on a tenth of the
    rows, where they are produced."""
    from selavi_tpu_torch.selflabel import engine

    solve = engine.sinkhorn_knopp

    def altered(*args, **kwargs):
        res = solve(*args, **kwargs)
        labels = res.labels.clone()
        rows = max(1, labels.shape[0] // 10)
        labels[:rows] = (labels[:rows] + 1) % args[0].shape[1]
        return res._replace(labels=labels)

    monkeypatch.setattr(engine, "sinkhorn_knopp", altered)
    r = tiny.run("vggsound-selflabel", cache)
    assert not r.correct, r.checks
    assert np.isfinite(r.checks["label_gap"][0])
