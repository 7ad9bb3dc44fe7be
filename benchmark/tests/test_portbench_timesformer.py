"""The TimeSformer configuration's yardstick and the four-rank driver: the
FLOPs of a clip against the published count, the tower's size, one seeded
state in both the port's and the reference's network, every reference
tower built by name with nothing of the system or JAX loaded, the
driver's ranks agreeing on their steps, and BatchNorm's statistics of a
rank's own rows failing the driver's check (two gloo ranks on the
CPU)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import flops, harness, system, weights
from benchmark.reference import towers
from benchmark.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
CONFIG = "kinetics400-timesformer-resnet9"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "selavi_tpu",
             "selavi_tpu_torch"}


def config():
    return json.loads((ROOT / f"benchmark/configs/{CONFIG}.json").read_text())


def test_clip_flops_match_the_published_count():
    """196 G multiply-adds a forward clip for the tower (392 GFLOP), about
    1.174 TFLOP a training clip for the network; within 1%."""
    c = config()
    got = flops.clip_flops(c, flops.spec_frames(c["num_sec_aud"],
                                                c["aud_sample_rate"]))
    assert got["forward"] == pytest.approx(392e9, rel=0.01)
    assert got["train"] == pytest.approx(1.174e12, rel=0.01)
    with torch.device("meta"):
        n = flops.count(_Holder(towers.build("timesformer_base", 3)).eval(),
                        torch.empty(1, 8, 224, 224, 3))
    assert n["forward"] == pytest.approx(392e9, rel=0.01)
    assert n["stems"] == 2 * 8 * 196 * 768 * 768  # the patch conv


class _Holder(torch.nn.Module):
    def __init__(self, tower):
        super().__init__()
        self.video_network = tower

    def forward(self, video):
        return self.video_network(video)


def test_tower_size():
    with torch.device("meta"):
        tower = towers.build("timesformer_base", 3)
    assert sum(p.numel() for p in tower.parameters()) == pytest.approx(
        121.4e6, abs=0.5e6)
    assert tower.feature_dim == 768


def test_the_seeded_state_loads_into_both_networks():
    """Every key of the reference's state, each shape, in the port's
    AVModel at the configuration's size; LayerNorm's leaves at 1 and 0,
    ``temporal_fc`` drawn in every block."""
    from selavi_tpu_torch.models.av_model import load_model

    c = config()
    ref = system.reference_network(c)
    state = weights.make_state(ref, 2 ** 31 + 77, "cpu")
    weights.load_into(ref, state)
    port = load_model(c["vid_base_arch"], c["aud_base_arch"],
                      headcount=c["headcount"], num_classes=c["mlp_dim"],
                      device="cpu", num_frames=c["num_frames"],
                      crop_size=c["train_crop_size"])
    weights.load_into(port, state)
    assert torch.equal(state["video_network.blocks.3.norm1.weight"],
                       torch.ones(768))
    assert torch.equal(state["video_network.norm.bias"], torch.zeros(768))
    for i in range(12):
        w = state[f"video_network.blocks.{i}.temporal_fc.weight"]
        assert float(w.std()) == pytest.approx(0.02, rel=0.05)
    assert port.heads_v.hidden_weight.shape == (10, 768, 512)


PROBE = """
import json, sys
sys.path.insert(0, sys.argv[1])
from benchmark.reference import towers
built = {}
for name in towers.names():
    t = towers.build(name, 1 if name.startswith("resnet") else 3)
    built[name] = t.feature_dim
print(json.dumps({"built": built,
                  "loaded": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def test_every_tower_builds_and_loads_nothing_of_the_system():
    out = subprocess.run([sys.executable, "-c", PROBE, str(ROOT)],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.splitlines()[-1])
    assert got["built"]["timesformer_base"] == 768
    assert set(got["built"]) == set(towers.names())
    assert not set(got["loaded"]) & FORBIDDEN


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    d = tmp_path_factory.mktemp("portbench_dp")
    yield d
    import shutil

    shutil.rmtree(d, ignore_errors=True)


def tiny_dp():
    """The dp4 cell's configuration and workload at the tiny size on two
    ranks; ``bn_rank_gap`` keeps the cell's limit, since the port reads 0
    at any size."""
    cfg = dict(harness.load_cell(harness.spec(), "vggsound-pretrain-dp4")[1],
               **tiny.TINY)
    cfg["dataset_samples"] = 4096  # no epoch ends inside the window
    wl = harness.load_cell(harness.spec(), "vggsound-pretrain-dp4")[2]
    wl = dict(wl, ranks=2, trace_steps=2,
              limits={k: tiny.LIMITS.get(k, lim)
                      for k, lim in wl["limits"].items()})
    return cfg, wl


def test_dp_ranks_run_the_same_steps_and_units_sum_them(cache):
    """``pretrain_dp4`` on two gloo ranks at the tiny size: both ranks
    run the budget agreed before the window, ``units`` counts both ranks'
    clips, the first steps agree with the reference at the global batch,
    and the ranks' BatchNorm buffers are equal after the window."""
    cfg, wl = tiny_dp()
    r = harness.Run(cell="vggsound-pretrain-dp4", seed=2 ** 31 + 99,
                    seconds=2.0, trace=False, config=cfg, workload=wl,
                    device="cpu", cache=cache)
    harness.driver(wl).run(r)
    steps = r.extra["rank_steps"]
    assert len(steps) == 2 and steps[0] == steps[1] > 0
    assert steps[0] == r.extra["window_budget_steps"] == r.attempted
    assert r.units == steps[0] * cfg["batch_size"] * 2
    assert r.traffic == "pretrain"
    assert r.correct, r.checks
    assert r.checks["bn_rank_gap"][0] == 0.0
    first = abs(r.extra["losses"][0] - r.extra["ref_losses"][0])
    assert first < 1e-5  # fp32 on both sides, the same global batch


def test_local_batchnorm_fails_the_dp_check(cache, capsys):
    """``control_dp4`` without the references: the port's ranks hold equal
    BatchNorm buffers, and with ``GlobalBatchNorm``'s all-reduces left out
    they part by more than the cell's ``bn_rank_gap`` limit, which makes
    the check read false."""
    from benchmark import control_dp4

    cfg, wl = tiny_dp()
    control_dp4.run("vggsound-pretrain-dp4", [2 ** 31 + 99], cfg, wl, "cpu",
                    cache, references=False)
    lines = capsys.readouterr().out.splitlines()
    got = {d["reading"]: d for d in (json.loads(line) for line in lines
                                     if line.startswith('{"seed"'))}
    assert got["port"]["correct"]
    assert got["port"]["readings"]["bn_rank_gap"] == 0.0
    assert not got["fault_local_bn"]["correct"]
    assert got["fault_local_bn"]["readings"]["bn_rank_gap"] > 0.1
