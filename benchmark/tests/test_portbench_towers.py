"""Towers found by name (``benchmark/reference/towers``): a new video tower
is one new file, built, drawn from the seed, loaded and counted by the
harness with no other file edited; and the towers that the configurations
name give the weights and FLOPs they gave before they were files."""

import hashlib
import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import flops, system, weights
from benchmark.tests.test_portbench_discovery import digest

ROOT = Path(__file__).resolve().parents[2]

# A tiny attention tower: 4x4 patches of every frame embedded by a dense
# layer, a cls token, one block of single-head self-attention over all the
# tokens and an MLP, each with its residual; the cls token's output is the
# feature. Its dense layers start from torch's unseeded random draw, so
# only ``make_state`` can make them follow the seed.
TINY_ATTN = '''"""A tiny attention video tower for the tests."""

import math

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.model import _run, autocast, q, qg

PATCH, WIDTH, HIDDEN = 4, 16, 32


class Dense(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(cout, cin))
        self.bias = nn.Parameter(torch.randn(cout))

    def forward(self, x):
        with autocast(x):
            return qg(F.linear(q(x), q(self.weight), self.bias))

    def flops(self, args, out):
        return 2 * out.numel() * self.weight.shape[1]


class Attention(nn.Module):
    def __init__(self):
        super().__init__()
        self.qkv = Dense(WIDTH, 3 * WIDTH)
        self.proj = Dense(WIDTH, WIDTH)

    def forward(self, x):
        qq, k, v = self.qkv(x).chunk(3, dim=-1)
        with autocast(x):
            a = qg(q(qq) @ q(k).transpose(1, 2)) / math.sqrt(WIDTH)
            y = qg(q(torch.softmax(a.float(), -1)) @ q(v))
        return self.proj(y.float())

    def flops(self, args, out):
        b, n, d = args[0].shape
        return 2 * 2 * b * n * n * d  # scores and the weighted values


class Tower(nn.Module):
    feature_dim = WIDTH

    def __init__(self, channels):
        super().__init__()
        self.patch = Dense(channels * PATCH * PATCH, WIDTH)
        self.cls = nn.Parameter(torch.randn(1, 1, WIDTH))
        self.attn = Attention()
        self.fc1 = Dense(WIDTH, HIDDEN)
        self.fc2 = Dense(HIDDEN, WIDTH)

    def draw_std(self, name, shape):
        return 1.0 / math.sqrt(3 * shape[1]) if len(shape) == 2 else 0.02

    def mlp(self, x):
        return self.fc2(F.gelu(self.fc1(x)))

    def forward(self, video):
        b, t, h, w, c = video.shape
        x = video.reshape(b, t, h // PATCH, PATCH, w // PATCH, PATCH, c)
        x = x.permute(0, 1, 2, 4, 3, 5, 6).reshape(b, -1, PATCH * PATCH * c)
        x = torch.cat([self.cls.expand(b, -1, -1), self.patch(x)], 1)
        x = x + _run(self.attn, x)
        x = x + _run(self.mlp, x)
        return x[:, 0]


def build(channels):
    return Tower(channels)
'''

CONFIGS = ("vggsound-r2p1d18-resnet9", "kinetics400-r2p1d18-resnet50")
# Taken on the tree before the towers became files (its benchmark/ as of
# the temporal conv kernel's commit): ``weights.make_state(
# system.reference_network(config), seed, "cpu")`` hashed by
# ``state_digest``, and ``flops.clip_flops(config, flops.spec_frames(
# num_sec_aud, aud_sample_rate))``.
PARENT_DIGESTS = {
    ("vggsound-r2p1d18-resnet9", 1):
        "c5611a834dd27161833aaa6c107aba08da2d6f9f96e244d05d8abf49e947dd7a",
    ("vggsound-r2p1d18-resnet9", 2147483821):
        "85ba7fff54618caef55bade67d13a38d39aa55521c89e6c3bbba15057aa3fe9c",
    ("kinetics400-r2p1d18-resnet50", 1):
        "456b863536b70791276a08bc8bdb83754af1fe283f037e37043e7e4959bf1919",
    ("kinetics400-r2p1d18-resnet50", 2147483821):
        "34cd7dca8479dbb3e26324f4456557af3dd0fd052cc7c6491ce7f807892d79cd",
}
PARENT_FLOPS = {
    "vggsound-r2p1d18-resnet9": {"forward": 154595652096,
                                 "train": 462501823488},
    "kinetics400-r2p1d18-resnet50": {"forward": 158433747456,
                                     "train": 474016109568},
}

# Run in the copy: the harness builds the network of the tiny tower's
# configuration by name, draws it (twice from one seed, under different
# global torch seeds, and once from another), loads it into a twin, runs
# the twin's towers and counts the clip's FLOPs.
PROBE = """
import json, sys
import torch
sys.path.insert(0, sys.argv[1])
from benchmark import flops, harness, system, weights
bench = harness.spec(sys.argv[1])
_, c, _ = harness.load_cell(bench, "tiny-attn-pretrain", sys.argv[1])
states = []
for torch_seed, seed in ((0, 5), (1, 5), (2, 6)):
    torch.manual_seed(torch_seed)
    states.append(weights.make_state(system.reference_network(c), seed,
                                     "cpu"))
twin = system.reference_network(c)
weights.load_into(twin, states[0])
leaves = [k for k, _ in twin.video_network.named_parameters()]
feat_v, feat_a = twin.eval().features(
    torch.rand(2, c["num_frames"], c["train_crop_size"],
               c["train_crop_size"], 3), torch.rand(2, 257, 99, 1))
print(json.dumps({
    "tower": type(twin.video_network).__module__,
    "leaves": leaves,
    "loaded": all(torch.equal(twin.state_dict()[k], v)
                  for k, v in states[0].items()),
    "same_seed": {k: torch.equal(states[0]["video_network." + k],
                                 states[1]["video_network." + k])
                  for k in leaves},
    "other_seed": {k: torch.equal(states[0]["video_network." + k],
                                  states[2]["video_network." + k])
                   for k in leaves},
    "features": [list(feat_v.shape), list(feat_a.shape)],
    "heads_v": list(twin.heads_v.hidden_weight.shape),
    "flops": flops.clip_flops(c, flops.spec_frames(1, 24000))}))
"""


def tiny_tower_module(tmp_path):
    path = tmp_path / "tiny_attn.py"
    path.write_text(TINY_ATTN)
    spec = importlib.util.spec_from_file_location("tiny_attn", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def copy_with_tower(tmp_path_factory):
    """A copy of the benchmark with the tiny tower's file, a configuration
    that names it, its cell and the cell's entries in ``BENCHMARK.json``;
    ``(copy, digests before, digests after, the probe's output)``."""
    copy = tmp_path_factory.mktemp("towers") / "repo"
    shutil.copytree(ROOT / "benchmark", copy / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = digest(copy / "benchmark")
    (copy / "benchmark/reference/towers/tiny_attn.py").write_text(TINY_ATTN)
    cfg = json.loads((ROOT / "benchmark/configs/"
                      "vggsound-r2p1d18-resnet9.json").read_text())
    cfg.update(name="tiny-attn", vid_base_arch="tiny_attn", num_frames=2,
               train_crop_size=8)
    (copy / "benchmark/configs/tiny-attn.json").write_text(json.dumps(cfg))
    (copy / "benchmark/workloads/tiny-attn-pretrain.json").write_text(
        (ROOT / "benchmark/workloads/vggsound-pretrain.json").read_text())
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-attn", "source": "x",
                             "file": "benchmark/configs/tiny-attn.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny-attn-pretrain",
                               "config": "tiny-attn", "traffic": "pretrain",
                               "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "vggsound-pretrain" in m.get("workloads", []):
            m["workloads"].append("tiny-attn-pretrain")
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    after = digest(copy / "benchmark")
    out = subprocess.run([sys.executable, "-c", PROBE, str(copy)],
                         capture_output=True, text=True, cwd=copy,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    yield copy, before, after, json.loads(out.stdout.splitlines()[-1])
    shutil.rmtree(copy, ignore_errors=True)


def test_a_new_tower_is_a_new_file_only(copy_with_tower):
    """(a) Built, loaded into a twin, run and counted by name, with no
    file of the benchmark edited."""
    _, before, after, got = copy_with_tower
    assert {k: v for k, v in after.items() if k in before} == before
    assert got["tower"] == "benchmark.reference.towers.tiny_attn"
    assert got["loaded"]
    assert got["features"] == [[2, 16], [2, 512]]
    assert got["heads_v"] == [10, 16, 512]  # sized at the tower's width
    assert 0 < got["flops"]["forward"] < got["flops"]["train"]


def test_the_tiny_towers_flops_match_a_hand_count(tmp_path):
    """(b) Every dense layer and both attention products, the patch
    embedding as the stem."""
    tiny = tiny_tower_module(tmp_path)

    class Holder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.video_network = tiny.build(3)

        def forward(self, x):
            return self.video_network(x)

    with torch.device("meta"):
        net = Holder()
        video = torch.empty(2, 2, 8, 8, 3)
    got = flops.count(net, video)
    b, n, d, hidden = 2, 1 + 2 * 2 * 2, 16, 32  # 8 patches and the cls
    patch = 2 * b * 8 * 48 * d  # 4 x 4 x 3 pixels a patch
    qkv, proj = 2 * b * n * d * 3 * d, 2 * b * n * d * d
    scores = weighted = 2 * b * n * n * d
    mlp = 2 * 2 * b * n * d * hidden
    assert got == {"forward": patch + qkv + scores + weighted + proj + mlp,
                   "stems": patch}


def test_every_leaf_of_the_tiny_tower_follows_the_seed(copy_with_tower):
    """(c) One seed gives equal leaves whatever torch's own global seed,
    another seed gives other leaves, in every parameter of the tower."""
    got = copy_with_tower[3]
    assert set(got["leaves"]) == {
        "patch.weight", "patch.bias", "cls", "attn.qkv.weight",
        "attn.qkv.bias", "attn.proj.weight", "attn.proj.bias",
        "fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias"}
    assert all(got["same_seed"].values())
    assert not any(got["other_seed"].values())


def test_an_unknown_tower_names_the_files_it_looked_for():
    with pytest.raises(KeyError, match=r"no_such_tower\.py.*r2plus1d_18"):
        system.reference_network({"vid_base_arch": "no_such_tower",
                                  "aud_base_arch": "resnet9",
                                  "headcount": 2, "mlp_dim": 4})


def state_digest(state):
    h = hashlib.sha256()
    for k in sorted(state):
        h.update(k.encode())
        h.update(state[k].contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", CONFIGS)
def test_the_configurations_draw_and_count_as_before(name):
    """(d) The weights byte for byte and the FLOPs to the integer."""
    cfg = json.loads((ROOT / f"benchmark/configs/{name}.json").read_text())
    for seed in (1, 2147483821):
        state = weights.make_state(system.reference_network(cfg), seed,
                                   "cpu")
        assert state_digest(state) == PARENT_DIGESTS[name, seed], seed
    assert flops.clip_flops(cfg, flops.spec_frames(
        cfg["num_sec_aud"], cfg["aud_sample_rate"])) == PARENT_FLOPS[name]
