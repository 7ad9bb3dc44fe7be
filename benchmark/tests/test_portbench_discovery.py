"""Every configuration, workload, driver and metric of ``BENCHMARK.json``
is found by its name, and a new cell, configuration and metric take new
files and entries only."""

import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    assert "setup_s" in [m["name"] for m in BENCH["end_to_end"]]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_by_name(cell):
    entry, config, workload = harness.load_cell(BENCH, cell, ROOT)
    assert config["name"] == entry["config"]
    assert hasattr(harness.driver(workload), "run")
    e2e = harness.metrics_of(BENCH, cell, traced=False)
    per_layer = harness.metrics_of(BENCH, cell, traced=True)
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert per_layer
    for m in e2e + per_layer:
        assert callable(harness.reader(m["name"], ROOT))
    for key in next(c for c in BENCH["configs"]
                    if c["name"] == entry["config"])["reduced"]:
        assert key in config and key in config["reduced"]


def test_every_moved_metric_is_reported_where_its_mover_is():
    for m in BENCH["per_layer"]:
        mover = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        for cell in m["workloads"]:
            assert cell in mover.get("workloads", [cell])


def digest(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts
            and ".cache" not in p.parts}


def test_a_new_cell_config_and_metric_are_new_files_only(tmp_path):
    """A dummy cell over a new configuration, with a new per-layer metric,
    in a copy of the benchmark: found by name with no file edited but
    ``BENCHMARK.json``."""
    copy = tmp_path / "repo"
    shutil.copytree(ROOT / "benchmark", copy / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = digest(copy / "benchmark")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((copy / "benchmark/configs/"
                      "vggsound-r2p1d18-resnet9.json").read_text())
    cfg.update(name="dummy-config", mlp_dim=64)
    (copy / "benchmark/configs/dummy-config.json").write_text(
        json.dumps(cfg))
    (copy / "benchmark/workloads/dummy-cell.json").write_text(json.dumps(
        {"driver": "pretrain", "samples": "dataset_samples",
         "warm_steps": 1, "trace_from": 1, "trace_steps": 2,
         "limits": {"loss_gap": 1, "grad_gap": 1, "change_gap": 1}}))
    (copy / "benchmark/metrics/dummy.steps.py").write_text(
        "def read(run):\n    return run.attempted or None\n")
    bench["configs"].append({"name": "dummy-config", "source": "x",
                             "file": "benchmark/configs/dummy-config.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "dummy-cell", "config": "dummy-config",
                               "traffic": "pretrain", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("dummy-cell")
    bench["per_layer"].append({"name": "dummy.steps", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "Trainer",
                               "moves": "train_clips_per_s",
                               "workloads": ["dummy-cell"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    after = digest(copy / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, sys.argv[1]);"
         "from benchmark import harness;"
         "b = harness.spec(sys.argv[1]);"
         "e, c, w = harness.load_cell(b, 'dummy-cell', sys.argv[1]);"
         "print(c['mlp_dim'], harness.driver(w).__name__,"
         " [m['name'] for m in harness.metrics_of(b, 'dummy-cell', True)],"
         " harness.reader('dummy.steps', sys.argv[1])"
         "(type('R', (), {'attempted': 7})()))",
         str(copy)], capture_output=True, text=True, cwd=copy, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["64", "benchmark.traffic.pretrain",
                                  "['dummy.steps']", "7"]


def test_run_refuses_without_the_cards():
    """On a machine with no CUDA card the command exits 2 and prints no
    result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, str(ROOT / "benchmark/run.py"), "--workload",
         "vggsound-pretrain", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_run_fails_without_the_program(tmp_path):
    """In a directory that holds only ``BENCHMARK.json`` and the
    benchmark, the command exits non-zero and prints no result."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "vggsound-pretrain", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_a_new_driver_of_known_traffic_is_read_by_the_existing_readers(
        tmp_path):
    """A second pretraining driver (as a four-rank one would be), a new
    file that declares its ``TRAFFIC``, has its cell's end-to-end metrics
    read by the readers that are there, in a copy of the benchmark."""
    copy = tmp_path / "repo"
    shutil.copytree(ROOT / "benchmark", copy / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = digest(copy / "benchmark")
    (copy / "benchmark/traffic/pretrain_dummy.py").write_text(
        '"""Pretraining by another driver."""\n\n'
        "from benchmark.traffic.pretrain import run  # noqa: F401\n\n"
        'TRAFFIC = "pretrain"\n')
    wl = json.loads((ROOT / "benchmark/workloads/vggsound-pretrain.json")
                    .read_text())
    (copy / "benchmark/workloads/dummy-dp.json").write_text(
        json.dumps(dict(wl, driver="pretrain_dummy")))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "dummy-dp",
                               "config": "vggsound-r2p1d18-resnet9",
                               "traffic": "pretrain", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "vggsound-pretrain" in m.get("workloads", []):
            m["workloads"].append("dummy-dp")
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    assert {k: v for k, v in digest(copy / "benchmark").items()
            if k in before} == before
    out = subprocess.run(
        [sys.executable, "-c",
         "import json, sys; sys.path.insert(0, sys.argv[1]);"
         "from benchmark import harness;"
         "b = harness.spec(sys.argv[1]);"
         "e, c, w = harness.load_cell(b, 'dummy-dp', sys.argv[1]);"
         "r = harness.Run(cell='dummy-dp', seed=1, seconds=2.0, trace=False,"
         " config=c, workload=w, device='cpu', setup_s=30.0, window_s=2.0,"
         " units=300);"
         "print(r.traffic, json.dumps(harness.read_metrics(b, r,"
         " sys.argv[1])))",
         str(copy)], capture_output=True, text=True, cwd=copy, timeout=120)
    assert out.returncode == 0, out.stderr
    traffic, metrics = out.stdout.strip().split(" ", 1)
    assert traffic == "pretrain"
    assert json.loads(metrics) == {
        "train_clips_per_s": {"value": 150.0, "unit": "clips/s"},
        "setup_s": {"value": 30.0, "unit": "s"}}
