"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the system under test; module names are
compared whole by their top-level part (``selavi_tpu_torch`` begins with
``selavi_tpu``)."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

PROBE = """
import importlib, json, sys
sys.path.insert(0, sys.argv[1])
for name in sys.argv[2:]:
    importlib.import_module(name)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def top_level_after(*modules):
    out = subprocess.run([sys.executable, "-c", PROBE, str(ROOT), *modules],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_the_harness_and_the_port_load_no_jax():
    loaded = top_level_after(
        "benchmark.run", "benchmark.harness", "benchmark.control",
        "benchmark.traffic.pretrain", "benchmark.traffic.selflabel",
        "selavi_tpu_torch.train.loop", "selavi_tpu_torch.data.factory",
        "selavi_tpu_torch.selflabel.engine", "selavi_tpu_torch.config")
    assert "selavi_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "optax", "selavi_tpu"}


def test_the_reference_loads_nothing_of_the_system():
    loaded = top_level_after(
        "benchmark.reference.model", "benchmark.reference.inputs",
        "benchmark.reference.train")
    assert not loaded & {"jax", "jaxlib", "flax", "optax", "selavi_tpu",
                         "selavi_tpu_torch"}


def test_the_metric_readers_load_nothing_of_the_system():
    from benchmark import harness

    bench = harness.spec(ROOT)
    for m in bench["end_to_end"] + bench["per_layer"]:
        harness.reader(m["name"], ROOT)
    assert "selavi_tpu" not in {m.split(".")[0] for m in sys.modules}
