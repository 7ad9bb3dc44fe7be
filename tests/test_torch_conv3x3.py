"""The port's 3x3 conv (``selavi_tpu_torch/ops/conv3x3.py``) against the JAX
probe ``experiments/pallas_conv3x3.py``, on the CPU.

Each case feeds the same numpy inputs (the probe's seed and draw order) to
the probe's Pallas function in interpret mode, to XLA's conv or ``jax.vjp``
of it, and to the port's wrapper, which runs its plain version for CPU
tensors. Tolerance 1e-5 of max |ref| in fp32: the same products summed in
another order (the probe's Pallas and XLA results already agree to 7e-7).
"""

import importlib.util
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selavi_tpu_torch.experiments import conv3x3 as probe
from selavi_tpu_torch.ops import conv3x3 as ops

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5


def _load_jax_probe():
    spec = importlib.util.spec_from_file_location(
        "pallas_conv3x3", ROOT / "experiments" / "pallas_conv3x3.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jax_probe = _load_jax_probe()


def _inputs(n, h, wd, ci, co):
    """x, w, g as the probe's check() draws them."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (n, h, wd, ci)).astype(np.float32)
    w = rng.normal(0, 0.1, (3, 3, ci, co)).astype(np.float32)
    g = rng.normal(0, 1, (n, h, wd, co)).astype(np.float32)
    return x, w, g


def _jax_results(which, x, w, g, ht):
    """(Pallas in interpret mode, XLA or jax.vjp of it) for one function."""
    jx, jw, jg = jnp.asarray(x), jnp.asarray(w), jnp.asarray(g)
    if which == "fwd":
        return (jax_probe.conv3x3_pallas(jx, jw, h_tile=ht, interpret=True),
                jax_probe.conv3x3_xla(jx, jw))
    _, vjp = jax.vjp(jax_probe.conv3x3_xla, jx, jw)
    dx_ref, dw_ref = vjp(jg)
    if which == "dgrad":
        return (jax_probe.conv3x3_dgrad_pallas(jg, jw, h_tile=ht,
                                               interpret=True), dx_ref)
    return (jax_probe.conv3x3_wgrad_pallas(jx, jg, h_tile=ht, interpret=True),
            dw_ref)


def _port_result(which, x, w, g):
    tx, tw, tg = map(torch.from_numpy, (x, w, g))
    if which == "fwd":
        return ops.conv3x3(tx, tw)
    if which == "dgrad":
        return ops.conv3x3_dgrad(tg, tw)
    return ops.conv3x3_wgrad(tx, tg)


def _rel_err(got, ref):
    ref = np.asarray(ref, np.float32)
    return np.abs(np.asarray(got, np.float32) - ref).max() / (
        np.abs(ref).max() + 1e-6)


@pytest.mark.parametrize("shape", [(2, 28, 56, 64, 128, 14),
                                   (1, 8, 16, 8, 16, 4)],
                         ids=["layer1_strip", "ragged_k"])
@pytest.mark.parametrize("which", ["fwd", "dgrad", "wgrad"])
def test_port_matches_pallas_and_xla(which, shape):
    *dims, ht = shape
    x, w, g = _inputs(*dims)
    pallas, xla = _jax_results(which, x, w, g, ht)
    ops.reset_launches()
    got = _port_result(which, x, w, g)
    assert all(v == 0 for v in ops.launches.values())  # CPU: plain version
    assert got.dtype == torch.float32 and got.shape == tuple(xla.shape)
    assert _rel_err(got.numpy(), pallas) < RTOL
    assert _rel_err(got.numpy(), xla) < RTOL


def test_plain_versions_keep_dtypes_and_the_rotation():
    x, w, g = _inputs(1, 4, 5, 3, 2)
    tx, tw, tg = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w, g))
    assert ops.conv3x3(tx, tw).dtype == torch.bfloat16
    assert ops.conv3x3_dgrad(tg, tw).dtype == torch.bfloat16
    assert ops.conv3x3_wgrad(tx, tg).dtype == torch.float32
    rot = ops._rotate(torch.from_numpy(w))
    assert tuple(rot.shape) == (3, 3, 2, 3)
    np.testing.assert_array_equal(
        rot.numpy(), np.asarray(jnp.transpose(w[::-1, ::-1], (0, 1, 3, 2))))


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros(1, 4, 4, 8)
    w = torch.zeros(3, 3, 8, 16)
    g = torch.zeros(1, 4, 4, 16)
    with pytest.raises(TypeError):
        ops.conv3x3(x.double(), w)
    with pytest.raises(TypeError):
        ops.conv3x3(x, w.half())
    with pytest.raises(TypeError):
        ops.conv3x3_wgrad(x, g.to(torch.bfloat16))
    with pytest.raises(ValueError):
        ops.conv3x3(x[0], w)  # rank 3
    with pytest.raises(ValueError):
        ops.conv3x3(x, torch.zeros(1, 3, 8, 16))  # not a 3x3 kernel
    with pytest.raises(ValueError):
        ops.conv3x3(x, torch.zeros(3, 3, 4, 16))  # C mismatch
    with pytest.raises(ValueError):
        ops.conv3x3_dgrad(g, torch.zeros(3, 3, 8, 8))  # Co mismatch
    with pytest.raises(ValueError):
        ops.conv3x3_wgrad(x, torch.zeros(1, 4, 5, 16))  # N, H, W mismatch
    with pytest.raises(ValueError):
        ops.conv3x3(x.transpose(1, 2), w)  # not contiguous
    with pytest.raises(ValueError):
        ops.conv3x3(x, w.to("meta"))  # devices differ
    with pytest.raises(ValueError):
        ops.conv3x3(x.to("meta"), w.to("meta"))  # neither CPU nor CUDA
    with pytest.raises(ValueError):
        ops._check_index_range(2 ** 16, 2 ** 8, 2 ** 4, 64, 128)
    assert ops.split_plan(480 * 56 * 56) == (256, 5888)
    assert ops.split_plan(8 * 16) == (1, 256)


def test_bound_at_the_bench_shape():
    b = probe.bound("conv3x3", probe.BENCH_SHAPE, torch.bfloat16, 3.35e12)
    assert b["flops"] == 2 * 1505280 * 576 * 128
    assert b["bytes"] == (1505280 * (64 + 128) + 576 * 128) * 2
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(b["flops"] / 989e12 * 1e3)
    wb = probe.bound("conv3x3_wgrad", probe.BENCH_SHAPE, torch.bfloat16,
                     3.35e12)
    assert wb["bytes"] == 1505280 * (64 + 128) * 2 + 576 * 128 * 4


def _run_probe(*argv):
    return subprocess.run(
        [sys.executable, "-m", "selavi_tpu_torch.experiments.conv3x3",
         *argv], cwd=ROOT, capture_output=True, text=True, timeout=300)


def test_probe_check_runs_on_the_cpu_when_asked():
    out = _run_probe("--check", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert "CHECK OK" in out.stdout


def test_probe_without_a_card_refuses_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        probe.main(["--check"])
    with pytest.raises(RuntimeError, match="CUDA"):
        probe.bench("cpu")
