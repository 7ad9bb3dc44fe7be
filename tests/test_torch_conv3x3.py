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
from selavi_tpu_torch.experiments import (
    f32_ablation,
    fwd_ablation,
    wgrad_ablation,
)
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
    assert ops.split_plan("fp32", 480 * 56 * 56, 64, 128) == (44, 34240)
    assert ops.split_plan("wmma", 8 * 16, 8, 16) == (1, 256)


# (N, H, W, C, Co): the bench shape, both check shapes, a shape that fills
# no wgmma tile (C = 72, Co = 136, 231 pixels), C = 3, one pixel, and the
# most pixels the kernels take (2^30).
PLAN_SHAPES = [probe.BENCH_SHAPE, *probe.CHECK_SHAPES, (3, 7, 11, 72, 136),
               (2, 9, 13, 3, 136), (1, 1, 1, 8, 8), (4096, 512, 512, 8, 8)]


@pytest.mark.parametrize("route", ops.ROUTES)
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_split_plan_covers_every_pixel_once(route, shape):
    n, h, wd, c, co = shape
    pixels = n * h * wd
    splits, per = ops.split_plan(route, pixels, c, co)
    assert per % 64 == 0  # whole 64-pixel slices of the wgmma kernel
    assert per % ops.SPLIT_ALIGN == 0
    # ranges [s * per, (s + 1) * per) cut at N*H*W: each pixel in exactly one
    assert (splits - 1) * per < pixels <= splits * per
    assert 1 <= splits <= 65535  # a grid dimension of the launch
    assert per * splits < ops.INT32_LIMIT
    assert ops.split_plan(route, pixels, c, co) == (splits, per)
    if route in ("wgmma", "fp32"):  # one block on each SM
        tiles = 3 * -(-c // 64) * -(-co // 128)
        assert tiles * splits <= max(ops.WAVE_BLOCKS, tiles)


def test_split_plan_fills_one_wave_at_the_bench_shape():
    n, h, wd, c, co = probe.BENCH_SHAPE
    assert ops.split_plan("wgmma", n * h * wd, c, co) == (44, 34240)
    assert 3 * 44 == ops.WAVE_BLOCKS  # one block per SM of the H100
    # fp32: the same blocks (dy, 64 channels, 128 output channels), one
    # on each SM
    assert ops.split_plan("fp32", n * h * wd, c, co) == (44, 34240)
    # the wmma route keeps the plan of at most MAX_SPLITS ranges
    assert ops.split_plan("wmma", n * h * wd, c, co) == (256, 5888)


@pytest.mark.parametrize("dtype, shape, aligned, route", [
    (torch.bfloat16, probe.BENCH_SHAPE, True, "wgmma"),
    (torch.bfloat16, probe.CHECK_SHAPES[0], True, "wgmma"),
    (torch.bfloat16, probe.CHECK_SHAPES[1], True, "wgmma"),
    (torch.bfloat16, (3, 7, 11, 72, 136), True, "wgmma"),
    (torch.bfloat16, (2, 3, 70, 16, 24), True, "wgmma"),
    (torch.bfloat16, (1, 1, 1, 8, 8), True, "wgmma"),
    (torch.bfloat16, (2, 9, 13, 3, 136), True, "wmma"),
    (torch.bfloat16, (1, 4, 4, 16, 12), True, "wmma"),
    (torch.bfloat16, probe.BENCH_SHAPE, False, "wmma"),
    (torch.float32, probe.BENCH_SHAPE, True, "fp32"),
    (torch.float32, (2, 9, 13, 3, 136), True, "fp32"),
], ids=lambda v: str(v).removeprefix("torch."))
def test_wgrad_route_picks_the_kernel_by_shape(dtype, shape, aligned, route):
    *_, c, co = shape
    assert ops.wgrad_route(dtype, c, co, aligned=aligned) == route


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


def test_wgrad_ablation_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        wgrad_ablation.main()


@pytest.mark.parametrize("dtype, c, co, aligned, route", [
    (torch.bfloat16, 64, 128, True, "wgmma"),  # the bench shape's forward
    (torch.bfloat16, 128, 64, True, "wgmma"),  # its dgrad (C, Co swapped)
    (torch.bfloat16, 8, 8, True, "wgmma"),
    (torch.bfloat16, 72, 64, True, "wgmma"),  # C_pad 128, BN 64: fits
    (torch.bfloat16, 16, 136, True, "wgmma"),  # two output-channel blocks
    (torch.bfloat16, 72, 136, True, "wmma"),  # C_pad 128, BN 128: too big
    (torch.bfloat16, 136, 16, True, "wmma"),  # C_pad 192: too big
    (torch.bfloat16, 256, 256, True, "wmma"),  # too big
    (torch.bfloat16, 3, 136, True, "wmma"),  # C % 8 != 0
    (torch.bfloat16, 16, 12, True, "wmma"),  # Co % 8 != 0
    (torch.bfloat16, 64, 128, False, "wmma"),  # unaligned tensors
    (torch.float32, 64, 128, True, "fp32"),
    (torch.float32, 3, 136, True, "fp32"),
], ids=lambda v: str(v).removeprefix("torch."))
def test_fwd_route_picks_the_kernel_by_shape(dtype, c, co, aligned, route):
    assert ops.fwd_route(dtype, c, co, aligned=aligned) == route


def test_fwd_shared_memory_plan_at_the_bench_shapes():
    # 1 KB to align + weights 9 * 64 * 128 * 2 + two 64 x 128 output tiles +
    # two rings of 3 stages of 66 rows of 128 bytes and an mbarrier each +
    # a zero row: within the 232,448 bytes a block may have.
    n, h, wd, c, co = probe.BENCH_SHAPE
    fwd = ops.fwd_smem_bytes(c, co)
    dgrad = ops.fwd_smem_bytes(co, c)
    assert fwd == 1024 + 147456 + 32768 + 6 * (8448 + 8) + 128 == 232112
    assert dgrad == 1024 + 147456 + 16384 + 6 * (8448 + 8) + 128 == 215728
    assert max(fwd, dgrad) <= ops.FWD_SMEM_LIMIT
    assert ops.fwd_smem_bytes(256, 256) > ops.FWD_SMEM_LIMIT


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


chip_smoke = _load_chip_smoke()


@pytest.mark.parametrize("shape", list(chip_smoke.CONV_RAGGED_SHAPES),
                         ids=str)
def test_chip_smoke_names_the_routes_the_wrappers_take(shape):
    """chip_smoke.py fails on the card if a call goes another way than its
    table says; the table must agree with the route functions."""
    *_, c, co = shape
    fwd, dgrad, wgrad = chip_smoke.CONV_RAGGED_SHAPES[shape]
    assert ops.fwd_route(torch.bfloat16, c, co) == fwd
    assert ops.fwd_route(torch.bfloat16, co, c) == dgrad
    assert ops.wgrad_route(torch.bfloat16, c, co) == wgrad


def test_reset_launches_clears_every_route_count():
    ops.fwd_routes["conv3x3"]["wgmma"] = 3
    ops.fwd_routes["conv3x3_dgrad"]["wmma"] = 2
    ops.wgrad_routes["fp32"] = 1
    ops.launches["conv3x3"] = 4
    ops.reset_launches()
    assert all(v == 0 for v in ops.launches.values())
    assert all(v == 0 for v in ops.wgrad_routes.values())
    assert all(v == 0 for r in ops.fwd_routes.values() for v in r.values())
    # CPU tensors take the plain version and count nothing
    x, w, g = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(1, 3, 4, 8, 8))
    ops.conv3x3(x, w)
    ops.conv3x3_dgrad(g, w)
    assert all(v == 0 for r in ops.fwd_routes.values() for v in r.values())


def _halo_model(x, w):
    """The wgmma forward's data path in numpy: 64-pixel tiles; for each tap
    row dy a halo of 66 consecutive flat pixel rows (zero outside [0, M),
    channels padded to a multiple of 64); output row r takes tap (dy, dx)
    from halo row r + dx, or zeros where the tap leaves the image."""
    n, h, wd, c = x.shape
    co = w.shape[3]
    m = n * h * wd
    c_pad = -(-c // 64) * 64
    xf = np.zeros((m, c_pad), np.float64)
    xf[:, :c] = x.reshape(m, c)
    wp = np.zeros((3, 3, c_pad, co), np.float64)
    wp[:, :, :c] = w
    y = np.zeros((m, co), np.float64)
    rows = np.arange(64)
    for m0 in range(0, m, 64):
        p = m0 + rows
        ph, pw = p // wd % h, p % wd
        tile = np.zeros((64, co))
        for dy in range(3):
            src = m0 - 1 + (dy - 1) * wd + np.arange(66)
            inside = (src >= 0) & (src < m)
            halo = np.where(inside[:, None], xf[np.clip(src, 0, m - 1)], 0.0)
            for dx in range(3):
                ok = ((p < m) & (ph + dy - 1 >= 0) & (ph + dy - 1 < h)
                      & (pw + dx - 1 >= 0) & (pw + dx - 1 < wd))
                tile += np.where(ok[:, None], halo[rows + dx], 0.0) @ wp[dy, dx]
        keep = p < m
        y[p[keep]] = tile[keep]
    return y.reshape(n, h, wd, co)


# (N, H, W, C, Co): images smaller than a tile (one tile spans several,
# every dy border inside it), rows longer than a tile (W = 70), C = 72 (two
# channel slices, the second ragged), one pixel, pixels not a multiple of 64
@pytest.mark.parametrize("shape", [(5, 3, 3, 8, 16), (1, 2, 70, 8, 8),
                                   (2, 5, 7, 72, 16), (1, 1, 1, 8, 8),
                                   (3, 7, 11, 16, 8)], ids=str)
def test_halo_model_of_the_wgmma_forward_is_the_conv(shape):
    x, w, _ = _inputs(*shape)
    ref = ops.conv3x3_plain(torch.from_numpy(x), torch.from_numpy(w))
    assert _rel_err(_halo_model(x, w), ref.numpy()) < RTOL


def test_fwd_ablation_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        fwd_ablation.main()


def _f32_wgrad_model(x, g, per):
    """The fp32 weight gradient's data path in numpy: pixel ranges of
    ``per``; for each range, tap row dy and 32-pixel slice a halo of 34
    flat pixel rows (the slice's pixels - 1 .. + 32) of x shifted by dy rows,
    zero where that shift leaves the image or outside [0, M); g zero past
    the range; pixel r takes tap (dy, dx) from halo row r + dx, or zeros
    where r starts (dx = 0) or ends (dx = 2) its image row."""
    n, h, wd, c = x.shape
    co = g.shape[3]
    m = n * h * wd
    xf = x.reshape(m, c).astype(np.float64)
    gf = g.reshape(m, co).astype(np.float64)
    out = np.zeros((3, 3, c, co))
    rows = np.arange(32)
    for pb in range(0, m, per):
        pe = min(m, pb + per)
        for dy in range(3):
            for ps in range(pb, pe, 32):
                q = ps - 1 + np.arange(34)
                hq = q // wd % h  # pixel -1: the last row of an image
                inside = ((q >= 0) & (q < m) & (hq + dy - 1 >= 0)
                          & (hq + dy - 1 < h))
                src = np.clip(q + (dy - 1) * wd, 0, m - 1)
                halo = np.where(inside[:, None], xf[src], 0.0)
                p = ps + rows
                gt = np.where((p < pe)[:, None], gf[np.clip(p, 0, m - 1)],
                              0.0)
                pw = p % wd
                for dx in range(3):
                    a = halo[rows + dx]
                    if dx == 0:
                        a = np.where((pw == 0)[:, None], 0.0, a)
                    if dx == 2:
                        a = np.where((pw == wd - 1)[:, None], 0.0, a)
                    out[dy, dx] += a.T @ gt
    return out


# (N, H, W, C, Co): images smaller than a slice (9 pixels: one slice spans
# several, every dy border inside it), rows longer than a slice (W = 70),
# C = 72 (ragged, two channel blocks), one pixel, and 231 pixels (not a
# multiple of the 32-pixel slice); each with the split plan of the fp32
# route and with ranges of 64 pixels (several splits, slices that start
# mid-row).
@pytest.mark.parametrize("per", [None, 64], ids=["plan", "per64"])
@pytest.mark.parametrize("shape", [(5, 3, 3, 8, 16), (1, 2, 70, 8, 8),
                                   (2, 5, 7, 72, 16), (1, 1, 1, 8, 8),
                                   (3, 7, 11, 16, 8)], ids=str)
def test_halo_model_of_the_f32_weight_gradient_is_the_wgrad(shape, per):
    x, _, g = _inputs(*shape)
    n, h, wd, c, co = shape
    if per is None:
        _, per = ops.split_plan("fp32", n * h * wd, c, co)
    ref = ops.conv3x3_wgrad_plain(torch.from_numpy(x), torch.from_numpy(g))
    assert _rel_err(_f32_wgrad_model(x, g, per), ref.numpy()) < RTOL


def _f32_fwd_model(x, w, bm):
    """The fp32 halo forward's data path (the tile for Co <= 64, which the
    dgrad of the bench shape takes) in numpy: tiles of ``bm`` pixels; for
    each tap row dy a halo of bm + 2 flat pixel rows (the tile's pixels
    - 1 .. + bm) of x shifted by dy rows, zero where that shift leaves the
    image or outside [0, M); pixel r of the tile takes tap (dy, dx) from
    halo row r + dx, or zeros where it starts (dx = 0) or ends (dx = 2) its
    image row."""
    n, h, wd, c = x.shape
    co = w.shape[3]
    m = n * h * wd
    xf = x.reshape(m, c).astype(np.float64)
    y = np.zeros((m, co))
    rows = np.arange(bm)
    for m0 in range(0, m, bm):
        p = m0 + rows
        pw = p % wd
        tile = np.zeros((bm, co))
        for dy in range(3):
            q = m0 - 1 + np.arange(bm + 2)
            hq = q // wd % h
            inside = ((q >= 0) & (q < m) & (hq + dy - 1 >= 0)
                      & (hq + dy - 1 < h))
            src = np.clip(q + (dy - 1) * wd, 0, m - 1)
            halo = np.where(inside[:, None], xf[src], 0.0)
            for dx in range(3):
                a = halo[rows + dx]
                if dx == 0:
                    a = np.where((pw == 0)[:, None], 0.0, a)
                if dx == 2:
                    a = np.where((pw == wd - 1)[:, None], 0.0, a)
                tile += a @ w[dy, dx]
        keep = p < m
        y[p[keep]] = tile[keep]
    return y.reshape(n, h, wd, co)


# The shapes of the weight gradient's model; each with the kernel's
# 256-pixel tile and with 8-pixel tiles (many tiles, tiles that start and
# end mid-row).
@pytest.mark.parametrize("bm", [256, 8])
@pytest.mark.parametrize("shape", [(5, 3, 3, 8, 16), (1, 2, 70, 8, 8),
                                   (2, 5, 7, 72, 16), (1, 1, 1, 8, 8),
                                   (3, 7, 11, 16, 8)], ids=str)
def test_halo_model_of_the_f32_forward_is_the_conv(shape, bm):
    x, w, _ = _inputs(*shape)
    ref = ops.conv3x3_plain(torch.from_numpy(x), torch.from_numpy(w))
    assert _rel_err(_f32_fwd_model(x, w, bm), ref.numpy()) < RTOL


def test_f32_shared_memory_plan_at_the_bench_shapes():
    # forward (Co = 128): 2 stages of A 32 x (256 + 4) and B 32 x 128
    # floats; dgrad (Co = 64): 2 stages of a halo tile 32 x (256 + 4) and B
    # 3 x 32 x 64;
    # weight gradient: 6 stages of a 34 x 64 halo and a 32 x 128 g tile + a
    # zero row of 64 floats. Each within the 232,448 bytes a block may have.
    fwd = ops.f32_smem_bytes("forward", 128)
    dgrad = ops.f32_smem_bytes("forward", 64)
    wgrad = ops.f32_smem_bytes("wgrad")
    assert fwd == 2 * (32 * 260 + 32 * 128) * 4 == 99328
    assert dgrad == 2 * (32 * 260 + 3 * 32 * 64) * 4 == 115712
    assert wgrad == 6 * (34 * 64 + 32 * 128) * 4 + 256 == 150784
    assert max(fwd, dgrad, wgrad) <= ops.FWD_SMEM_LIMIT
    assert ops.f32_smem_bytes("forward", 65) == fwd


@pytest.mark.parametrize("variant", list(f32_ablation.VARIANTS))
def test_f32_ablation_edits_match_the_source(variant):
    """Each edit finds its text: once, or in both fp32 forward kernels."""
    text = ops.SOURCE.read_text()
    for old, _ in f32_ablation.VARIANTS[variant]:
        assert text.count(old) in (1, 2), old


def test_f32_ablation_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        f32_ablation.main()
