"""The port's fused SK iteration and SK solver against the JAX package.

The fused iteration's plain version (what the wrapper runs for a CPU
tensor) is held against the Pallas kernel in interpret mode, as the JAX
package's own tests run it. Tolerance 1e-5 on the SK vectors: the same fp32
logsumexp arithmetic, summed in a different order (the Pallas kernel folds
the column sums tile by tile). The solvers must agree exactly on labels and
iteration counts: both walk the same beta chain with the same float32
stopping rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selavi_tpu.ops.sinkhorn_pallas import fused_sk_iteration as jax_fused
from selavi_tpu.selflabel.sinkhorn import sinkhorn_knopp as jax_sk
from selavi_tpu_torch.experiments import sk_ablation
from selavi_tpu_torch.ops import sinkhorn_fused
from selavi_tpu_torch.selflabel.sinkhorn import sinkhorn_assign, sinkhorn_knopp

torch.set_num_threads(1)


def _log_ps(n, k, seed):
    """log softmax_v + log softmax_a of random logits (the JAX fixtures)."""
    rng = np.random.default_rng(seed)
    lv = rng.standard_normal((n, k)) * 2
    la = rng.standard_normal((n, k)) * 2
    log_ps = (jax.nn.log_softmax(jnp.asarray(lv, jnp.float32), 1)
              + jax.nn.log_softmax(jnp.asarray(la, jnp.float32), 1))
    return np.array(log_ps), np.full(k, -np.log(k), np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_fused_iteration_matches_pallas_interpret(dtype):
    n, k = 300, 37  # deliberately unaligned
    log_ps, log_r = _log_ps(n, k, 0)
    m32 = 10.0 * log_ps
    log_beta = np.full(n, -np.log(np.float32(n)), np.float32)
    log_alpha = np.array(
        log_r - jax.scipy.special.logsumexp(m32 + log_beta[:, None], axis=0),
        np.float32)

    jm = jnp.asarray(m32).astype(getattr(jnp, dtype))
    ref = jax_fused(jm, jnp.asarray(log_alpha), jnp.asarray(log_beta),
                    jnp.asarray(log_r), tile_n=128, interpret=True)
    tm = torch.from_numpy(m32).to(getattr(torch, dtype))
    args = (torch.from_numpy(log_alpha), torch.from_numpy(log_beta),
            torch.from_numpy(log_r))
    plain = sinkhorn_fused.fused_sk_iteration_plain(tm, *args)
    sinkhorn_fused.reset_launches()
    wrapped = sinkhorn_fused.fused_sk_iteration(tm, *args)
    assert sinkhorn_fused.launches == 0  # CPU tensors never launch

    for ours in (plain, wrapped):
        np.testing.assert_allclose(ours[0].numpy(), np.asarray(ref[0]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ours[1].numpy(), np.asarray(ref[1]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(ours[2]), float(ref[2]), rtol=1e-5)


@pytest.mark.parametrize("backend", ["plain", "fused"])
@pytest.mark.parametrize("n,k,seed", [(257, 12, 1), (300, 37, 0),
                                      (300, 10, 2)])
def test_solver_labels_and_iters_match_jax(backend, n, k, seed):
    log_ps, log_r = _log_ps(n, k, seed)
    ref = jax_sk(jnp.asarray(log_ps), jnp.asarray(log_r), lamb=20.0)
    res = sinkhorn_knopp(torch.from_numpy(log_ps), torch.from_numpy(log_r),
                         lamb=20.0, backend=backend)
    assert res.iters == int(ref.iters)
    np.testing.assert_array_equal(res.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_allclose(res.cost, float(ref.cost), rtol=1e-5)


def test_solver_matches_jax_pallas_backend():
    log_ps, log_r = _log_ps(257, 12, 1)
    ref = jax_sk(jnp.asarray(log_ps), jnp.asarray(log_r), lamb=20.0,
                 use_pallas=True, interpret=True)
    res = sinkhorn_knopp(torch.from_numpy(log_ps), torch.from_numpy(log_r),
                         lamb=20.0, backend="fused")
    assert res.iters == int(ref.iters)
    np.testing.assert_array_equal(res.labels.numpy(), np.asarray(ref.labels))


def test_bf16_m_labels_agree_with_fp32():
    log_ps, log_r = _log_ps(300, 10, 2)
    args = (torch.from_numpy(log_ps), torch.from_numpy(log_r))
    r32 = sinkhorn_knopp(*args, backend="fused")
    r16 = sinkhorn_knopp(*args, backend="fused", m_bf16=True)
    assert (r32.labels == r16.labels).float().mean() > 0.97


def _plateau_instance():
    """Sharp zipf-imbalanced logits whose bf16 error floor sits between
    tol and N*2^-8 (tests/test_sinkhorn.py's plateau fixture)."""
    rng = np.random.default_rng(11)
    n, k = 2048, 32
    p = np.arange(1, k + 1, dtype=np.float64) ** -0.5
    classes = rng.choice(k, size=n, p=p / p.sum())
    logits = np.full((n, k), -8.0, np.float32)
    logits[np.arange(n), classes] = 8.0
    logits += rng.standard_normal((n, k)).astype(np.float32)
    ls = logits - logits.max(1, keepdims=True)
    log_ps = (np.log(np.exp(ls) / np.exp(ls).sum(1, keepdims=True))
              * 2.0).astype(np.float32)
    return log_ps, np.full(k, -np.log(k), np.float32)


def _stall_instance():
    """Extreme sharpness: the bf16 floor sits above N*2^-8, so only the
    windowed stall exit can fire (tests/test_sinkhorn.py's stall fixture)."""
    rng = np.random.default_rng(0)
    n, k = 4096, 64
    gt = rng.integers(0, k, n)
    eye = np.eye(k, dtype=np.float32)
    lv = 15.0 * eye[gt] + 0.1 * rng.standard_normal((n, k)).astype(np.float32)
    la = 15.0 * eye[gt] + 0.1 * rng.standard_normal((n, k)).astype(np.float32)
    log_ps = np.array(jax.nn.log_softmax(jnp.asarray(lv), 1)
                      + jax.nn.log_softmax(jnp.asarray(la), 1))
    r = np.clip(rng.normal(0, 0.1, k) + 1.0, 0.2, None)
    return log_ps, np.log(r / r.sum()).astype(np.float32)


@pytest.mark.parametrize("instance", [_plateau_instance, _stall_instance],
                         ids=["plateau", "stall"])
@pytest.mark.parametrize("backend", ["plain", "fused"])
def test_bf16_early_exits_fire_as_in_jax(instance, backend):
    log_ps, log_r = instance()
    ref = jax_sk(jnp.asarray(log_ps), jnp.asarray(log_r), m_bf16=True)
    res = sinkhorn_knopp(torch.from_numpy(log_ps), torch.from_numpy(log_r),
                         m_bf16=True, backend=backend)
    assert int(ref.iters) < 2000 and float(ref.err) > 0.1  # an early exit
    # At the bf16 floor the error jitters from check to check, and the two
    # frameworks sum it in different orders, so the exit may land one check
    # (10 iterations) apart; it must fire on the same instance.
    assert res.iters < 2000 and res.err > 0.1
    assert abs(res.iters - int(ref.iters)) <= 10
    assert (res.labels.numpy() == np.asarray(ref.labels)).mean() > 0.995


def test_sinkhorn_assign_uniform_default_marginal():
    rng = np.random.default_rng(4)
    lv = torch.from_numpy(rng.standard_normal((200, 9)).astype(np.float32))
    la = torch.from_numpy(rng.standard_normal((200, 9)).astype(np.float32))
    res = sinkhorn_assign(lv, la)
    ref = jax_sk(jax.nn.log_softmax(jnp.asarray(lv.numpy()), 1)
                 + jax.nn.log_softmax(jnp.asarray(la.numpy()), 1),
                 jnp.full((9,), -jnp.log(jnp.float32(9))))
    assert res.iters == int(ref.iters)
    np.testing.assert_array_equal(res.labels.numpy(), np.asarray(ref.labels))


def test_wrapper_rejects_unsupported_inputs():
    m = torch.zeros(4, 3, dtype=torch.float64)
    v = torch.zeros(3)
    with pytest.raises(TypeError):
        sinkhorn_fused._check(m, v, torch.zeros(4), v)
    with pytest.raises(ValueError):
        sinkhorn_fused._check(torch.zeros(4, sinkhorn_fused.MAX_K + 1),
                              torch.zeros(sinkhorn_fused.MAX_K + 1),
                              torch.zeros(4),
                              torch.zeros(sinkhorn_fused.MAX_K + 1))


@pytest.mark.parametrize("k", [1, 37, 309, 512])
@pytest.mark.parametrize("n", [1, 7, 480, 170752, 170753])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_tiles_cover_m_in_16_byte_copies(dtype, n, k):
    """plan() (the mirror of csrc/fused_sk.cu's tiling): whole-row tiles of
    a multiple of 8 rows, bulk copies of whole 16-byte units that with the
    last tile's few ordinary loads cover every byte of M once, one block a
    SM at most, and a ring of at least 3 stages within a block's shared
    memory."""
    sms = 132
    p = sinkhorn_fused.plan(n, k, dtype, sms)
    elem = 2 if dtype == torch.bfloat16 else 4
    assert p.tile_rows % 8 == 0
    assert p.stage_bytes == p.tile_rows * k * elem and p.stage_bytes % 16 == 0
    assert 1 <= p.grid <= min(sms, p.tiles)
    assert p.tiles == -(-n // p.tile_rows)
    last_rows = n - (p.tiles - 1) * p.tile_rows
    assert 1 <= last_rows <= p.tile_rows
    assert p.bulk_bytes_last % 16 == 0 and 0 <= p.rest_bytes_last < 16
    assert p.bulk_bytes_last + p.rest_bytes_last == last_rows * k * elem
    full_tiles = p.tiles - 1
    assert (full_tiles * p.stage_bytes + p.bulk_bytes_last
            + p.rest_bytes_last) == n * k * elem
    # Block b takes tiles b, b + grid, ...: each tile exactly once.
    taken = np.concatenate([np.arange(b, p.tiles, p.grid)
                            for b in range(p.grid)])
    assert np.array_equal(np.sort(taken), np.arange(p.tiles))
    assert 3 <= p.stages <= sinkhorn_fused.MAX_STAGES
    assert p.smem_bytes == sinkhorn_fused.HEADER_BYTES + p.stages * p.stage_bytes
    assert p.smem_bytes <= 232448
    # The block's merge buffers (the consumer warps' column pairs and
    # errors) fit in the ring they reuse.
    warps = sinkhorn_fused.CONSUMER_WARPS
    assert p.stages * p.stage_bytes >= (2 * warps * k + warps) * 4
    assert p.groups == -(-p.grid // sinkhorn_fused.GROUP)
    assert p.scratch_floats == (p.grid + p.groups) * (k + 1)


def test_plan_at_vggsound_scale():
    f32 = sinkhorn_fused.plan(170752, 309, torch.float32, 132)
    bf16 = sinkhorn_fused.plan(170752, 309, torch.bfloat16, 132)
    assert f32.tile_rows == bf16.tile_rows == 48  # 12 warps x 4 rows
    assert (f32.grid, f32.stages, f32.stage_bytes, f32.smem_bytes) == (
        132, 3, 59328, 178240)
    assert (bf16.grid, bf16.stages, bf16.stage_bytes, bf16.smem_bytes) == (
        132, 3, 29664, 89248)
    assert f32.tiles == 3558 and f32.rest_bytes_last == 0
    # Rows of more than 384 columns: 2 rows a warp, so 3 stages still fit.
    wide = sinkhorn_fused.plan(170752, 512, torch.float32, 132)
    assert (wide.tile_rows, wide.stages) == (24, 3)
    # Narrow rows: a deeper ring of small tiles, up to MAX_STAGES.
    assert sinkhorn_fused.plan(170752, 37, torch.float32, 132).stages == 8
    with pytest.raises(ValueError):
        sinkhorn_fused.plan(0, 309, torch.float32, 132)
    with pytest.raises(ValueError):
        sinkhorn_fused.plan(10, sinkhorn_fused.MAX_K + 1, torch.float32, 132)


def test_check_rejects_an_m_off_a_16_byte_boundary():
    n, k = 300, 37
    flat = torch.zeros(1 + n * k)
    m = flat[1:].view(n, k)  # contiguous, 4 bytes past an aligned start
    assert m.is_contiguous() and m.data_ptr() % 16 == 4
    vecs = (torch.zeros(k), torch.zeros(n), torch.zeros(k))
    with pytest.raises(ValueError, match="16-byte"):
        sinkhorn_fused._check(m, *vecs)
    sinkhorn_fused._check(torch.zeros(n, k), *vecs)  # aligned: accepted


def test_plain_iteration_writes_into_out_on_the_cpu():
    log_ps, log_r = _log_ps(64, 9, 3)
    m = torch.from_numpy(10.0 * log_ps)
    la = torch.from_numpy(log_r).clone()
    lb = torch.full((64,), -float(np.log(64)))
    lr = torch.from_numpy(log_r)
    out = (torch.empty(9), torch.empty(64), torch.empty(()))
    assert sinkhorn_fused.make_workspace(m) is None  # the CPU needs none
    got = sinkhorn_fused.fused_sk_iteration(m, la, lb, lr, out=out)
    ref = sinkhorn_fused.fused_sk_iteration_plain(m, la, lb, lr)
    for g, o, r in zip(got, out, ref):
        assert g is o
        assert torch.equal(o, r)


def test_fused_solver_rotates_two_alpha_and_two_beta_buffers(monkeypatch):
    """Iteration t reads the buffers iteration t - 1 wrote and writes the
    other pair; the alpha that the labels use is the last one read."""
    from selavi_tpu_torch.selflabel import sinkhorn as solver

    calls = []
    real = solver.fused_sk_iteration

    def spy(m, log_alpha, log_beta, log_r, out=None, workspace=None):
        calls.append((log_alpha, log_beta, out))
        return real(m, log_alpha, log_beta, log_r, out=out,
                    workspace=workspace)

    monkeypatch.setattr(solver, "fused_sk_iteration", spy)
    log_ps, log_r = _log_ps(257, 12, 1)
    res = sinkhorn_knopp(torch.from_numpy(log_ps), torch.from_numpy(log_r),
                         backend="fused")
    assert len(calls) == res.iters > 2
    for (a0, b0, out0), (a1, b1, out1) in zip(calls, calls[1:]):
        assert a1 is out0[0] and b1 is out0[1]
        assert out1[0] is a0 and out1[1] is b0 and out1[2] is out0[2]
    ref = jax_sk(jnp.asarray(log_ps), jnp.asarray(log_r), lamb=20.0)
    np.testing.assert_array_equal(res.labels.numpy(), np.asarray(ref.labels))


@pytest.mark.parametrize("alias,backend", [("pallas", "fused"),
                                           ("xla", "plain")])
def test_jax_backend_names_are_aliases(alias, backend):
    from selavi_tpu_torch.config import parse_arguments
    from selavi_tpu_torch.selflabel.sinkhorn import resolve_backend

    args = parse_arguments().parse_args(["--sk_backend", alias])
    assert args.sk_backend == alias
    assert resolve_backend(alias, torch.device("cpu")) == backend
    log_ps, log_r = _log_ps(300, 10, 2)
    a = sinkhorn_knopp(torch.from_numpy(log_ps), torch.from_numpy(log_r),
                       backend=alias)
    b = sinkhorn_knopp(torch.from_numpy(log_ps), torch.from_numpy(log_r),
                       backend=backend)
    assert a.iters == b.iters and torch.equal(a.labels, b.labels)


@pytest.mark.parametrize("variant", list(sk_ablation.VARIANTS))
def test_sk_ablation_edits_match_the_source(variant):
    """Each edit of the SK ablation finds its text exactly once."""
    text = sinkhorn_fused.SOURCE.read_text()
    for old, _ in sk_ablation.VARIANTS[variant]:
        assert text.count(old) == 1, old


def test_sk_ablation_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        sk_ablation.main([])
