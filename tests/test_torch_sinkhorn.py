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
