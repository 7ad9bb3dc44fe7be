"""The port's self-labeling engine against the JAX package's ``cluster()``.

The same features, head weights and ``np.random.default_rng(seed)`` go
into both; the stub encoder passes features through, so the comparison is
of the engine itself: head-order shuffle, marginals (the Gaussian draws and
the sorting trick consume the same host RNG stream), the per-head SK solve
and the label write. Labels must be identical.

With matching at the first SK step the two engines must also pick the
same audio-head permutations and leave the host rng in the same state,
under both host runtimes: the C++ search of each package's data runtime
(``native``), and the Python loop when that library is unavailable
(``numpy``).
"""

import jax.numpy as jnp
from jax.nn import softmax as jax_softmax
import numpy as np
import pytest
import torch

from selavi_tpu import native as jax_native
from selavi_tpu.selflabel import matching as jmatch
from selavi_tpu.selflabel.engine import SKConfig as JaxSKConfig
from selavi_tpu.selflabel.engine import cluster as jax_cluster
from selavi_tpu.selflabel.marginals import MarginalState as JaxMarginalState
from selavi_tpu_torch import native
from selavi_tpu_torch.models.heads import HeadStack
from selavi_tpu_torch.selflabel import engine, matching
from selavi_tpu_torch.selflabel.engine import (
    SKConfig,
    aggregate_features,
    cluster,
    normalized_mutual_info,
)
from selavi_tpu_torch.selflabel.marginals import MarginalState

torch.set_num_threads(1)


def _problem(n=64, k=6, h=3, d=32, seed=0):
    rng = np.random.default_rng(seed)
    true = rng.integers(0, k, n)
    centers = rng.standard_normal((k, d)) * 3
    fv = (centers[true] + rng.standard_normal((n, d)) * 0.3).astype(np.float32)
    fa = (centers[true] + rng.standard_normal((n, d)) * 0.3).astype(np.float32)
    wv = (rng.standard_normal((h, d, k)) * 0.05).astype(np.float32)
    wa = (rng.standard_normal((h, d, k)) * 0.05).astype(np.float32)
    return true, fv, fa, wv, wa


def _batches(fv, fa, to_array, bs=16):
    n = len(fv)
    for s in range(0, n, bs):
        idx = np.arange(s, min(s + bs, n))
        yield {"video": to_array(fv[idx]), "audio": to_array(fa[idx]),
               "index": idx}


@pytest.mark.parametrize("backend", ["plain", "fused"])
@pytest.mark.parametrize("distribution", ["default", "gauss"])
@pytest.mark.parametrize("ind_groups,cache", [(1, False), (3, False),
                                              (2, False), (2, True)])
def test_cluster_matches_jax(backend, distribution, ind_groups, cache):
    """With ``cache`` the groups re-read the first pass's batches: one
    ``make_batch_iter`` call an SK step instead of one a group."""
    n, k, h, d = 64, 6, 3, 32
    true, fv, fa, wv, wa = _problem(n, k, h, d)
    jcalls, calls = [], []

    def jax_batch_iter():
        jcalls.append(1)
        return _batches(fv, fa, jnp.asarray)

    def batch_iter():
        calls.append(1)
        return _batches(fv, fa, torch.from_numpy)

    jcfg = JaxSKConfig(headcount=h, num_clusters=k, ind_groups=ind_groups,
                       match=False, distribution=distribution,
                       sk_backend="xla", feat_dim=d,
                       cache_group_batches=cache)
    jlabels, jstate, jmetrics, _ = jax_cluster(
        encode_fn=lambda v, a: (v, a),
        head_logits_fn=lambda p, f, m: jnp.einsum(
            "nd,hdk->hnk", f, jnp.asarray(wv if m == "v" else wa)),
        make_batch_iter=jax_batch_iter,
        params={}, n=n, cfg=jcfg, selflabels=np.zeros((n, h), np.int32),
        marginal_state=JaxMarginalState(), iter_num=1,
        np_rng=np.random.default_rng(7), true_labels=true,
    )

    cfg = SKConfig(headcount=h, num_clusters=k, ind_groups=ind_groups,
                   match=False, distribution=distribution, sk_backend=backend,
                   cache_group_batches=cache)
    labels, state, metrics = cluster(
        encode_fn=lambda v, a: (v, a),
        head_logits_fn=lambda f, m: torch.einsum(
            "nd,hdk->hnk", f, torch.from_numpy(wv if m == "v" else wa)),
        make_batch_iter=batch_iter,
        n=n, cfg=cfg, selflabels=np.zeros((n, h), np.int32),
        marginal_state=MarginalState(), iter_num=1,
        np_rng=np.random.default_rng(7), device="cpu", true_labels=true,
    )
    assert len(calls) == len(jcalls) == (1 if cache else ind_groups)
    np.testing.assert_array_equal(labels, jlabels)
    if distribution == "gauss":
        np.testing.assert_array_equal(state.dists, jstate.dists)
    np.testing.assert_allclose(metrics["sk_cost"], jmetrics["sk_cost"],
                               rtol=1e-5)
    for key in ("nmi_vs_gt", "anmi_vs_gt", "nmi_vs_old"):
        np.testing.assert_allclose(metrics[key], jmetrics[key], rtol=1e-9,
                                   atol=1e-12, err_msg=key)
    # the split of the step: disjoint spans inside sk_time
    assert set(engine.timings) == {"aggregate_s", "match_s", "solve_s"}
    assert engine.timings["match_s"] == 0.0  # no matching at iter_num 1
    assert 0 < sum(engine.timings.values()) <= metrics["sk_time"]


@pytest.fixture(params=["native", "numpy"])
def host_runtime(request, monkeypatch):
    """Both packages' host data runtimes: built (``native``), or both
    unavailable so that matching runs the Python loop (``numpy``)."""
    if request.param == "numpy":
        monkeypatch.setattr(native, "_load", lambda: None)
        monkeypatch.setattr(jax_native, "_load", lambda: None)
    elif not (native.available() and jax_native.available()):
        pytest.skip("g++ did not build the host data runtimes here")
    return request.param


@pytest.mark.parametrize("ind_groups", [1, 2])
def test_cluster_with_matching_matches_jax(host_runtime, ind_groups):
    """match=True at the first SK step: the audio heads are column
    permutations of the video heads (plus noise), so the search has one
    clear optimum that fp32 sums in either order reach; both engines must
    permute the same columns, write the same labels and leave ``np_rng``
    in the same state (the port's Python loop before the C++ search drew
    no seed, and left it elsewhere)."""
    n, k, h, d = 96, 24, 3, 32
    true, fv, fa, wv, _ = _problem(n, k, h, d)
    rng = np.random.default_rng(11)
    wa = np.stack([wv[i][:, rng.permutation(k)] for i in range(h)])
    wa = (wa + rng.standard_normal(wa.shape) * 0.02).astype(np.float32)
    ba = (rng.standard_normal((h, k)) * 0.01).astype(np.float32)

    def jax_logits(p, f, m):
        proj = p["heads_v" if m == "v" else "heads_a"]["heads"]["proj"]
        return (jnp.einsum("nd,hdk->hnk", f, proj["kernel"])
                + proj["bias"][:, None, :])

    params = {name: {"heads": {"proj": {"kernel": jnp.asarray(w),
                                        "bias": jnp.asarray(b)}}}
              for name, w, b in (("heads_v", wv, np.zeros((h, k),
                                                           np.float32)),
                                 ("heads_a", wa, ba))}
    jcfg = JaxSKConfig(headcount=h, num_clusters=k, ind_groups=ind_groups,
                       match=True, sk_backend="xla", feat_dim=d)
    jrng = np.random.default_rng(7)
    jlabels, _, jmetrics, info = jax_cluster(
        encode_fn=lambda v, a: (v, a), head_logits_fn=jax_logits,
        make_batch_iter=lambda: _batches(fv, fa, jnp.asarray), params=params,
        n=n, cfg=jcfg, selflabels=np.zeros((n, h), np.int32),
        marginal_state=JaxMarginalState(), iter_num=0, np_rng=jrng,
        true_labels=true,
    )

    heads_a = HeadStack(h, d, k, use_mlp=False).eval()
    with torch.no_grad():
        heads_a.proj_weight.copy_(torch.from_numpy(wa))
        heads_a.proj_bias.copy_(torch.from_numpy(ba))
    wv_t = torch.from_numpy(wv)

    def head_logits_fn(f, modality):
        if modality == "v":
            return torch.einsum("nd,hdk->hnk", f, wv_t)
        with torch.no_grad():
            return heads_a(f)

    cfg = SKConfig(headcount=h, num_clusters=k, ind_groups=ind_groups,
                   match=True, sk_backend="plain")
    prng = np.random.default_rng(7)
    labels, _, metrics = cluster(
        encode_fn=lambda v, a: (v, a), head_logits_fn=head_logits_fn,
        make_batch_iter=lambda: _batches(fv, fa, torch.from_numpy), n=n,
        cfg=cfg, selflabels=np.zeros((n, h), np.int32),
        marginal_state=MarginalState(), iter_num=0, np_rng=prng,
        device="cpu", audio_heads=heads_a, true_labels=true,
    )

    jproj = info["params"]["heads_a"]["heads"]["proj"]
    np.testing.assert_array_equal(heads_a.proj_weight.detach().numpy(),
                                  np.asarray(jproj["kernel"]))
    np.testing.assert_array_equal(heads_a.proj_bias.detach().numpy(),
                                  np.asarray(jproj["bias"]))
    assert not np.array_equal(heads_a.proj_weight.detach().numpy(), wa)
    np.testing.assert_array_equal(labels, jlabels)
    assert prng.bit_generator.state == jrng.bit_generator.state
    np.testing.assert_allclose(metrics["sk_cost"], jmetrics["sk_cost"],
                               rtol=1e-5)
    assert engine.timings["match_s"] > 0


def test_match_order_matches_jax(host_runtime, monkeypatch):
    """``match_order`` at the main path's size (N=480, K=309) on unrelated
    logits, where the swap search ends in one of many local optima and its
    path decides which. Both packages search the JAX package's cost
    matrix (fp32 sums in another order could tie-break one swap
    differently), so this holds the search and its seeding: the same
    permutation, and ``rng`` left in the same state; and the same again
    with ``use_native=False`` (the Python loop, no seed drawn) at K=40."""
    rng = np.random.default_rng(5)
    lv = rng.standard_normal((480, 309)).astype(np.float32) * 2
    la = rng.standard_normal((480, 309)).astype(np.float32) * 2
    costs = {k: np.asarray(jmatch.column_cost_matrix(
        jax_softmax(jnp.asarray(lv[:, :k])),
        jax_softmax(jnp.asarray(la[:, :k])))) for k in (309, 40)}
    monkeypatch.setattr(matching, "column_cost_matrix",
                        lambda v, a: torch.tensor(costs[v.shape[1]]))
    for k, kw in ((309, {}), (40, {"use_native": False})):
        prng, jrng = np.random.default_rng(3), np.random.default_rng(3)
        perm = matching.match_order(torch.from_numpy(lv[:, :k]),
                                    torch.from_numpy(la[:, :k]), rng=prng,
                                    **kw)
        jperm = jmatch.match_order(jnp.asarray(lv[:, :k]),
                                   jnp.asarray(la[:, :k]), rng=jrng, **kw)
        np.testing.assert_array_equal(perm, jperm)
        assert prng.bit_generator.state == jrng.bit_generator.state
        assert sorted(perm.tolist()) == list(range(k))
        assert costs[k][np.arange(k), perm].sum() < np.trace(costs[k])


def test_column_cost_and_greedy_swap_match_jax():
    rng = np.random.default_rng(3)
    v = rng.random((500, 11)).astype(np.float32)
    a = rng.random((500, 11)).astype(np.float32)
    ours = matching.column_cost_matrix(torch.from_numpy(v),
                                       torch.from_numpy(a), block=64).numpy()
    ref = np.asarray(jmatch.column_cost_matrix(jnp.asarray(v), jnp.asarray(a),
                                               block=64))
    np.testing.assert_allclose(ours, ref, rtol=1e-5)
    perm = matching.greedy_swap_match(ref, steps=3000,
                                      rng=np.random.default_rng(9))
    jperm = jmatch.greedy_swap_match(ref, steps=3000,
                                     rng=np.random.default_rng(9))
    np.testing.assert_array_equal(perm, jperm)


def test_matching_at_first_step_aligns_audio_heads():
    """With match at iter 0 the audio HeadStack is permuted in place so that
    its kernels line up with the video heads' (audio heads are
    column-permuted video heads here)."""
    n, k, h, d = 48, 5, 2, 16
    rng = np.random.default_rng(1)
    true = rng.integers(0, k, n)
    feats = (rng.standard_normal((k, d)) * 3)[true] + rng.standard_normal(
        (n, d)) * 0.1
    feats = torch.from_numpy(feats.astype(np.float32))
    wv = torch.from_numpy(rng.standard_normal((h, d, k)).astype(np.float32))
    heads_a = HeadStack(h, d, k, use_mlp=False).eval()
    with torch.no_grad():
        heads_a.proj_weight.copy_(wv[:, :, rng.permutation(k)])
        heads_a.proj_bias.zero_()

    def head_logits_fn(f, modality):
        if modality == "v":
            return torch.einsum("nd,hdk->hnk", f, wv)
        with torch.no_grad():
            return heads_a(f)

    cluster(
        encode_fn=lambda v, a: (v, a), head_logits_fn=head_logits_fn,
        make_batch_iter=lambda: iter([{"video": feats, "audio": feats,
                                       "index": np.arange(n)}]),
        n=n, cfg=SKConfig(headcount=h, num_clusters=k, match=True),
        selflabels=np.zeros((n, h), np.int32),
        marginal_state=MarginalState(), iter_num=0,
        np_rng=np.random.default_rng(2), device="cpu", audio_heads=heads_a,
        true_labels=true,
    )
    np.testing.assert_allclose(heads_a.proj_weight.detach().numpy(),
                               wv.numpy(), rtol=1e-6)


def test_aggregate_features_scatter_by_index():
    n, d = 20, 8
    rng = np.random.default_rng(0)
    data = rng.standard_normal((n, d)).astype(np.float32)
    order = rng.permutation(n)
    batches = [{"video": torch.from_numpy(data[order[s:s + 7]]),
                "audio": torch.from_numpy(-data[order[s:s + 7]]),
                "index": order[s:s + 7]} for s in range(0, n, 7)]
    ps_v, ps_a = aggregate_features(lambda v, a: (v, a), iter(batches), n,
                                    "cpu")
    np.testing.assert_array_equal(ps_v.numpy(), data)
    np.testing.assert_array_equal(ps_a.numpy(), -data)


def test_nmi_matches_sklearn():
    from sklearn.metrics import normalized_mutual_info_score

    rng = np.random.default_rng(5)
    for _ in range(5):
        a = rng.integers(0, 7, 300)
        b = np.where(rng.random(300) < 0.6, a, rng.integers(0, 5, 300))
        np.testing.assert_allclose(
            normalized_mutual_info(a, b),
            normalized_mutual_info_score(a, b, average_method="arithmetic"),
            rtol=1e-10)
    const = np.zeros(10, int)
    assert normalized_mutual_info(const, const) == 1.0
    assert normalized_mutual_info(const, np.arange(10)) == 0.0
