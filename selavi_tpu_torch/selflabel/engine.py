"""Self-labeling engine: full-dataset features, then Sinkhorn-Knopp per head
(``selavi_tpu/selflabel/engine.py``).

1. Run the model in eval mode over the whole training set (with train
   augmentations) and scatter the pooled features into ``[N, D]`` on the
   device by sample index. Each group of heads (``ind_groups``) reads the
   dataset again, or, with ``cache_group_batches``, re-reads the device
   batches that the first group kept as it encoded them, so that only the
   device augmentations differ.
2. At the first SK step with ``match``, align each audio head's clusters to
   its video head (greedy swap search) and permute the audio head's final
   Dense in place.
3. For each head, in an order shuffled by the host RNG, solve SK on
   ``softmax_v * softmax_a`` under the configured cluster marginal and
   write the row-argmax into ``selflabels[:, head]``.
4. Report the SK cost and NMI against the previous labels and the ground
   truth (and adjusted MI against it), as ``train/{k}`` scalars to a
   TensorBoard ``writer`` when one is given, with the per-cluster entropy
   and purity histograms every 10th SK step.

The module-level ``timings`` holds the last SK step's seconds: feature
aggregation (``aggregate_s``, every group), modality matching
(``match_s``) and the SK solves summed over heads (``solve_s``). On CUDA
each boundary synchronises the device, so each span holds its own work.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from selavi_tpu_torch.eval.clustering import (
    adjusted_mutual_info,
    cluster_entropy_purity,
    normalized_mutual_info,
)
from selavi_tpu_torch.selflabel.marginals import MarginalState, get_marginal
from selavi_tpu_torch.selflabel.matching import match_order
from selavi_tpu_torch.selflabel.sinkhorn import sinkhorn_knopp

logger = logging.getLogger(__name__)

# The last SK step's split, in seconds (see the module docstring).
timings: dict = {}


@dataclasses.dataclass
class SKConfig:
    headcount: int = 1
    num_clusters: int = 256
    lamb: float = 20.0
    ind_groups: int = 1
    match: bool = True
    distribution: str = "default"  # 'default' | 'gauss'
    gauss_sd: float = 0.1
    diff_dist_every: bool = False
    diff_dist_per_head: bool = True
    sk_tol: float = 1e-1
    sk_max_iters: int = 2000
    sk_backend: str = "auto"  # 'auto' | 'fused' | 'plain' (JAX: 'pallas' | 'xla')
    sk_m_bf16: bool = False  # bf16 storage of M (half the solver's bytes)
    # keep the first aggregation pass's device batches for the other
    # groups: one read of the dataset an SK step (N samples on the device)
    cache_group_batches: bool = False
    feat_dim: int = 512  # video GAP width
    feat_dim_a: Optional[int] = None  # audio GAP width; None -> feat_dim


def aggregate_features(
    encode_fn: Callable,
    batch_iter: Iterator[dict],
    n: int,
    feat_dim: int,
    device,
    feat_dim_a: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward every batch and scatter its features into ``[N, D]`` fp32
    tensors on ``device`` at the batch's ``index`` rows."""
    ps_v = torch.zeros(n, feat_dim, dtype=torch.float32, device=device)
    ps_a = torch.zeros(n, feat_dim_a or feat_dim, dtype=torch.float32,
                       device=device)
    for batch in batch_iter:
        feat_v, feat_a = encode_fn(
            batch["video"], batch.get("audio", batch.get("audio_pcm")))
        idx = torch.as_tensor(batch["index"], dtype=torch.long).to(device)
        ps_v.index_copy_(0, idx, feat_v.float())
        ps_a.index_copy_(0, idx, feat_a.float())
    return ps_v, ps_a


def _kept(batches: Iterator[dict], store: list) -> Iterator[dict]:
    """Yield ``batches``, appending each to ``store``."""
    for batch in batches:
        store.append(batch)
        yield batch


def _synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def cluster(
    *,
    encode_fn: Callable,
    head_logits_fn: Callable,
    make_batch_iter: Callable[[], Iterator[dict]],
    n: int,
    cfg: SKConfig,
    selflabels: np.ndarray,
    marginal_state: MarginalState,
    iter_num: int,
    np_rng: np.random.Generator,
    device,
    audio_heads=None,
    true_labels: Optional[np.ndarray] = None,
    writer=None,
    sk_counter: int = 0,
) -> tuple[np.ndarray, MarginalState, dict]:
    """One full re-clustering step.

    ``encode_fn(video, audio) -> (feat_v, feat_a)`` gives eval-mode pooled
    features; ``head_logits_fn(feats [N,D], modality) -> [H, N, K]`` applies
    the current heads (modality 'v' or 'a'). ``audio_heads`` (a
    ``HeadStack``) is permuted in place when matching runs. ``writer`` (a
    TensorBoard ``SummaryWriter`` or None) gets the metrics. Returns
    ``(new_selflabels [N, H], marginal_state, metrics)``.
    """
    t_start = time.time()
    timings.update(aggregate_s=0.0, match_s=0.0, solve_s=0.0)
    old_labels = selflabels.copy()
    new_labels = selflabels.copy()
    costs, iters = [], []

    order_heads = list(range(cfg.headcount))
    np_rng.shuffle(order_heads)
    if cfg.ind_groups > cfg.headcount:
        raise ValueError("ind_groups must not exceed headcount")

    cached_batches = None
    for grp in range(cfg.ind_groups):
        heads_in_group = order_heads[grp :: cfg.ind_groups]
        t0 = time.perf_counter()
        if not cfg.cache_group_batches:
            batch_iter = make_batch_iter()
        elif cached_batches is None:
            # the first group encodes each batch as it arrives and keeps it
            cached_batches = []
            batch_iter = _kept(make_batch_iter(), cached_batches)
        else:
            batch_iter = iter(cached_batches)
        ps_v, ps_a = aggregate_features(
            encode_fn, batch_iter, n, cfg.feat_dim, device,
            feat_dim_a=cfg.feat_dim_a,
        )
        _synchronize(device)
        timings["aggregate_s"] += time.perf_counter() - t0

        if cfg.match and iter_num == 0:
            if audio_heads is None:
                raise ValueError("matching needs the audio HeadStack")
            t0 = time.perf_counter()
            logits_v_all = head_logits_fn(ps_v, "v")
            logits_a_all = head_logits_fn(ps_a, "a")
            for head in heads_in_group:
                perm = match_order(logits_v_all[head], logits_a_all[head],
                                   rng=np_rng)
                audio_heads.permute_output(head, perm)
                logger.info(
                    "matched head %d (perm fixed points: %d/%d)", head,
                    int((perm == np.arange(len(perm))).sum()), len(perm),
                )
            _synchronize(device)
            timings["match_s"] += time.perf_counter() - t0

        all_logits_v = head_logits_fn(ps_v, "v")
        all_logits_a = head_logits_fn(ps_a, "a")
        for head in heads_in_group:
            log_ps = (torch.log_softmax(all_logits_v[head].float(), dim=1)
                      + torch.log_softmax(all_logits_a[head].float(), dim=1))
            colsum = None
            if cfg.distribution != "default":
                colsum = torch.logsumexp(log_ps, dim=0).cpu().numpy()
            log_r, marginal_state = get_marginal(
                marginal_state, colsum, head, cfg.headcount, n,
                cfg.num_clusters, distribution=cfg.distribution,
                gauss_sd=cfg.gauss_sd, diff_dist_every=cfg.diff_dist_every,
                diff_dist_per_head=cfg.diff_dist_per_head, rng=np_rng,
            )
            _synchronize(device)
            t0 = time.perf_counter()
            res = sinkhorn_knopp(
                log_ps, torch.from_numpy(log_r).to(log_ps.device),
                lamb=cfg.lamb, tol=cfg.sk_tol, max_iters=cfg.sk_max_iters,
                backend=cfg.sk_backend, m_bf16=cfg.sk_m_bf16,
            )
            head_labels = res.labels.cpu().numpy().astype(np.int32)
            solve_s = time.perf_counter() - t0
            timings["solve_s"] += solve_s
            new_labels[:, head] = head_labels
            costs.append(res.cost)
            iters.append(res.iters)
            # degeneracy watchdog, relative to the target marginals
            expected = n * np.exp(np.asarray(log_r, np.float64))
            supported = int((expected >= 1.0).sum())
            used = np.unique(head_labels).size
            counts = np.bincount(head_labels, minlength=cfg.num_clusters)
            overfill = counts / np.maximum(expected, 1.0)
            worst = int(np.argmax(overfill))
            if used < supported // 2 or overfill[worst] > 3.0:
                logger.warning(
                    "degenerate SK assignment on head %d: %d/%d supported "
                    "clusters used, cluster %d has %d samples (%.1fx its "
                    "marginal target %.0f) — head logits are likely "
                    "saturated; consider more data, fewer epochs between SK "
                    "steps, or a lower lamb",
                    head, used, supported, worst, int(counts[worst]),
                    float(overfill[worst]), float(expected[worst]),
                )
            logger.info("head %d: SK cost %.3f, err %.3g, %d iters, %.2fs",
                        head, res.cost, res.err, res.iters, solve_s)

    metrics = {
        "sk_cost": float(np.mean(costs)),
        "sk_iters_max": int(max(iters)),
        "sk_iters_total": int(sum(iters)),  # the solves' iterations
        "sk_time": time.time() - t_start,
        "nmi_vs_old": normalized_mutual_info(new_labels[:, 0],
                                             old_labels[:, 0]),
    }
    histograms = {}
    if true_labels is not None:
        metrics["nmi_vs_gt"] = normalized_mutual_info(new_labels[:, 0],
                                                      true_labels)
        metrics["anmi_vs_gt"] = adjusted_mutual_info(new_labels[:, 0],
                                                     true_labels)
        for head in range(1, cfg.headcount):
            metrics[f"nmi_vs_gt_head{head}"] = normalized_mutual_info(
                new_labels[:, head], true_labels)
        if (sk_counter + 1) % 10 == 0:
            ents, purs = cluster_entropy_purity(new_labels[:, 0], true_labels)
            metrics["avg_entropy"] = float(np.mean(ents))
            metrics["avg_purity"] = float(np.mean(purs))
            histograms = {"entropies": ents, "purities": purs}
    if writer is not None:
        for k, v in metrics.items():
            writer.add_scalar(f"train/{k}", v, iter_num)
        for k, v in histograms.items():
            writer.add_histogram(f"train/{k}", v, iter_num)
    logger.info("SK step @ iter %d: %s", iter_num,
                {k: round(v, 4) for k, v in metrics.items()})
    return new_labels, marginal_state, metrics
