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

Under a process group each rank encodes its stride of the dataset and
``parallel/mesh.py::gather_rows`` assembles the whole ``[N, D]`` on every
rank. The heads are solved by their owners (``grid``: with ``--model_axis
M`` a rank owns ``H / M`` of them, at ``M = 1`` every rank all), and every
rank makes the host draws of every head in the one-process order, so that
the host RNG advances alike everywhere: the matcher's search runs on the
owner in data row 0, which hands every rank the permutation and its RNG
state; for the Gaussian marginals the owners' column sums are gathered
over the model group and every rank runs ``get_marginal`` for every head.
The owners' label columns, costs and iterations are gathered over the
model group, and rank 0's labels, marginal state, costs and host RNG
state replace every rank's at the end, so that all ranks go on alike
whatever their solves' last bits. (JAX solves once, row-sharded over its
mesh.)

The module-level ``timings`` holds the last SK step's seconds: feature
aggregation (``aggregate_s``, every group; under a process group
``gather_s``, the part of it that gathers the ranks' rows), modality
matching (``match_s``), the SK solves summed over the rank's heads
(``solve_s``) and, with ``M > 1``, the exchange of column sums and label
columns over the model group (``exchange_s``). Each is the seconds of
the span ``engine.aggregate``, ``engine.gather``, ``engine.match``,
``engine.solve`` or ``engine.exchange`` (``utils/profiling.py``); inside
an aggregation pass the span ``engine.loader_start`` holds the first wait
for a batch (the eval loader's construction, its workers' start and the
first prefetch) and ``engine.data`` each later one. On CUDA each boundary
synchronises the device, so each span holds its own work.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from selavi_tpu_torch.data.loader import batch_valid
from selavi_tpu_torch.eval.clustering import (
    adjusted_mutual_info,
    cluster_entropy_purity,
    normalized_mutual_info,
)
from selavi_tpu_torch.parallel import mesh
from selavi_tpu_torch.selflabel.marginals import MarginalState, get_marginal
from selavi_tpu_torch.selflabel.matching import match_order
from selavi_tpu_torch.selflabel.sinkhorn import sinkhorn_knopp
from selavi_tpu_torch.utils.profiling import span

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


def aggregate_features(
    encode_fn: Callable,
    batch_iter: Iterator[dict],
    n: int,
    device,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward every batch and scatter its features into ``[N, D]`` fp32
    tensors on ``device`` at the batch's ``index`` rows, each ``D`` the
    width of the features that ``encode_fn`` gives. Under a process
    group the rank's rows are kept and, after its last batch, gathered
    from every rank (``gather_rows``, the wrap-padding dropped) before the
    scatter, in ``timings["gather_s"]``."""
    ps_v = ps_a = None
    grouped = mesh.world()[2] is not None
    kept = []
    batches = iter(batch_iter)
    wait = "engine.loader_start"  # the first wait starts the loader
    while True:
        with span(wait):
            batch = next(batches, None)
        if batch is None:
            break
        wait = "engine.data"
        feat_v, feat_a = encode_fn(
            batch["video"], batch.get("audio", batch.get("audio_pcm")))
        if ps_v is None:
            ps_v, ps_a = (torch.zeros(n, f.shape[1], dtype=torch.float32,
                                      device=device) for f in (feat_v, feat_a))
        idx = torch.as_tensor(batch["index"], dtype=torch.long).to(device)
        if grouped:
            kept.append((idx, batch_valid(batch, device), feat_v.float(),
                         feat_a.float()))
            continue
        ps_v.index_copy_(0, idx, feat_v.float())
        ps_a.index_copy_(0, idx, feat_a.float())
    if ps_v is None:
        raise ValueError("no batch to aggregate features from")
    if grouped:
        _synchronize(device)
        with span("engine.gather") as gather:
            idx, valid, feat_v, feat_a = (torch.cat(c) for c in zip(*kept))
            idx = mesh.gather_rows(idx, valid)
            ps_v.index_copy_(0, idx, mesh.gather_rows(feat_v, valid))
            ps_a.index_copy_(0, idx, mesh.gather_rows(feat_a, valid))
            _synchronize(device)
        timings["gather_s"] = timings.get("gather_s", 0.0) + gather.seconds
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
    grid=None,
) -> tuple[np.ndarray, MarginalState, dict]:
    """One full re-clustering step.

    ``encode_fn(video, audio) -> (feat_v, feat_a)`` gives eval-mode pooled
    features; ``head_logits_fn(feats [N,D], modality) -> [h, N, K]`` applies
    the current heads this rank owns (modality 'v' or 'a'; all ``H``
    without a ``grid``, else ``grid.heads(H)``). ``audio_heads`` (a
    ``HeadStack``) is permuted in place when matching runs. ``writer`` (a
    TensorBoard ``SummaryWriter`` or None) gets the metrics. Returns
    ``(new_selflabels [N, H], marginal_state, metrics)``.
    """
    t_start = time.time()
    timings.clear()
    timings.update(aggregate_s=0.0, match_s=0.0, solve_s=0.0)
    sharded = grid is not None and grid.model_size > 1
    if sharded:
        timings["exchange_s"] = 0.0
    rank = mesh.world()[0]
    first, count = ((0, cfg.headcount) if grid is None
                    else grid.heads(cfg.headcount))
    owned = range(first, first + count)
    old_labels = selflabels.copy()
    new_labels = selflabels.copy()
    costs, iters = {}, {}

    order_heads = list(range(cfg.headcount))
    np_rng.shuffle(order_heads)
    if cfg.ind_groups > cfg.headcount:
        raise ValueError("ind_groups must not exceed headcount")

    cached_batches = None
    for grp in range(cfg.ind_groups):
        heads_in_group = order_heads[grp :: cfg.ind_groups]
        with span("engine.aggregate") as aggregate:
            if not cfg.cache_group_batches:
                batch_iter = make_batch_iter()
            elif cached_batches is None:
                # the first group encodes each batch as it arrives and
                # keeps it
                cached_batches = []
                batch_iter = _kept(make_batch_iter(), cached_batches)
            else:
                batch_iter = iter(cached_batches)
            ps_v, ps_a = aggregate_features(encode_fn, batch_iter, n, device)
            _synchronize(device)
        timings["aggregate_s"] += aggregate.seconds

        if cfg.match and iter_num == 0:
            if audio_heads is None:
                raise ValueError("matching needs the audio HeadStack")
            with span("engine.match") as match:
                logits_v_all = head_logits_fn(ps_v, "v")
                logits_a_all = head_logits_fn(ps_a, "a")
                for head in heads_in_group:
                    # the owner in data row 0 (rank = model index)
                    # searches, with the RNG state every rank holds; every
                    # rank goes on from its permutation and RNG state
                    src = (0 if grid is None
                           else grid.owner(head, cfg.headcount))
                    searched = None
                    if rank == src:
                        searched = (match_order(logits_v_all[head - first],
                                                logits_a_all[head - first],
                                                rng=np_rng),
                                    np_rng.bit_generator.state)
                    perm, np_rng.bit_generator.state = (
                        mesh.broadcast_object(searched, src))
                    audio_heads.permute_output(head, perm)
                    logger.info(
                        "matched head %d (perm fixed points: %d/%d)", head,
                        int((perm == np.arange(len(perm))).sum()),
                        len(perm),
                    )
                _synchronize(device)
            timings["match_s"] += match.seconds

        all_logits_v = head_logits_fn(ps_v, "v")
        all_logits_a = head_logits_fn(ps_a, "a")

        def log_ps(head):
            return (torch.log_softmax(all_logits_v[head - first].float(), 1)
                    + torch.log_softmax(all_logits_a[head - first].float(),
                                        1))

        mine = [head for head in heads_in_group if head in owned]
        colsums = {}
        if cfg.distribution != "default":
            colsums = {head: torch.logsumexp(log_ps(head), dim=0).cpu()
                       .numpy() for head in mine}
            if sharded:
                with span("engine.exchange") as exchange:
                    for part in grid.gather_objects(colsums):
                        colsums.update(part)
                timings["exchange_s"] += exchange.seconds
        # every head's marginal on every rank, in the group's order: the
        # host RNG and the marginal state advance as in one process
        log_rs = {}
        for head in heads_in_group:
            log_rs[head], marginal_state = get_marginal(
                marginal_state, colsums.get(head), head, cfg.headcount, n,
                cfg.num_clusters, distribution=cfg.distribution,
                gauss_sd=cfg.gauss_sd, diff_dist_every=cfg.diff_dist_every,
                diff_dist_per_head=cfg.diff_dist_per_head, rng=np_rng,
            )
        for head in mine:
            log_r = log_rs[head]
            m = log_ps(head)
            _synchronize(device)
            with span("engine.solve") as solve:
                res = sinkhorn_knopp(
                    m, torch.from_numpy(log_r).to(m.device),
                    lamb=cfg.lamb, tol=cfg.sk_tol,
                    max_iters=cfg.sk_max_iters, backend=cfg.sk_backend,
                    m_bf16=cfg.sk_m_bf16,
                )
                head_labels = res.labels.cpu().numpy().astype(np.int32)
            solve_s = solve.seconds
            timings["solve_s"] += solve_s
            new_labels[:, head] = head_labels
            costs[head] = res.cost
            iters[head] = res.iters
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

    if sharded:
        # every head's column, cost and iterations from its owner
        with span("engine.exchange") as exchange:
            for part in grid.gather_objects(
                    {h: (new_labels[:, h], costs[h], iters[h])
                     for h in owned}):
                for head, (column, cost, its) in part.items():
                    new_labels[:, head] = column
                    costs[head], iters[head] = cost, its
        timings["exchange_s"] += exchange.seconds
    # the one-process order of the solves
    solved = [h for grp in range(cfg.ind_groups)
              for h in order_heads[grp :: cfg.ind_groups]]
    costs = [costs[h] for h in solved]
    iters = [iters[h] for h in solved]

    # every rank goes on with rank 0's outcome
    mesh.broadcast_(torch.from_numpy(new_labels))  # in place
    marginal_state, costs, iters, rng_state = mesh.broadcast_object(
        (marginal_state, costs, iters, np_rng.bit_generator.state))
    np_rng.bit_generator.state = rng_state
    logger.info("SK split: %s",
                ", ".join(f"{k} {v:.4f}" for k, v in timings.items()))
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
