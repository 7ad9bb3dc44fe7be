"""Clustering-quality metrics: NMI, adjusted MI, adjusted Rand, per-cluster
entropy and purity, and accuracy after Hungarian matching
(``selavi_tpu/eval/clustering.py``).

numpy and scipy only: the card machine has no sklearn, so NMI, adjusted MI
(arithmetic averaging) and adjusted Rand are written here with sklearn's
formulas and special cases (both labelings one cluster: 1; one side one
cluster: 0; a perfect match of all singletons: adjusted MI 1). The
expected-MI term of adjusted MI is a sum over every contingency cell and
every feasible cell count; it is vectorised over a chunk of contingency
rows at a time, so its memory stays bounded at N=170752, K=309.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment
from scipy.special import gammaln, log_softmax
from scipy.stats import entropy as scipy_entropy

EPS = np.finfo(np.float64).eps
# Terms of the expected-MI sum evaluated at once (a few float64 arrays of
# this length live at a time).
EMI_CHUNK_TERMS = 1 << 21


def contingency(labels_true: np.ndarray, labels_pred: np.ndarray):
    """The [classes, clusters] int64 count table of two labelings."""
    _, ti = np.unique(labels_true, return_inverse=True)
    _, pi = np.unique(labels_pred, return_inverse=True)
    r, c = int(ti.max(initial=-1)) + 1, int(pi.max(initial=-1)) + 1
    return np.bincount(ti.ravel() * c + pi.ravel(),
                       minlength=r * c).reshape(r, c).astype(np.int64)


def _entropy(counts: np.ndarray) -> float:
    """Entropy of a labeling given its class counts (sklearn's
    ``_entropy``)."""
    counts = counts[counts > 0].astype(np.float64)
    if counts.size <= 1:
        return 0.0
    total = counts.sum()
    return float(-np.sum((counts / total) * (np.log(counts) - np.log(total))))


def _mutual_info(table: np.ndarray) -> float:
    """MI of a contingency table (sklearn's ``mutual_info_score``)."""
    a, b = table.sum(1), table.sum(0)
    if a.size == 1 or b.size == 1:
        return 0.0
    rows, cols = np.nonzero(table)
    nz = table[rows, cols].astype(np.float64)
    total = float(table.sum())
    p = nz / total
    outer = a[rows].astype(np.int64) * b[cols].astype(np.int64)
    log_outer = -np.log(outer) + np.log(a.sum()) + np.log(b.sum())
    mi = p * (np.log(nz) - np.log(total)) + p * log_outer
    mi = np.where(np.abs(mi) < EPS, 0.0, mi)
    return float(np.clip(mi.sum(), 0.0, None))


def expected_mutual_info(table: np.ndarray) -> float:
    """E[MI] of two random labelings with the table's marginals (the
    hypergeometric model of Vinh et al. 2010, sklearn's
    ``expected_mutual_information``). For row i (size a), column j (size b)
    and each feasible count n from max(1, a + b - N) to min(a, b):
    n/N * log(N n / (a b)) * P(n), with P the hypergeometric probability,
    in log space. Chunked by rows: each chunk forms only its feasible
    (i, j, n) terms."""
    a, b = table.sum(1).astype(np.int64), table.sum(0).astype(np.int64)
    if a.size == 1 or b.size == 1:
        return 0.0
    n = int(table.sum())
    log_n = np.log(n)
    log_a, log_b = np.log(a), np.log(b)
    gln_a, gln_b = gammaln(a + 1), gammaln(b + 1)
    gln_na, gln_nb = gammaln(n - a + 1), gammaln(n - b + 1)
    gln_n = gammaln(n + 1)
    start = np.maximum(1, a[:, None] + b[None, :] - n)  # [R, C]
    end = np.minimum(a[:, None], b[None, :]) + 1
    length = np.maximum(end - start, 0)
    per_row = length.sum(1)
    emi = 0.0
    r0 = 0
    while r0 < a.size:
        r1, terms = r0, 0
        while r1 < a.size and (r1 == r0 or
                               terms + per_row[r1] <= EMI_CHUNK_TERMS):
            terms += int(per_row[r1])
            r1 += 1
        lens = length[r0:r1].ravel()
        cell = np.repeat(np.arange(lens.size), lens)  # cell of each term
        first = np.cumsum(lens) - lens
        i = r0 + cell // b.size
        j = cell % b.size
        nij = (start[r0:r1].ravel()[cell]
               + np.arange(cell.size) - first[cell])
        nij_f = nij.astype(np.float64)
        term2 = log_n + np.log(nij_f) - log_a[i] - log_b[j]
        gln = (gln_a[i] + gln_b[j] + gln_na[i] + gln_nb[j]
               - gammaln(nij_f + 1) - gln_n
               - gammaln(a[i] - nij + 1) - gammaln(b[j] - nij + 1)
               - gammaln(n - a[i] - b[j] + nij + 1))
        emi += float(np.sum(nij_f / n * term2 * np.exp(gln)))
        r0 = r1
    return emi


def _one_cluster_each(table: np.ndarray) -> bool:
    return table.shape[0] == table.shape[1] and table.shape[0] <= 1


def normalized_mutual_info(labels_true: np.ndarray,
                           labels_pred: np.ndarray) -> float:
    """NMI with the arithmetic-mean normalizer (sklearn's
    ``normalized_mutual_info_score`` default)."""
    table = contingency(labels_true, labels_pred)
    if _one_cluster_each(table):
        return 1.0
    mi = _mutual_info(table)
    if mi == 0:
        return 0.0
    h = 0.5 * (_entropy(table.sum(1)) + _entropy(table.sum(0)))
    return float(mi / h)


def adjusted_mutual_info(labels_true: np.ndarray,
                         labels_pred: np.ndarray) -> float:
    """Adjusted MI with the arithmetic-mean normalizer (sklearn's
    ``adjusted_mutual_info_score`` default)."""
    table = contingency(labels_true, labels_pred)
    if _one_cluster_each(table):
        return 1.0
    if 1 in table.shape:
        return 0.0
    mi = _mutual_info(table)
    emi = expected_mutual_info(table)
    h = 0.5 * (_entropy(table.sum(1)) + _entropy(table.sum(0)))
    # mi and h may sit at emi to rounding (a perfect match of all
    # singletons): keep each difference's sign and at least one eps
    den, num = h - emi, mi - emi
    den = min(den, -EPS) if den < 0 else max(den, EPS)
    num = min(num, -EPS) if num < 0 else max(num, EPS)
    return float(num / den)


def adjusted_rand(labels_true: np.ndarray, labels_pred: np.ndarray) -> float:
    """Adjusted Rand index (sklearn's ``adjusted_rand_score``), from the
    pair confusion counts in exact integers."""
    table = contingency(labels_true, labels_pred)
    # int64 holds the pair counts (< N^2); their products go to Python ints
    n = int(table.sum())
    squares = int((table ** 2).sum())
    tp = squares - n
    fp = int((table @ table.sum(0)).sum()) - squares
    fn = int((table.T @ table.sum(1)).sum()) - squares
    tn = n * n - fp - fn - squares
    if fn == 0 and fp == 0:
        return 1.0
    return 2.0 * (tp * tn - fn * fp) / ((tp + fn) * (fn + tn)
                                        + (tp + fp) * (fp + tn))


def hungarian_match(preds: np.ndarray, targets: np.ndarray,
                    num_k: int) -> list[tuple[int, int]]:
    """The one-to-one cluster -> class matching that maximises the matched
    votes (reference ``_hungarian_match``)."""
    if preds.shape != targets.shape:
        raise ValueError(f"preds {preds.shape} vs targets {targets.shape}")
    votes = np.bincount(
        preds.astype(np.int64) * num_k + targets.astype(np.int64),
        minlength=num_k * num_k,
    ).reshape(num_k, num_k)
    rows, cols = linear_sum_assignment(len(preds) - votes)
    return list(zip(rows.tolist(), cols.tolist()))


def cluster_accuracy(preds: np.ndarray, targets: np.ndarray,
                     num_k: int) -> float:
    """Accuracy after the optimal relabeling of ``hungarian_match``."""
    reordered = np.zeros(len(targets), np.int64)
    for pred_i, target_i in hungarian_match(preds, targets, num_k):
        reordered[preds == pred_i] = target_i
    return float((reordered == targets).mean())


def cluster_entropy_purity(preds: np.ndarray, targets: np.ndarray):
    """Per-cluster arrays, in the order of ``np.unique(preds)``: the
    entropy of the ground-truth classes in each cluster, and the share of
    its largest class."""
    table = contingency(preds, targets).astype(np.float64)
    frac = table / table.sum(1, keepdims=True)
    entropies = np.asarray([scipy_entropy(row[row > 0]) for row in frac])
    return entropies, frac.max(1)


def entropy_purity(preds: np.ndarray, targets: np.ndarray):
    """Mean per-cluster entropy and purity."""
    ents, purs = cluster_entropy_purity(preds, targets)
    return float(np.mean(ents)), float(np.mean(purs))


def clustering_report(preds: np.ndarray, targets: np.ndarray,
                      num_clusters: int) -> dict:
    """The reference ``k_means`` report: NMI, adjusted MI, adjusted Rand,
    mean entropy and purity, and Hungarian accuracy, with the ground-truth
    classes re-indexed to 0..C-1 before matching."""
    ent, pur = entropy_purity(preds, targets)
    remapped = np.unique(targets, return_inverse=True)[1].ravel()
    return {
        "nmi": normalized_mutual_info(preds, targets),
        "anmi": adjusted_mutual_info(preds, targets),
        "ari": adjusted_rand(preds, targets),
        "entropy": ent,
        "purity": pur,
        "accuracy": cluster_accuracy(preds, remapped, num_clusters),
    }


def head_labels(logits_v: np.ndarray, logits_a: np.ndarray) -> np.ndarray:
    """Argmax of ``softmax_v * softmax_a`` for one head, in float64."""
    log_ps = (log_softmax(logits_v.astype(np.float64), axis=1)
              + log_softmax(logits_a.astype(np.float64), axis=1))
    return log_ps.argmax(1)


def best_head_labels(logits_v_heads: np.ndarray, logits_a_heads: np.ndarray,
                     targets: np.ndarray) -> tuple[np.ndarray, int]:
    """The labels of the head whose ``head_labels`` have the highest NMI
    with ``targets``, and that head. Inputs [H, N, K]."""
    best_nmi, best_labels, best_h = -1.0, None, 0
    for h in range(logits_v_heads.shape[0]):
        labels = head_labels(logits_v_heads[h], logits_a_heads[h])
        nmi = normalized_mutual_info(labels, targets)
        if nmi > best_nmi:
            best_nmi, best_labels, best_h = nmi, labels, h
    return best_labels, best_h
