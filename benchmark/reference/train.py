"""The reference's training steps and self-labeling step, in float32 (the
SK solve in float64), with TF32 off.

Training (SeLaVi's objective): ``loss = 0.5 * CE_v + 0.5 * CE_a``, each the
mean over heads and rows of the cross-entropy against the self-labels;
SGD with momentum 0.9 and the weight decay coupled into the gradient
(``d = g + wd * p; buf = 0.9 * buf + d; p -= lr * buf``, the first
``buf = d``). Train-mode BatchNorm takes its statistics over the whole
batch: the batch goes through each block at once, and with
``Precision.checkpoint`` each block's activations are recomputed in the
backward pass instead of kept, so that a batch of 128 clips fits.

Self-labeling (Asano et al., ICLR 2020 / NeurIPS 2020): eval-mode features
of every sample, per head ``log P = log_softmax(v) + log_softmax(a)``, the
Gaussian cluster sizes re-sorted by the rank of each cluster's mass, and
Sinkhorn-Knopp on ``M = (lambda / 2) log P`` in the log domain, checked
every 10 iterations against ``sum |beta_old / beta_new - 1| <= 0.1``.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from benchmark.reference.inputs import augment, draw_augmentations, logfbank
from benchmark.reference.model import multihead_ce


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matrix products and convolutions."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def train_steps(net, batches, generator, lr, wd, audio, momentum=0.9,
                keep_rows=None):
    """SGD steps on ``batches`` (each ``(video_u8, pcm, labels)`` on the
    card); the dropout masks and flips come from ``generator``. Returns the
    loss of every step, the momentum buffer after the first step (the
    gradient the optimizer got) and the parameters after the last step.
    ``keep_rows`` trains on the first rows of each batch only (a fault)."""
    net.train()
    names, params = zip(*net.named_parameters())
    bufs = [None] * len(params)
    losses, first = [], None
    with exact_float32():
        for video, pcm, labels in batches:
            x = augment(video, draw_augmentations(video.shape[0], generator))
            spec = logfbank(pcm, audio["samplerate"], audio["nfilt"])
            if keep_rows is not None:
                x, spec, labels = (t[:keep_rows] for t in (x, spec, labels))
            logits_v, logits_a = net(x, spec, generator)
            loss = (0.5 * multihead_ce(logits_v, labels)
                    + 0.5 * multihead_ce(logits_a, labels))
            grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                for i, (p, g) in enumerate(zip(params, grads)):
                    d = g + wd * p
                    bufs[i] = d if bufs[i] is None else bufs[i].mul_(
                        momentum).add_(d)
                    p.sub_(lr * bufs[i])
            losses.append(float(loss.detach()))
            if first is None:
                first = {n: b.clone() for n, b in zip(names, bufs)}
            del grads, loss, logits_v, logits_a
    return losses, first, {n: p.detach().clone() for n, p in zip(names,
                                                                  params)}


@torch.no_grad()
def features(net, batches, generator, audio):
    """Eval-mode pooled features ``(feat_v, feat_a)`` of ``batches`` (each
    ``(video_u8, pcm)``), in order, flips drawn from ``generator``."""
    net.eval()
    out_v, out_a = [], []
    with exact_float32():
        for video, pcm in batches:
            x = augment(video, draw_augmentations(video.shape[0], generator))
            spec = logfbank(pcm, audio["samplerate"], audio["nfilt"])
            feat_v, feat_a = net.features(x, spec)
            out_v.append(feat_v)
            out_a.append(feat_a)
    return torch.cat(out_v), torch.cat(out_a)


@torch.no_grad()
def log_probs(net, feat_v, feat_a):
    """``[H, N, K]`` per-head ``log_softmax(v) + log_softmax(a)``, eval
    mode, float64."""
    net.eval()
    with exact_float32():
        lv = net.heads_v(feat_v)
        la = net.heads_a(feat_a)
    return (torch.log_softmax(lv.double(), -1)
            + torch.log_softmax(la.double(), -1))


def sorted_marginal(dist, log_p):
    """``log r`` of the cluster sizes ``dist`` [K] re-sorted so that their
    ranks follow the clusters' masses ``logsumexp_n log_p``; ``r`` is the
    normalised reciprocal of the sizes (the reference's ``sk_utils``)."""
    mass = torch.logsumexp(log_p, dim=0).cpu().numpy()
    sizes = np.empty_like(dist)
    sizes[np.argsort(mass)] = np.sort(dist)
    r = 1.0 / sizes
    return np.log(r / r.sum())


def sinkhorn(log_p, log_r, lamb=20.0, tol=0.1, max_iters=2000, every=10):
    """Labels ``[N]``, the final score ``M + log_alpha`` [N, K] and the
    cost ``-(1 / lamb) * mean_n M[n, label_n]``, in float64."""
    m = (0.5 * lamb) * log_p.double()
    n = m.shape[0]
    log_r = torch.as_tensor(log_r, dtype=torch.float64, device=m.device)
    log_beta = torch.full((n,), -np.log(n), dtype=torch.float64,
                          device=m.device)
    err, it = np.inf, 0
    while err > tol and it < max_iters:
        log_alpha = log_r - torch.logsumexp(m + log_beta[:, None], dim=0)
        new = -np.log(n) - torch.logsumexp(m + log_alpha[None, :], dim=1)
        if it % every == 0:
            err = float(torch.expm1(log_beta - new).abs().sum())
        log_beta = new
        it += 1
    score = m + log_alpha[None, :]
    labels = score.argmax(dim=1)
    cost = -float(m.gather(1, labels[:, None]).sum()) / (lamb * n)
    return labels, score, cost


def label_gap(score, labels):
    """The widest gap by which a given label's score lies below the best
    score of its row: ``max_n (max_k score[n, k] - score[n, label_n])``."""
    labels = torch.as_tensor(labels, device=score.device).long()
    best = score.max(dim=1).values
    return float((best - score.gather(1, labels[:, None])[:, 0]).max())
