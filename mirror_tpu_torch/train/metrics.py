"""Downstream evaluation metrics (host side, numpy).

The port's own copy of ``mirror_tpu/train/metrics.py``:

- ``accuracy``: top-1, in percent (timm's accuracy);
- ``multiclass_auroc``: one-vs-rest AUROC over softmax probabilities, macro
  or weighted (torcheval's MulticlassAUROC);
- ``multiclass_f1``: macro, weighted or micro (torcheval's
  MulticlassF1Score);
- ``concordance_index_censored``: sksurv's censored c-index with
  ``tied_tol``, over the whole validation set.
"""

from typing import Tuple

import numpy as np


def accuracy(logits: np.ndarray, labels: np.ndarray) -> float:
    return float((logits.argmax(axis=1) == labels).mean() * 100.0)


def _binary_auroc(scores: np.ndarray, positives: np.ndarray) -> float:
    """The Mann-Whitney U statistic over average ranks (ties share one)."""
    n_pos, n_neg = int(positives.sum()), int((~positives).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    values = np.concatenate([scores[positives], scores[~positives]])
    _, inverse, counts = np.unique(values, return_inverse=True, return_counts=True)
    # the average 1-based rank of each distinct value
    avg_rank = np.cumsum(counts) - (counts - 1) / 2.0
    r_pos = avg_rank[inverse[:n_pos]].sum()
    return float((r_pos - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def multiclass_auroc(logits: np.ndarray, labels: np.ndarray, average: str = "macro") -> float:
    probs = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs /= probs.sum(axis=1, keepdims=True)
    aucs, weights = [], []
    for c in range(logits.shape[1]):
        pos = labels == c
        auc = _binary_auroc(probs[:, c], pos)
        if not np.isnan(auc):
            aucs.append(auc)
            weights.append(pos.sum())
    if not aucs:
        return float("nan")
    if average == "weighted":
        return float(np.average(aucs, weights=np.asarray(weights, np.float64)))
    return float(np.mean(aucs))


def multiclass_f1(logits: np.ndarray, labels: np.ndarray, average: str = "macro") -> float:
    preds = logits.argmax(axis=1)
    if average == "micro":
        return float((preds == labels).mean())
    f1s, weights = [], []
    for c in range(logits.shape[1]):
        tp = np.sum((preds == c) & (labels == c))
        fp = np.sum((preds == c) & (labels != c))
        fn = np.sum((preds != c) & (labels == c))
        denom = 2 * tp + fp + fn
        f1s.append(2 * tp / denom if denom > 0 else 0.0)
        weights.append(np.sum(labels == c))
    if average == "weighted":
        w = np.asarray(weights, np.float64)
        return float(np.average(f1s, weights=w)) if w.sum() else 0.0
    return float(np.mean(f1s))


def concordance_index_censored(event_indicator: np.ndarray, event_time: np.ndarray,
                               estimate: np.ndarray, tied_tol: float = 1e-8
                               ) -> Tuple[float, int, int, int, int]:
    """Pairs (i, j) are comparable when i had its event and t_i < t_j, or
    t_i == t_j with j censored; concordant when the higher risk failed
    first; risks within ``tied_tol`` count one half. Returns (c-index,
    concordant, discordant, tied_risk, tied_time)."""
    event = np.asarray(event_indicator, dtype=bool)
    time = np.asarray(event_time, dtype=np.float64)
    estimate = np.asarray(estimate, dtype=np.float64)
    if not event.any():
        raise ValueError("All samples are censored")
    t_i, t_j = time[:, None], time[None, :]
    ev_i, ev_j = event[:, None], event[None, :]
    comparable = ev_i & ((t_j > t_i) | ((t_j == t_i) & ~ev_j))
    diff = estimate[:, None] - estimate[None, :]
    ties = np.abs(diff) <= tied_tol
    concordant = int(np.sum(comparable & ~ties & (diff > 0)))
    discordant = int(np.sum(comparable & ~ties & (diff < 0)))
    tied_risk = int(np.sum(comparable & ties))
    tied_time = int(np.sum(ev_i & (t_j == t_i) & ~ev_j))
    total = concordant + discordant + tied_risk
    if total == 0:
        raise ValueError("No comparable pairs")
    return ((concordant + 0.5 * tied_risk) / total, concordant, discordant, tied_risk,
            tied_time)
