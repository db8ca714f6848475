"""Masked training losses (twin of densecap_tpu/ops/losses.py).

Each function reduces over the rows of one image and broadcasts over any
leading batch dimensions: (N, ...) inputs give a scalar, (B, N, ...)
inputs give (B,). Padded sampler slots contribute nothing, including to
the denominators, which keep the reference's normalizations and the floor
of 1 (`_safe_div`).
"""

from __future__ import annotations

import torch

from .transforms import invert_box_transform


def _safe_div(num, den):
    return num / torch.clamp_min(den, 1.0)


def _rows(valid):
    return valid.to(torch.float32).sum(-1)


def cross_entropy(scores, labels, valid):
    """Mean softmax cross entropy over valid rows.
    scores (..., N, C); labels (..., N) int in [0, C); valid (..., N) bool."""
    logp = torch.log_softmax(scores, dim=-1)
    nll = -logp.gather(-1, labels.long()[..., None])[..., 0]
    return _safe_div((nll * valid).sum(-1), _rows(valid))


def smooth_l1(pred, target, valid):
    """Mean smooth-L1 over the elements of valid rows: 0.5 z^2 if |z| < 1
    else |z| - 0.5. pred, target (..., N, D); valid (..., N)."""
    z = (pred - target).abs()
    elem = torch.where(z < 1.0, 0.5 * z * z, z - 0.5) * valid[..., None]
    return _safe_div(elem.sum((-2, -1)), _rows(valid) * pred.shape[-1])


def logistic(scores, labels, valid):
    """One-vs-all logistic loss over the elements of valid rows.
    scores (..., N, C); labels (..., N) int in [0, C], 0 = negative for
    every class, c > 0 = positive for class c (1-indexed)."""
    C = scores.shape[-1]
    classes = torch.arange(1, C + 1, device=scores.device)
    y = (labels[..., None] == classes).to(scores.dtype)
    elem = torch.logaddexp(torch.zeros_like(scores), -scores) + (1.0 - y) * scores
    elem = elem * valid[..., None]
    return _safe_div(elem.sum((-2, -1)), _rows(valid) * C)


def masked_transform_pair(transforms, target_trans, max_trans=10.0):
    """Zero rows whose target transform has an entry past max_trans, on
    both sides (the mask carries no gradient)."""
    ok = (target_trans.abs().amax(-1, keepdim=True) <= max_trans).detach()
    return (torch.where(ok, transforms, 0.0),
            torch.where(ok, target_trans, 0.0))


def box_regression(anchor_boxes, transforms, target_boxes, valid, weight=1.0,
                   max_trans=10.0):
    """Final box regression: smooth-L1 between predicted transforms and
    the inverted ones, outlier rows zeroed but still counted."""
    target_trans = invert_box_transform(anchor_boxes, target_boxes)
    pred, tgt = masked_transform_pair(transforms, target_trans, max_trans)
    return weight * smooth_l1(pred, tgt, valid)


def temporal_cross_entropy(scores, target, seq_valid):
    """Sum of cross entropy over the non-null tokens of valid rows, over
    the number of valid rows. scores (..., N, T, V); target (..., N, T)
    int in [0, V], 0 = null; seq_valid (..., N) bool."""
    logp = torch.log_softmax(scores, dim=-1)
    tgt0 = torch.clamp_min(target.long() - 1, 0)
    nll = -logp.gather(-1, tgt0[..., None])[..., 0]
    mask = (target > 0) & seq_valid[..., None]
    return _safe_div((nll * mask).sum((-2, -1)), _rows(seq_valid))
