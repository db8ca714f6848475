"""Fixed-slot positive / negative RoI sampling, batched over images.

Twin of `densecap_tpu/ops/sampler.py` (`compute_match_masks`,
`sample_rois`, `_nth_true_index`, `_gumbel_topk_select`) with a real
batch dimension: every image has its own masks, counts and draws.

P = batch_size / 2 positive and M = batch_size negative slots always
exist; `pos_valid[b, k] = k < num_pos[b]`, `neg_valid[b, k] = k <
num_neg[b]`, with num_pos = min(P, eligible positives) and num_neg =
batch_size - num_pos. Positives are drawn uniformly without replacement
(a Gumbel top-k); negatives too, unless there are fewer eligible
negatives than num_neg, in which case every negative slot is redrawn iid
with replacement. Draws come from an explicit `torch.Generator` on the
tensors' device; the JAX package's random stream is another, so parity
with it runs through the debug ordinals, which replace the draws.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .boxes import iou_cwh, xcycwh_to_x1y1x2y2


class SamplerOutput(NamedTuple):
    pos_input_idx: torch.Tensor   # (B, P) int64 into the input boxes
    pos_target_idx: torch.Tensor  # (B, P) int64 into the gt boxes
    pos_valid: torch.Tensor       # (B, P) bool
    neg_input_idx: torch.Tensor   # (B, M) int64
    neg_valid: torch.Tensor       # (B, M) bool
    num_pos: torch.Tensor         # (B,) int64
    num_neg: torch.Tensor         # (B,) int64
    no_negatives: torch.Tensor    # (B,) bool: the fallback ran
    neg_replaced: torch.Tensor    # (B,) bool: negatives were redrawn


def compute_match_masks(input_boxes, gt_boxes, gt_valid, *, low_thresh=0.3,
                        high_thresh=0.7, bounds=None, candidate_mask=None):
    """Eligibility masks and the best gt per input box.

    input_boxes (B, A, 4) and gt_boxes (B, G, 4) xcycwh; gt_valid (B, G)
    bool; bounds: None or dict(x_min, y_min, x_max, y_max), each a float or
    a (B,) tensor; candidate_mask (B, A) bool hard-excludes rows from both
    sets. Returns (pos_mask, neg_mask, input_idx, no_negatives). The
    best-matching input of every valid gt is forced positive, over the
    thresholds, the bounds and the candidate mask. With no negatives at
    all, every non-positive live candidate becomes negative.
    """
    A = input_boxes.shape[1]
    ious = iou_cwh(input_boxes, gt_boxes)                 # (B, A, G)
    ious = torch.where(gt_valid[:, None, :], ious, -1.0)
    input_max_iou = ious.amax(2)
    input_idx = ious.argmax(2)                            # first maximum
    target_best_input = ious.argmax(1)                    # (B, G)

    pos_mask = input_max_iou > high_thresh
    neg_mask = input_max_iou < low_thresh
    if bounds is not None:
        bb = xcycwh_to_x1y1x2y2(input_boxes)

        def per_image(v):
            v = torch.as_tensor(v, dtype=bb.dtype, device=bb.device)
            return v[:, None] if v.dim() == 1 else v

        oob = ((bb[..., 0] < per_image(bounds["x_min"]))
               | (bb[..., 1] < per_image(bounds["y_min"]))
               | (bb[..., 2] > per_image(bounds["x_max"]))
               | (bb[..., 3] > per_image(bounds["y_max"])))
        pos_mask = pos_mask & ~oob
        neg_mask = neg_mask & ~oob
    if candidate_mask is not None:
        pos_mask = pos_mask & candidate_mask
        neg_mask = neg_mask & candidate_mask

    # invalid gt rows scatter into a spare column that is cut off
    B = input_boxes.shape[0]
    forced = torch.zeros((B, A + 1), dtype=torch.bool,
                         device=input_boxes.device)
    forced.scatter_(1, torch.where(gt_valid, target_best_input, A), True)
    forced = forced[:, :A]
    pos_mask = pos_mask | forced
    neg_mask = neg_mask & ~forced

    any_neg = neg_mask.any(1, keepdim=True)
    fallback = ~pos_mask
    if candidate_mask is not None:
        live = fallback & candidate_mask
        fallback = torch.where(live.any(1, keepdim=True), live, fallback)
    neg_mask = torch.where(any_neg, neg_mask, fallback)
    return pos_mask, neg_mask, input_idx, ~any_neg[:, 0]


def _nth_true_index(mask, ordinals):
    """Index of the n-th True entry of each row of mask (ascending index
    order), for ordinals (K,) or (B, K). Ordinals past a row's count alias
    into its False tail and must be masked by validity downstream."""
    order = torch.sort((~mask).to(torch.int32), dim=1, stable=True).indices
    ordinals = torch.as_tensor(ordinals, dtype=torch.long, device=mask.device)
    return order.gather(1, ordinals.expand(mask.shape[0], -1))


def _gumbel_topk_select(gen, mask, k):
    """Draw up to k entries of each row of mask uniformly without
    replacement. Returns (idx (B, k), total (B,)); slots past a row's
    count cycle through its drawn prefix."""
    B, n = mask.shape
    u = torch.rand((B, n), generator=gen, device=mask.device)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    scores = torch.where(mask, -torch.log(-torch.log(u)), -torch.inf)
    k_eff = min(k, n)
    idx = torch.topk(scores, k_eff, dim=1).indices
    if k_eff < k:
        idx = torch.cat([idx, idx.new_zeros((B, k - k_eff))], 1)
    total = mask.sum(1)
    slot = torch.arange(k, device=mask.device)[None]
    safe = torch.clamp_min(total, 1)[:, None]
    wrapped = torch.where(slot < safe, slot, slot % safe)
    return idx.gather(1, wrapped), total


def sample_rois(gen, input_boxes, gt_boxes, gt_valid, *, batch_size=256,
                low_thresh=0.3, high_thresh=0.7, bounds=None,
                candidate_mask=None, debug_pos_sample_idx=None,
                debug_neg_sample_idx=None) -> SamplerOutput:
    """Sample positive / negative proposals against the ground truth.

    debug_pos_sample_idx (P,) / debug_neg_sample_idx (M,) replace the
    random draws with ordinals into each image's eligible lists (the
    reference's deterministic hooks); masks, forced positives and the
    fallback still run. `gen` may be None when both are given.
    """
    P, M = batch_size // 2, batch_size
    pos_mask, neg_mask, input_idx, no_negs = compute_match_masks(
        input_boxes, gt_boxes, gt_valid, low_thresh=low_thresh,
        high_thresh=high_thresh, bounds=bounds,
        candidate_mask=candidate_mask)

    if debug_pos_sample_idx is not None:
        pos_idx = _nth_true_index(pos_mask, debug_pos_sample_idx)
        total_pos = pos_mask.sum(1)
    else:
        pos_idx, total_pos = _gumbel_topk_select(gen, pos_mask, P)
    if debug_neg_sample_idx is not None:
        neg_idx = _nth_true_index(neg_mask, debug_neg_sample_idx)
        total_neg = neg_mask.sum(1)
    else:
        neg_idx, total_neg = _gumbel_topk_select(gen, neg_mask, M)

    num_pos = torch.clamp_max(total_pos, P)
    num_neg = batch_size - num_pos
    neg_replaced = total_neg < num_neg
    if debug_neg_sample_idx is None:
        # too few negatives: redraw every slot iid over the drawn prefix,
        # which is then a random permutation of all eligible negatives
        # (rows with enough negatives keep their draw; their iid only has
        # to stay in range)
        n = torch.clamp(total_neg, 1, M)[:, None]
        u = torch.rand(neg_idx.shape, generator=gen, device=neg_idx.device)
        iid = torch.minimum((u * n).long(), n - 1)
        neg_idx = torch.where(neg_replaced[:, None], neg_idx.gather(1, iid),
                              neg_idx)

    dev = input_boxes.device
    return SamplerOutput(
        pos_input_idx=pos_idx,
        pos_target_idx=input_idx.gather(1, pos_idx),
        pos_valid=torch.arange(P, device=dev)[None] < num_pos[:, None],
        neg_input_idx=neg_idx,
        neg_valid=torch.arange(M, device=dev)[None] < num_neg[:, None],
        num_pos=num_pos,
        num_neg=num_neg,
        no_negatives=no_negs,
        neg_replaced=neg_replaced,
    )
