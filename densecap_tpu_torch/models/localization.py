"""Test-time localization: RPN -> clip -> pre-NMS top-k -> NMS -> RoI align.

Twin of `densecap_tpu/models/localization.py:localize_test` with a real
batch dimension: every image carries its own true size and cropped
feature extent.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.boxes import clip_boxes, xcycwh_to_x1y1x2y2
from ..ops.nms import nms
from ..ops.roi_align import roi_align
from .vgg16 import feat_extent


class LocalizeTestOut(NamedTuple):
    roi_feats: torch.Tensor   # (B, K, 7, 7, C)
    roi_boxes: torch.Tensor   # (B, K, 4) xcycwh, NMS survivors by score
    roi_scores: torch.Tensor  # (B, K) objectness probabilities
    roi_valid: torch.Tensor   # (B, K) bool
    num_rois: torch.Tensor    # (B,) int32


def _anchor_center_valid(Hf, Wf, num_anchors, fh, fw):
    """(B, k*H'*W') mask of the k-major anchors whose cell lies on each
    image's cropped feature extent."""
    dev = fh.device
    rows = torch.arange(Hf, device=dev)[None, :, None] < fh[:, None, None]
    cols = torch.arange(Wf, device=dev)[None, None, :] < fw[:, None, None]
    cell = (rows & cols).reshape(fh.shape[0], -1)
    return cell.repeat(1, num_anchors)


def gather_rows(x, idx):
    """x: (B, N, ...) gathered along dim 1 by idx (B, K)."""
    idx = idx.long()
    if x.dim() == 2:
        return x.gather(1, idx)
    return x.gather(1, idx[..., None].expand(*idx.shape, x.shape[-1]))


def localize_test(rpn, feats, img_h, img_w, cfg, anchor_sizes, *,
                  nms_thresh=None, max_proposals=None) -> LocalizeTestOut:
    """feats: (B, C, H', W') f32 channels_last; img_h / img_w: (B,) f32."""
    nms_thresh = cfg.test_rpn_nms_thresh if nms_thresh is None else nms_thresh
    K = cfg.test_max_proposals if max_proposals is None else max_proposals
    _, _, Hf, Wf = feats.shape

    rpn_out = rpn(feats, anchor_sizes, cfg.field_centers)
    fh, fw = feat_extent(img_h, img_w)
    valid = _anchor_center_valid(Hf, Wf, anchor_sizes.shape[0], fh, fw)
    boxes, clip_valid = clip_boxes(rpn_out.boxes, img_w[:, None],
                                   img_h[:, None])
    valid = valid & clip_valid
    probs = torch.softmax(rpn_out.scores, dim=-1)[..., 0]

    pre_k = cfg.test_pre_nms_topk
    if 0 < pre_k < boxes.shape[1]:
        # ascending stable sort of the negated scores: ties keep anchor
        # order, invalid (-inf) entries go to the tail
        masked = torch.where(valid, probs, -torch.inf)
        neg_sorted, sorted_idx = torch.sort(-masked, dim=1, stable=True)
        top_scores = -neg_sorted[:, :pre_k]
        top_idx = sorted_idx[:, :pre_k]
        sub_idx, roi_valid = nms(
            xcycwh_to_x1y1x2y2(gather_rows(boxes, top_idx)), top_scores,
            nms_thresh, K, valid=top_scores > -torch.inf, presorted=True)
        idx = top_idx.gather(1, sub_idx.long())
    else:
        idx, roi_valid = nms(xcycwh_to_x1y1x2y2(boxes), probs, nms_thresh,
                             K, valid=valid)
    roi_boxes = gather_rows(boxes, idx)
    roi_scores = gather_rows(probs, idx)

    roi_feats = roi_align(
        feats.permute(0, 2, 3, 1).contiguous(), roi_boxes, img_h, img_w,
        fh, fw, cfg.output_height, cfg.output_width)
    return LocalizeTestOut(
        roi_feats=roi_feats, roi_boxes=roi_boxes, roi_scores=roi_scores,
        roi_valid=roi_valid, num_rois=roi_valid.sum(1, dtype=torch.int32))
