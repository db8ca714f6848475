"""Localization: RPN -> (clip / NMS | sampling) -> RoI align.

Twin of `densecap_tpu/models/localization.py` (`localize_test`,
`localize_train`) with a real batch dimension: every image carries its
own true size, cropped feature extent, ground truth and sample.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import losses as L
from ..ops.boxes import clip_boxes, xcycwh_to_x1y1x2y2
from ..ops.nms import nms
from ..ops.roi_align import roi_align
from ..ops.sampler import sample_rois
from ..ops.transforms import invert_box_transform
from ..utils.profiling import span


class LocalizeTrainOut(NamedTuple):
    roi_feats: torch.Tensor          # (B, P+M, 7, 7, C), positives first
    roi_boxes: torch.Tensor          # (B, P+M, 4) xcycwh
    pos_boxes: torch.Tensor          # (B, P, 4)
    pos_anchors: torch.Tensor        # (B, P, 4)
    pos_trans: torch.Tensor          # (B, P, 4)
    pos_valid: torch.Tensor          # (B, P) bool
    neg_valid: torch.Tensor          # (B, M) bool
    pos_target_boxes: torch.Tensor   # (B, P, 4) gt boxes of the positives
    pos_target_labels: torch.Tensor  # (B, P, L) their captions
    num_pos: torch.Tensor            # (B,)
    losses: dict                     # per-image (B,) mid losses and stats


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


def localize_train(rpn, feats, img_h, img_w, gt_boxes, gt_labels, gt_valid,
                   generator, cfg, anchor_sizes, *, extent,
                   debug_sampler=None) -> LocalizeTrainOut:
    """feats: (B, C, H', W') f32 channels_last; img_h / img_w: (B,) f32;
    extent: (fh, fw), each image's extent on the map by the trunk's rule
    (`DenseCap.feat_extent`); gt_boxes (B, G, 4) xcycwh, gt_labels (B, G,
    L), gt_valid (B, G). debug_sampler: optional dict(pos=(P,), neg=(M,))
    sampler ordinals."""
    B, _, Hf, Wf = feats.shape
    fh, fw = extent
    center_ok = _anchor_center_valid(Hf, Wf, anchor_sizes.shape[0], fh, fw)
    with span("rpn"):
        rpn_out = rpn(feats, anchor_sizes, cfg.field_centers,
                      box_reg_decay=cfg.box_reg_decay, decay_mask=center_ok)

    bounds = None
    if cfg.train_remove_outbounds_boxes:
        bounds = dict(x_min=1.0, y_min=1.0, x_max=img_w, y_max=img_h)
    # anchors whose centres fall off the true image are pushed far out of
    # bounds, so the bounds mask and the IoU both reject them
    dead = torch.tensor([-1e6, -1e6, 1.0, 1.0], device=feats.device)
    boxes_eff = torch.where(center_ok[..., None], rpn_out.boxes.detach(), dead)
    dbg = debug_sampler or {}
    with span("sampler"):
        s = sample_rois(
            generator, boxes_eff, gt_boxes, gt_valid,
            batch_size=cfg.sampler_batch_size,
            low_thresh=cfg.sampler_low_thresh,
            high_thresh=cfg.sampler_high_thresh, bounds=bounds,
            candidate_mask=center_ok, debug_pos_sample_idx=dbg.get("pos"),
            debug_neg_sample_idx=dbg.get("neg"))

    pos_boxes = gather_rows(rpn_out.boxes, s.pos_input_idx)
    pos_anchors = rpn_out.anchors[s.pos_input_idx]
    pos_trans = gather_rows(rpn_out.trans, s.pos_input_idx)
    pos_scores = gather_rows(rpn_out.scores, s.pos_input_idx)
    neg_boxes = gather_rows(rpn_out.boxes, s.neg_input_idx)
    neg_scores = gather_rows(rpn_out.scores, s.neg_input_idx)
    pos_target_boxes = gather_rows(gt_boxes, s.pos_target_idx)
    pos_target_labels = gather_rows(gt_labels, s.pos_target_idx)

    roi_boxes = torch.cat([pos_boxes, neg_boxes], 1)
    with span("roi_align"):
        roi_feats = roi_align(
            feats.permute(0, 2, 3, 1).contiguous(), roi_boxes, img_h, img_w,
            fh, fw, cfg.output_height, cfg.output_width)

    # objectness: positives are class 0, negatives class 1
    obj_pos = L.cross_entropy(pos_scores, torch.zeros_like(s.pos_input_idx),
                              s.pos_valid)
    obj_neg = L.cross_entropy(neg_scores, torch.ones_like(s.neg_input_idx),
                              s.neg_valid)
    tt = invert_box_transform(pos_anchors, pos_target_boxes)
    pt_m, tt_m = L.masked_transform_pair(pos_trans, tt)
    losses = {
        "mid_objectness_loss": cfg.mid_objectness_weight * (obj_pos + obj_neg),
        "mid_box_reg_loss": cfg.mid_box_reg_weight * L.smooth_l1(
            pt_m, tt_m, s.pos_valid),
        "box_decay_loss": rpn_out.box_decay_loss,
        "stats/num_pos": s.num_pos.float(),
        "stats/sampler_no_negatives": s.no_negatives.float(),
        "stats/sampler_neg_replaced": s.neg_replaced.float(),
    }
    return LocalizeTrainOut(
        roi_feats=roi_feats, roi_boxes=roi_boxes, pos_boxes=pos_boxes,
        pos_anchors=pos_anchors, pos_trans=pos_trans, pos_valid=s.pos_valid,
        neg_valid=s.neg_valid, pos_target_boxes=pos_target_boxes,
        pos_target_labels=pos_target_labels, num_pos=s.num_pos,
        losses=losses)


def localize_test(rpn, feats, img_h, img_w, cfg, anchor_sizes, *, extent,
                  nms_thresh=None, max_proposals=None) -> LocalizeTestOut:
    """feats: (B, C, H', W') f32 channels_last; img_h / img_w: (B,) f32;
    extent: (fh, fw), as `localize_train` takes it."""
    nms_thresh = cfg.test_rpn_nms_thresh if nms_thresh is None else nms_thresh
    K = cfg.test_max_proposals if max_proposals is None else max_proposals
    _, _, Hf, Wf = feats.shape

    with span("rpn"):
        rpn_out = rpn(feats, anchor_sizes, cfg.field_centers)
    with span("proposals"):
        fh, fw = extent
        valid = _anchor_center_valid(Hf, Wf, anchor_sizes.shape[0], fh, fw)
        boxes, clip_valid = clip_boxes(rpn_out.boxes, img_w[:, None],
                                       img_h[:, None])
        valid = valid & clip_valid
        probs = torch.softmax(rpn_out.scores, dim=-1)[..., 0]

        pre_k = cfg.test_pre_nms_topk
        if 0 < pre_k < boxes.shape[1]:
            # ascending stable sort of the negated scores: ties keep
            # anchor order, invalid (-inf) entries go to the tail
            masked = torch.where(valid, probs, -torch.inf)
            neg_sorted, sorted_idx = torch.sort(-masked, dim=1, stable=True)
            top_scores = -neg_sorted[:, :pre_k]
            top_idx = sorted_idx[:, :pre_k]
            sub_idx, roi_valid = nms(
                xcycwh_to_x1y1x2y2(gather_rows(boxes, top_idx)), top_scores,
                nms_thresh, K, valid=top_scores > -torch.inf, presorted=True)
            idx = top_idx.gather(1, sub_idx.long())
        else:
            idx, roi_valid = nms(xcycwh_to_x1y1x2y2(boxes), probs,
                                 nms_thresh, K, valid=valid)
        roi_boxes = gather_rows(boxes, idx)
        roi_scores = gather_rows(probs, idx)

    with span("roi_align"):
        roi_feats = roi_align(
            feats.permute(0, 2, 3, 1).contiguous(), roi_boxes, img_h, img_w,
            fh, fw, cfg.output_height, cfg.output_width)
    return LocalizeTestOut(
        roi_feats=roi_feats, roi_boxes=roi_boxes, roi_scores=roi_scores,
        roi_valid=roi_valid, num_rois=roi_valid.sum(1, dtype=torch.int32))
