"""DenseCap: trunk -> localization -> recognition -> (losses | final NMS
-> decode).

Twin of `densecap_tpu/models/densecap.py` (`features`, `forward_train`,
`forward_test`, `forward_test_batch`, `extract_features`). The JAX
package vmaps a single-image function; here the batch dimension is real
and each image carries its own extent. All B*K rows decode together,
greedily or by beam search, which equals the vmapped per-image loops
because finished rows emit END with logprob 0.

The language model is DenseCap's LSTM (`models/lstm.py`), conditioned on
each region's fc7 code, or with `cfg.lm` "grit_textdec" GRiT's text
decoder (`models/textdec.py`, greedy inference only), conditioned on each
final box's features pooled again from the trunk's map.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from ..ops import losses as L
from ..ops.boxes import clip_boxes, xcycwh_to_x1y1x2y2
from ..ops.linear import dot_f32, frozen
from ..ops.nms import nms
from ..ops.transforms import apply_box_transform
from ..utils.profiling import span
from .localization import gather_rows, localize_test, localize_train
from .lstm import get_target
from .textdec import TEXTDEC_BEAM
from .vgg16 import feat_extent


class TestOutput(NamedTuple):
    boxes: torch.Tensor             # (B, K, 4) final xcycwh boxes
    scores: torch.Tensor            # (B, K) raw objectness logits
    captions: torch.Tensor          # (B, K, T) int32 tokens (END = V+1)
    caption_logprobs: torch.Tensor  # (B, K, T) per-token logprobs
    valid: torch.Tensor             # (B, K) bool
    num: torch.Tensor               # (B,) int32


class Detections(NamedTuple):
    """What `DenseCap._detect` gives: K RoIs an image."""

    valid: torch.Tensor   # (B, K) bool, the RoIs that exist
    codes: torch.Tensor   # (B, K, D) fc7 codes
    scores: torch.Tensor  # (B, K) objectness logits
    boxes: torch.Tensor   # (B, K, 4) final xcycwh boxes
    feats: torch.Tensor   # (B, Hf, Wf, C) f32 trunk features, NHWC
    extent: tuple         # (fh, fw) (B,) int32 feature extents


class DenseCap(nn.Module):
    """The model. Build it with `utils.checkpoint.to_torch`.

    Padded output slots hold index 0 of the final NMS, so their boxes,
    scores and captions are those of the top box, not zeros; `valid`
    marks the real ones.
    """

    def __init__(self, cfg, trunk1, trunk2, rpn, recog, objectness,
                 box_reg, lm, vit=None):
        super().__init__()
        self.cfg = cfg
        self.trunk1, self.trunk2, self.rpn, self.recog = (
            trunk1, trunk2, rpn, recog)
        self.vit = vit  # `models.vitdet.ViTDet` in VGG-16's place
        self.obj_w, self.obj_b = frozen(objectness[0]), frozen(objectness[1])
        self.box_w, self.box_b = frozen(box_reg[0]), frozen(box_reg[1])
        self.lm = lm

    def features(self, images, img_h, img_w):
        """(B, H, W, 3) f32 BGR mean-subtracted canvases -> (B, 512, H/16,
        W/16) f32 channels_last, zero past each image's extent.

        Trunk1 (with K3 when `cfg.fuse_conv_pool`) always runs without
        gradient: the reference never trains it. With
        `cfg.static_freeze_cnn` trunk2 does too, which removes the whole
        trunk from the backward.

        With a ViTDet trunk (`cfg.trunk`, inference only) the features
        are (B, vit_out_channels, G, G) over the whole `vit_img_size`
        square the canvas is padded to; they are not zeroed past the
        extent, as ViTDet's are not.
        """
        with span("trunk"):
            if self.vit is not None:
                return self.vit(images, img_h, img_w)
            x = images.permute(0, 3, 1, 2)  # channels_last view of NHWC
            with torch.no_grad():
                x = self.trunk1(x, img_h, img_w,
                                fuse=self.cfg.fuse_conv_pool)
            eh, ew = torch.floor(img_h / 4.0), torch.floor(img_w / 4.0)
            with torch.set_grad_enabled(torch.is_grad_enabled()
                                        and not self.cfg.static_freeze_cnn):
                return self.trunk2(x, eh, ew)

    def feat_extent(self, img_h, img_w):
        """Each image's extent on the feature map, by the trunk's own rule:
        the ViT's patch grid, or VGG-16's four floor-halvings."""
        if self.vit is not None:
            return self.vit.feat_extent(img_h, img_w)
        return feat_extent(img_h, img_w)

    def _linear(self, x, w, b):
        return dot_f32(x, w, self.cfg.compute_dtype) + b

    def forward_train(self, images, img_h, img_w, gt_boxes, gt_labels,
                      gt_valid, *, generator=None, debug_sampler=None):
        """Per-image training losses, each (B,).

        images: (B, H, W, 3) f32 normalized canvases; img_h / img_w (B,);
        gt_boxes (B, G, 4) xcycwh; gt_labels (B, G, L) tokens (0-padded);
        gt_valid (B, G) bool. `generator` draws the sample and dropout;
        debug_sampler: dict(pos=(P,), neg=(M,)) ordinals replacing the
        sample's draws (parity tests, with cfg.drop_prob = 0).
        """
        cfg = self.cfg
        img_h, img_w = img_h.float(), img_w.float()
        feats = self.features(images, img_h, img_w)
        with span("localize"):
            loc = localize_train(self.rpn, feats, img_h, img_w, gt_boxes,
                                 gt_labels, gt_valid, generator, cfg,
                                 cfg.anchor_tensor(images.device),
                                 extent=self.feat_extent(img_h, img_w),
                                 debug_sampler=debug_sampler)
        B, R = loc.roi_boxes.shape[:2]
        P = loc.pos_valid.shape[1]
        with span("recog"):
            codes = self.recog(loc.roi_feats.flatten(0, 1),
                               drop_prob=cfg.drop_prob, generator=generator)
            roi_valid = torch.cat([loc.pos_valid, loc.neg_valid], 1)

            # final objectness: valid positive slots labeled 1, the rest 0
            obj_scores = self._linear(codes, self.obj_w, self.obj_b)
            obj_labels = torch.cat(
                [loc.pos_valid.long(),
                 torch.zeros_like(loc.neg_valid.long())], 1)
            end_obj = cfg.end_objectness_weight * L.logistic(
                obj_scores.reshape(B, R, -1), obj_labels, roi_valid)

            pos_codes = codes.reshape(B, R, -1)[:, :P].flatten(0, 1)
            final_trans = self._linear(pos_codes, self.box_w, self.box_b)
            end_box = L.box_regression(
                loc.pos_boxes, final_trans.reshape(B, P, 4),
                loc.pos_target_boxes, loc.pos_valid,
                weight=cfg.end_box_reg_weight)

        with span("lm.train"):
            labels = loc.pos_target_labels
            lm_scores = self.lm.forward_train(pos_codes, labels.flatten(0, 1))
            cap = cfg.captioning_weight * L.temporal_cross_entropy(
                lm_scores.reshape(B, P, *lm_scores.shape[1:]),
                get_target(labels, cfg.vocab_size), loc.pos_valid)

        losses = dict(loc.losses)
        losses["end_objectness_loss"] = end_obj
        losses["end_box_reg_loss"] = end_box
        losses["captioning_loss"] = cap
        losses["total_loss"] = (
            losses["mid_objectness_loss"] + losses["mid_box_reg_loss"]
            + losses["box_decay_loss"] + end_obj + end_box + cap)
        return losses

    def _detect(self, images, img_h, img_w, rpn_nms_thresh=None,
                max_proposals=None):
        """Trunk, localization and recognition -> `Detections`."""
        img_h, img_w = img_h.float(), img_w.float()
        feats = self.features(images, img_h, img_w)
        extent = self.feat_extent(img_h, img_w)
        with span("localize"):
            loc = localize_test(
                self.rpn, feats, img_h, img_w, self.cfg,
                self.cfg.anchor_tensor(images.device), extent=extent,
                nms_thresh=rpn_nms_thresh, max_proposals=max_proposals)
        B, K = loc.roi_boxes.shape[:2]
        with span("recog"):
            codes = self.recog(loc.roi_feats.flatten(0, 1))
            scores = self._linear(codes, self.obj_w,
                                  self.obj_b)[:, 0].reshape(B, K)
            trans = self._linear(codes, self.box_w,
                                 self.box_b).reshape(B, K, 4)
            boxes = apply_box_transform(loc.roi_boxes, trans)
        return Detections(loc.roi_valid, codes.reshape(B, K, -1), scores,
                          boxes, feats.permute(0, 2, 3, 1).contiguous(),
                          extent)

    @torch.inference_mode()
    def forward_test_batch(self, images, img_h, img_w, *,
                           rpn_nms_thresh: Optional[float] = None,
                           final_nms_thresh: Optional[float] = None,
                           max_proposals: Optional[int] = None,
                           use_beam: int = 0) -> TestOutput:
        """images: (B, H, W, 3) f32 canvases (any H, W; a canvas cropped to
        a bucket gives the outputs of the square one); img_h / img_w: (B,)
        f32 true sizes on the canvas. `use_beam` > 0 decodes with a beam
        search of that width, 0 greedily. The outputs hold the
        `cfg.test_final_max_boxes` rows an image that the final NMS keeps
        (K, the proposals, when it is unset or there is no final NMS)."""
        cfg = self.cfg
        if use_beam > 0 and cfg.is_textdec:
            raise ValueError(TEXTDEC_BEAM)
        final_nms = (cfg.test_final_nms_thresh if final_nms_thresh is None
                     else final_nms_thresh)
        with span("infer.forward", images.device):
            det = self._detect(images, img_h, img_w, rpn_nms_thresh,
                               max_proposals)
            valid, codes, scores, boxes = det[:4]
            B, K = scores.shape
            M = min(K, cfg.test_final_max_boxes or K) if final_nms > 0 else K
            with span("final_nms"):
                if cfg.clip_final_boxes:
                    boxes, _ = clip_boxes(boxes, img_w.float()[:, None],
                                          img_h.float()[:, None])
                if final_nms > 0:
                    idx, valid = nms(xcycwh_to_x1y1x2y2(boxes), scores,
                                     final_nms, M, valid=valid)
                    boxes, scores, codes = (gather_rows(x, idx)
                                            for x in (boxes, scores, codes))

            if cfg.is_textdec:
                cache = self.lm.prefill(det.feats, boxes, img_h.float(),
                                        img_w.float(), det.extent,
                                        cfg.seq_length)
                captions, lps = self.lm.greedy_decode(cache, cfg.seq_length)
            elif use_beam > 0:
                captions, lps, _ = self.lm.beamsearch(
                    codes.reshape(B * M, -1), cfg.seq_length, use_beam)
            else:
                captions, lps = self.lm.greedy_decode(
                    codes.reshape(B * M, -1), cfg.seq_length)
            T = captions.shape[1]
            return TestOutput(
                boxes=boxes, scores=scores,
                captions=captions.reshape(B, M, T),
                caption_logprobs=lps.reshape(B, M, T),
                valid=valid, num=valid.sum(1, dtype=torch.int32))

    @torch.inference_mode()
    def extract_features(self, images, img_h, img_w, *,
                         final_nms_thresh=0.4, max_boxes=100):
        """Boxes and codes of the top regions after a final NMS (the
        reference's extractFeatures: 100 boxes at 0.4).

        Returns final xcycwh boxes (B, max_boxes, 4), not clipped, their
        codes (B, max_boxes, fc_dim) and `valid` (B, max_boxes); padded
        slots repeat the top box.
        """
        with span("infer.forward", images.device):
            valid, codes, scores, boxes = self._detect(images, img_h,
                                                       img_w)[:4]
            with span("final_nms"):
                idx, valid = nms(xcycwh_to_x1y1x2y2(boxes), scores,
                                 final_nms_thresh, max_boxes, valid=valid)
                return (gather_rows(boxes, idx), gather_rows(codes, idx),
                        valid)
