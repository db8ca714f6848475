"""Region proposal head (twin of densecap_tpu/models/rpn.py:apply_rpn).

3x3 conv + ReLU, then two 1x1 heads: 4k box-transform channels and 2k
box/not-box score channels, emitted in the reference's k-major box order.
Unlike the trunk, each conv's output is upcast to f32 before its bias is
added, as the JAX head does. In training the head also returns the
RegularizeLayer loss 0.5 * box_reg_decay * sum(trans^2) per image.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.linear import frozen
from ..ops.transforms import apply_box_transform, make_anchors, reshape_box_features


class RPNOut(NamedTuple):
    boxes: torch.Tensor    # (B, k*H*W, 4) xcycwh proposals
    anchors: torch.Tensor  # (k*H*W, 4) xcycwh anchors
    trans: torch.Tensor    # (B, k*H*W, 4) transforms
    scores: torch.Tensor   # (B, k*H*W, 2) box / not-box scores
    box_decay_loss: torch.Tensor  # (B,) 0.5 * decay * ||trans||^2


class RPN(nn.Module):
    """Weights OIHW (cast to the compute dtype at use), biases f32."""

    def __init__(self, conv, box, score, compute_dtype):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv_w, self.conv_b = frozen(conv[0]), frozen(conv[1])
        self.box_w, self.box_b = frozen(box[0]), frozen(box[1])
        self.score_w, self.score_b = frozen(score[0]), frozen(score[1])

    def _conv(self, x, w, b, padding):
        cd = self.compute_dtype
        y = F.conv2d(x.to(cd), w.to(cd), padding=padding)
        return y.float() + b.view(1, -1, 1, 1)

    def forward(self, feats, anchor_sizes, field_centers, box_reg_decay=0.0,
                decay_mask=None) -> RPNOut:
        """feats: (B, C, H', W') f32; anchor_sizes: (k, 2) (w, h).
        decay_mask: optional (B, k*H'*W') bool; anchors off each image's
        extent are left out of the decay loss."""
        _, _, Hf, Wf = feats.shape
        k = anchor_sizes.shape[0]
        hid = torch.relu(self._conv(feats, self.conv_w, self.conv_b, 1))
        trans = reshape_box_features(
            self._conv(hid, self.box_w, self.box_b, 0), k)
        scores = reshape_box_features(
            self._conv(hid, self.score_w, self.score_b, 0), k)
        anchors = make_anchors(Hf, Wf, anchor_sizes,
                               field_centers).reshape(-1, 4)
        boxes = apply_box_transform(anchors[None], trans)
        sq = trans * trans
        if decay_mask is not None:
            sq = sq * decay_mask[..., None]
        decay = 0.5 * box_reg_decay * sq.sum((1, 2))
        return RPNOut(boxes=boxes, anchors=anchors, trans=trans,
                      scores=scores, box_decay_loss=decay)
