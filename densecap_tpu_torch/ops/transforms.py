"""Box regression and anchor layout (twin of densecap_tpu/ops/transforms.py)."""

from __future__ import annotations

import torch

# exp(20) ~ 5e8: far beyond any real box ratio; guards exp() overflow
MAX_LOG_SCALE = 20.0
# floor on box sizes in invert_box_transform: zero-size padded rows give
# large but finite transforms (masked by the losses' |t| > 10 rule)
MIN_BOX_SIZE = 1e-8


def apply_box_transform(boxes, trans):
    """R-CNN box regression: xcycwh anchors + (tx, ty, tw, th) -> boxes.

    x = tx * wa + xa; w = wa * exp(tw), with tw / th clamped to
    +-MAX_LOG_SCALE before the exp.
    """
    xa, ya, wa, ha = boxes.unbind(-1)
    tx, ty, tw, th = trans.unbind(-1)
    tw = torch.clamp(tw, -MAX_LOG_SCALE, MAX_LOG_SCALE)
    th = torch.clamp(th, -MAX_LOG_SCALE, MAX_LOG_SCALE)
    return torch.stack([tx * wa + xa, ty * ha + ya,
                        wa * torch.exp(tw), ha * torch.exp(th)], dim=-1)


def invert_box_transform(anchor_boxes, target_boxes):
    """The transform taking xcycwh anchors to targets:
    tx = (xt - xa) / wa, tw = log(wt / wa), sizes floored at MIN_BOX_SIZE."""
    xa, ya, wa, ha = anchor_boxes.unbind(-1)
    xt, yt, wt, ht = target_boxes.unbind(-1)
    wa = torch.clamp_min(wa, MIN_BOX_SIZE)
    ha = torch.clamp_min(ha, MIN_BOX_SIZE)
    wt = torch.clamp_min(wt, MIN_BOX_SIZE)
    ht = torch.clamp_min(ht, MIN_BOX_SIZE)
    return torch.stack([(xt - xa) / wa, (yt - ya) / ha,
                        torch.log(wt / wa), torch.log(ht / ha)], dim=-1)


def make_anchors(feat_h, feat_w, anchors, field_centers):
    """(k, 2) anchor (w, h) sizes tiled over the map -> (k, H', W', 4) xcycwh.

    Flattening with `.reshape(-1, 4)` gives the reference's k-major,
    row-major box order, which NMS tie-breaking depends on.
    """
    x0, y0, sx, sy = field_centers
    dev = anchors.device
    k = anchors.shape[0]
    xc = x0 + sx * torch.arange(feat_w, dtype=torch.float32, device=dev)
    yc = y0 + sy * torch.arange(feat_h, dtype=torch.float32, device=dev)
    shape = (k, feat_h, feat_w)
    return torch.stack([
        xc[None, None, :].expand(shape),
        yc[None, :, None].expand(shape),
        anchors[:, 0, None, None].expand(shape),
        anchors[:, 1, None, None].expand(shape),
    ], dim=-1)


def reshape_box_features(x, k):
    """NCHW head output (N, k*D, H, W) -> (N, k*H*W, D).

    The head's channels group as (k, D) per pixel, so the view
    (N, k, D, H, W) permuted to (N, k, H, W, D) keeps the k-major box
    order of `densecap_tpu.ops.transforms.reshape_box_features`.
    """
    N, Dk, H, W = x.shape
    D = Dk // k
    x = x.reshape(N, k, D, H, W).permute(0, 1, 3, 4, 2)
    return x.reshape(N, k * H * W, D)
