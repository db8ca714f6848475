"""Box geometry: coordinate conversions, rescaling, IoU, clipping, the
evaluator's merge and box recall.

Twin of `densecap_tpu/ops/boxes.py`. Boxes are `(..., 4)` in the
reference's 1-indexed pixel convention; every torch function broadcasts
over leading dimensions.
"""

from __future__ import annotations

import numpy as np
import torch


def xcycwh_to_x1y1x2y2(boxes):
    """(xc, yc, w, h) -> (x1, y1, x2, y2) with the (w - 1) / 2 offset."""
    xc, yc, w, h = boxes.unbind(-1)
    return torch.stack([xc - (w - 1) / 2.0, yc - (h - 1) / 2.0,
                        xc + (w - 1) / 2.0, yc + (h - 1) / 2.0], dim=-1)


def x1y1x2y2_to_xcycwh(boxes):
    x0, y0, x1, y1 = boxes.unbind(-1)
    return torch.stack([(x0 + x1) / 2.0, (y0 + y1) / 2.0, x1 - x0, y1 - y0],
                       dim=-1)


def xywh_to_x1y1x2y2(boxes):
    """(x, y, w, h) -> (x1, y1, x2, y2) with inclusive corners."""
    x, y, w, h = boxes.unbind(-1)
    return torch.stack([x, y, x + w - 1, y + h - 1], dim=-1)


def x1y1x2y2_to_xywh(boxes):
    """(x1, y1, x2, y2) -> (x, y, w, h): width x2 - x1 + 1."""
    x0, y0, x1, y1 = boxes.unbind(-1)
    return torch.stack([x0, y0, x1 - x0 + 1, y1 - y0 + 1], dim=-1)


def xywh_to_xcycwh(boxes):
    """(x, y, w, h) -> (xc, yc, w, h) by exact division (the JAX package's
    float path of the reference's conversion)."""
    x, y, w, h = boxes.unbind(-1)
    return torch.stack([x + w / 2.0, y + h / 2.0, w, h], dim=-1)


def xcycwh_to_xywh(boxes):
    """(xc, yc, w, h) -> (x, y, w, h): the corners of `xcycwh_to_x1y1x2y2`,
    then width x2 - x1 + 1 (the JAX package's composition, op for op)."""
    return x1y1x2y2_to_xywh(xcycwh_to_x1y1x2y2(boxes))


def scale_boxes_xywh(boxes, frac):
    """Rescale (x, y, w, h) boxes between image scales: x, y move to
    0-based, everything scales by `frac`, x, y move back to 1-based."""
    x, y, w, h = boxes.unbind(-1)
    return torch.stack([(x - 1) * frac + 1, (y - 1) * frac + 1, w * frac,
                        h * frac], dim=-1)


def iou_cwh(boxes1, boxes2):
    """Pairwise (..., B1, 4) x (..., B2, 4) xcycwh -> (..., B1, B2).

    The continuous convention of the sampler: corners at xc +/- w/2,
    area w * h, intersection width clamped at 0 with no +1.
    """
    def corners(b):
        xc, yc, w, h = b.unbind(-1)
        return xc - w / 2.0, yc - h / 2.0, xc + w / 2.0, yc + h / 2.0

    area1 = boxes1[..., 2] * boxes1[..., 3]
    area2 = boxes2[..., 2] * boxes2[..., 3]
    ax0, ay0, ax1, ay1 = (c[..., :, None] for c in corners(boxes1))
    bx0, by0, bx1, by1 = (c[..., None, :] for c in corners(boxes2))
    iw = torch.clamp_min(torch.minimum(ax1, bx1) - torch.maximum(ax0, bx0), 0.0)
    ih = torch.clamp_min(torch.minimum(ay1, by1) - torch.maximum(ay0, by0), 0.0)
    inter = iw * ih
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / union


def iou_pascal(boxes1, boxes2):
    """Pairwise (..., B1, 4) x (..., B2, 4) x1y1x2y2 -> (..., B1, B2).

    Pascal +1 convention: area = (x2 - x1 + 1) * (y2 - y1 + 1), the
    intersection width (xx2 - xx1 + 1) clamped at 0. The union is
    `area1 + area2 - inter`, the same f32 operation order as the JAX op,
    and the order the NMS kernel follows.
    """
    b1 = boxes1[..., :, None, :]
    b2 = boxes2[..., None, :, :]
    area1 = ((boxes1[..., 2] - boxes1[..., 0] + 1.0)
             * (boxes1[..., 3] - boxes1[..., 1] + 1.0))
    area2 = ((boxes2[..., 2] - boxes2[..., 0] + 1.0)
             * (boxes2[..., 3] - boxes2[..., 1] + 1.0))
    xx1 = torch.maximum(b1[..., 0], b2[..., 0])
    yy1 = torch.maximum(b1[..., 1], b2[..., 1])
    xx2 = torch.minimum(b1[..., 2], b2[..., 2])
    yy2 = torch.minimum(b1[..., 3], b2[..., 3])
    iw = torch.clamp_min(xx2 - xx1 + 1.0, 0.0)
    ih = torch.clamp_min(yy2 - yy1 + 1.0, 0.0)
    inter = iw * ih
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / union


def clip_boxes(boxes, x_max, y_max):
    """Clip xcycwh boxes to [1, x_max] x [1, y_max]; return (clipped, valid).

    x_max / y_max are python floats or tensors that broadcast against
    `boxes[..., 0]` (one bound per image in a batch). Clamps x1 to
    [1, x_max - 1] and x2 to [2, x_max] (same for y) and marks a box valid
    when x2 > x1 and y2 > y1 after clamping (densecap_tpu clip_boxes with
    fmt="xcycwh" and x_min = y_min = 1).
    """
    bb = xcycwh_to_x1y1x2y2(boxes)
    x_max = torch.as_tensor(x_max, dtype=bb.dtype, device=bb.device)
    y_max = torch.as_tensor(y_max, dtype=bb.dtype, device=bb.device)
    x0 = torch.minimum(torch.clamp_min(bb[..., 0], 1.0), x_max - 1)
    y0 = torch.minimum(torch.clamp_min(bb[..., 1], 1.0), y_max - 1)
    x1 = torch.minimum(torch.clamp_min(bb[..., 2], 2.0), x_max)
    y1 = torch.minimum(torch.clamp_min(bb[..., 3], 2.0), y_max)
    valid = (x1 > x0) & (y1 > y0)
    clipped = torch.stack([x0, y0, x1, y1], dim=-1)
    return x1y1x2y2_to_xcycwh(clipped), valid


def iou_matrix(boxes):
    """Symmetric (N, N) pascal IoU of (N, 4) x1y1x2y2 boxes; diagonal 1."""
    return iou_pascal(boxes, boxes)


def merge_boxes(boxes, thr):
    """Greedy grouping of (N, 4) x1y1x2y2 boxes by pascal IoU >= thr, in
    numpy (the evaluator's merge of overlapping ground truth).

    Twin of `densecap_tpu.ops.boxes.merge_boxes`: repeatedly take the
    box with the most partners at IoU >= thr and absorb them all.
    Returns a list of 0-indexed index arrays. The IoU is computed in
    float64 with the +1 convention; the JAX version computes it through
    `jnp`, which is float64 only with x64 enabled (as in its tests) and
    float32 otherwise.
    """
    assert thr > 0
    b = np.asarray(boxes, dtype=np.float64)
    if len(b) == 0:
        return []
    D = iou_matrix(torch.from_numpy(b)).numpy()
    groups = []
    while True:
        good = D >= thr
        good_sum = good.sum(axis=0)
        top = int(np.argmax(good_sum))
        if good_sum[top] == 0:
            break
        members = np.nonzero(good[top])[0]
        groups.append(members)
        D[members, :] = 0
        D[:, members] = 0
    return groups


def eval_box_recall(boxes, gt_boxes, ns=(100, 200, 300),
                    iou_threshs=(0.5, 0.7, 0.9)):
    """Box recall@n at several IoU thresholds: the share of the (M, 4)
    xcycwh gt boxes that one of the first n of the (N, 4) xcycwh `boxes`
    overlaps at IoU > thr, by the continuous convention (`iou_cwh`).

    Returns {f"{thr:.2f}_recall_at_{n}": recall}, only for n <= N.
    """
    ious = iou_cwh(boxes, gt_boxes)  # N x M
    M = gt_boxes.shape[0]
    stats = {}
    for thr in iou_threshs:
        hit = torch.cumsum((ious > thr).int(), dim=0) > 0  # N x M
        recalls = (hit.sum(dim=1) / M).tolist()  # N
        for n in ns:
            if n <= len(recalls):
                stats[f"{thr:.2f}_recall_at_{n}"] = recalls[n - 1]
    return stats
