"""Dense-captioning mAP on the host, in numpy (twin of the numpy branch of
densecap_tpu/eval/evaluator.py, after the reference's eval_utils.lua).

  * ground-truth boxes are merged at pascal IoU >= 0.7 into groups whose
    captions all count as references (`ops.boxes.merge_boxes`);
  * detections, in descending objectness, each take the merged box of
    highest IoU; the first to take a box is a hit ('ok'), later ones are
    not. When `native/libdcgeom.so` builds, the merge and this assignment
    run there (`native_lib`), with the semantics of the numpy code;
  * AP over 5 IoU thresholds {0.3 .. 0.7} x 6 caption-score thresholds
    {0, 0.05 .. 0.25}, each with 101-point interpolated precision; mAP is
    their mean. The detection AP ('detmap') uses score threshold -1,
    which ignores the caption.
"""

from __future__ import annotations

import numpy as np

from .. import native_lib
from ..ops.boxes import merge_boxes
from . import meteor

MIN_OVERLAPS = (0.3, 0.4, 0.5, 0.6, 0.7)
MIN_SCORES = (-1, 0, 0.05, 0.1, 0.15, 0.2, 0.25)


def _xcycwh_to_xyxy(b):
    b = np.asarray(b, dtype=np.float64).reshape(-1, 4)
    off = (b[:, 2:4] - 1) / 2.0
    return np.concatenate([b[:, :2] - off, b[:, :2] + off], axis=1)


def _pascal_iou_one_vs_many(bb, others):
    xx1 = np.maximum(bb[0], others[:, 0])
    yy1 = np.maximum(bb[1], others[:, 1])
    xx2 = np.minimum(bb[2], others[:, 2])
    yy2 = np.minimum(bb[3], others[:, 3])
    iw = np.maximum(xx2 - xx1 + 1, 0)
    ih = np.maximum(yy2 - yy1 + 1, 0)
    inter = iw * ih
    a1 = (bb[2] - bb[0] + 1) * (bb[3] - bb[1] + 1)
    a2 = (others[:, 2] - others[:, 0] + 1) * (others[:, 3] - others[:, 1] + 1)
    return inter / (a1 + a2 - inter)


class DenseCaptioningEvaluator:
    def __init__(self, id=""):
        self.all_logprobs = []
        self.records = []
        self.n = 1
        self.npos = 0
        self.id = id

    def add_result(self, logprobs, boxes, text, target_boxes, target_text):
        """One image's detections against its ground truth.

        logprobs: (B,) objectness scores; boxes: (B, 4) xcycwh; text: B
        caption strings; target_boxes: (M, 4) xcycwh; target_text: M
        reference strings.
        """
        logprobs = np.asarray(logprobs, dtype=np.float64).reshape(-1)
        boxes = _xcycwh_to_xyxy(boxes)
        target_boxes = _xcycwh_to_xyxy(target_boxes)
        if not len(logprobs) == len(boxes) == len(text):
            raise ValueError("logprobs, boxes and text differ in length")
        if len(target_boxes) != len(target_text):
            raise ValueError("target_boxes and target_text differ in length")

        native = native_lib.is_available("dcgeom")
        groups = (native_lib.merge_boxes(target_boxes, 0.7)
                  if native and len(target_boxes)
                  else merge_boxes(target_boxes, 0.7))
        merged_boxes = (np.stack([target_boxes[g].mean(axis=0)
                                  for g in groups])
                        if groups else np.zeros((0, 4)))
        merged_text = [[target_text[j] for j in g] for g in groups]

        nt = len(merged_boxes)
        order = np.argsort(-logprobs, kind="stable")
        for ii, jmax, ovmax, ok in zip(order, *self._assign(
                boxes[order], merged_boxes, native)):
            self.records.append({
                "ok": ok,
                "ov": ovmax,
                "candidate": text[ii],
                "references": merged_text[jmax] if jmax >= 0 else [],
                "imgid": self.n,
            })
        self.n += 1
        self.npos += nt
        self.all_logprobs.append(np.sort(logprobs)[::-1])

    @staticmethod
    def _assign(det, merged, native):
        """Greedy assignment of score-sorted x1y1x2y2 detections to the
        merged gt boxes: per detection (gt index or -1, best IoU, ok)."""
        nd, nt = len(det), len(merged)
        if native and nt:
            ov, jmax, ok = native_lib.assign(det, merged)
            return jmax.tolist(), ov.tolist(), ok.tolist()
        out = ([-1] * nd, [0.0] * nd, [0] * nd)
        used = np.zeros(nt, dtype=bool)
        for d in range(nd if nt else 0):
            ious = _pascal_iou_one_vs_many(det[d], merged)
            j = int(np.argmax(ious))
            out[1][d] = float(ious[j])
            if not out[1][d] <= 0:
                out[0][d] = j
                if not used[j]:
                    used[j] = True
                    out[2][d] = 1
        return out

    def num_added(self):
        return self.n - 1

    def evaluate(self):
        """The AP grid as a few array operations over (records x 7 score
        thresholds), one IoU threshold at a time."""
        logprobs = (np.concatenate(self.all_logprobs) if self.all_logprobs
                    else np.zeros(0))
        blob = meteor.score_captions(self.records)

        order = np.argsort(-logprobs, kind="stable")
        n = len(order)
        recs = self.records
        has_refs = np.array([bool(r["references"]) for r in recs],
                            dtype=bool)[order]
        ov = np.array([r["ov"] for r in recs], dtype=np.float64)[order]
        ok = np.array([r["ok"] for r in recs], dtype=np.int64)[order] == 1
        sc = np.asarray(blob["scores"], dtype=np.float64)[order]

        sc_pass = sc[:, None] > np.array(MIN_SCORES, dtype=np.float64)[None]
        base = has_refs & ok
        ranks = np.arange(1, n + 1, dtype=np.float64)
        ts = np.arange(0, 1.0001, 0.01)
        aps = np.zeros((len(MIN_OVERLAPS), len(MIN_SCORES)))
        for oi, min_overlap in enumerate(MIN_OVERLAPS):
            tp = ((base & (ov >= min_overlap))[:, None]
                  & sc_pass).astype(np.float64)             # (n, 7)
            tp_cum = np.cumsum(tp, axis=0)
            rec = tp_cum / max(self.npos, 1)
            prec = tp_cum / np.maximum(ranks[:, None], 1e-12)
            # recall never falls down a column, so {rec >= t} is a suffix
            # and its best precision a suffix maximum
            suffix_max = np.maximum.accumulate(prec[::-1], axis=0)[::-1]
            for si in range(len(MIN_SCORES) if n else 0):
                idx = np.searchsorted(rec[:, si], ts, side="left")
                aps[oi, si] = suffix_max[idx[idx < n], si].sum() / 101.0

        ap_results, det_results = {}, {}
        for oi, min_overlap in enumerate(MIN_OVERLAPS):
            for si, min_score in enumerate(MIN_SCORES):
                ap = float(aps[oi, si])
                if min_score == -1:
                    det_results[f"ov{min_overlap}"] = ap
                else:
                    ap_results[f"ov{min_overlap}_score{min_score}"] = ap

        def mean(d):
            return float(np.mean(list(d.values()))) if d else 0.0

        return {
            "map": mean(ap_results),
            "ap_breakdown": ap_results,
            "detmap": mean(det_results),
            "det_breakdown": det_results,
            "score_method": blob["method"],
        }
