"""Offline batch captioning with GRiT's text decoder on a ViTDet trunk:
`batch_infer_vitdet.py`'s closed loop, taps, features and judge, on the
GRiT configuration's weights.

What differs from `batch_infer_vitdet.Driver`:

  * the program must have an `lm` field in its `DenseCapConfig`, else the
    run stops at once (`harness.Failure`), before anything is built;
  * the weights come from `benchlib.grit.GritWeights` (the text decoder
    under "lm" in the LSTM's place);
  * the reference is `reference.grit_ref.GritReference`. `token_gap` is
    judged on its `teacher_logits` at the program's final boxes (its own
    features pooled there, the program's tokens teacher-forced), and the
    judge's final NMS has the configuration's `test_final_max_boxes`
    slots an image;
  * the check adds `lp_err`: the widest gap between a served logprob and
    the reference's log-softmax at the served token, up to the first
    END.

`fault` runs a broken program that the check has to reject
(`control_grit.py`, the benchmark's tests): a name of
`control_grit.FAULTS`, applied for the driver's whole life. `judge_grit`
judges one image; `control_grit.py` judges the fp8 reference with it.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from benchlib import grit, harness, vitdet
from drivers import batch_infer, batch_infer_vitdet
from reference.densecap_ref import f32_math
from reference.grit_ref import GritReference
from reference.judge import MISS, judge, worst


@contextlib.contextmanager
def grit_weights():
    """`batch_infer_vitdet`'s weights are the GRiT tree inside the
    block."""
    plain = vitdet.weights_numpy
    vitdet.weights_numpy = grit.weights_numpy
    try:
        yield
    finally:
        vitdet.weights_numpy = plain


def lp_gap(ref_logits, tokens, lps, end):
    """The widest |served logprob - the reference's log-softmax at the
    served token| over the positions up to each row's first END; MISS for
    a token out of range."""
    if tokens.shape[0] == 0:
        return 0.0
    tok = tokens.long()
    lsm = torch.log_softmax(ref_logits, -1)
    own = lsm.gather(2, (tok - 1).clamp(0, lsm.shape[2] - 1)[..., None])
    err = (lps - own[..., 0]).abs()
    err = torch.where((tok < 1) | (tok > end), MISS, err)
    is_end = tok == end
    first = torch.where(is_end.any(1), is_end.int().argmax(1),
                        tok.shape[1] - 1)
    upto = torch.arange(tok.shape[1], device=tok.device)[None] <= first[:,
                                                                      None]
    return float(torch.where(upto, err, 0.0).max())


def judge_grit(ref, image, h, w, served, lps, feats):
    """One image judged as `judge` judges it, on the reference's features
    `feats`: `token_gap` on the reference's teacher-forced logits at the
    served boxes, the final NMS's slots `test_final_max_boxes`, and
    `lp_err` of the served logprobs `lps`."""
    cfg = ref.cfg
    logits = ref.teacher_logits(
        ref.object_features(feats, served["boxes"], h, w), served["tokens"])
    # judge's own calls: the features, the teacher-forced logits, the
    # final NMS's slots
    ref.features = lambda *a: feats
    ref.teacher_logits = lambda *a: logits
    ref.cfg = dict(cfg, test_max_proposals=grit.final_rows(cfg))
    try:
        reading = judge(ref, image, h, w, served)
    finally:
        del ref.features, ref.teacher_logits
        ref.cfg = cfg
    reading["lp_err"] = lp_gap(logits, served["tokens"], lps, ref.V + 1)
    return reading


class Driver(batch_infer_vitdet.Driver):
    fault = None

    def __init__(self, run):
        from densecap_tpu_torch.config import DenseCapConfig

        if "lm" not in {f.name for f in dataclasses.fields(DenseCapConfig)}:
            raise harness.Failure("the program's DenseCapConfig has no `lm` "
                                  "field: it cannot build GRiT's text "
                                  "decoder")
        super().__init__(run)
        self._faulty = None

    def setup(self):
        if self.fault:
            import control_grit

            self._faulty = control_grit.FAULTS[self.fault]()
            self._faulty.__enter__()
        with grit_weights():
            super().setup()

    def release(self):
        super().release()
        if self._faulty is not None:
            self._faulty.__exit__(None, None, None)
            self._faulty = None

    def check(self):
        run, w, cfg = self.run, self.w, self.run.cfg
        weights = grit.GritWeights(cfg, run.seed, self.dev)
        ref = GritReference(weights.tree, cfg)
        readings = []
        h, cw = (float(x) for x in w["content"])
        with f32_math(), torch.no_grad():
            for i, rec in sorted(self.kept.items()):
                out = rec["out"]
                prog = self.feats[i].to(self.dev)
                for b in range(out.boxes.shape[0]):
                    image = self.images[i % 2][b]
                    feats = ref.features(image, h, cw)
                    v = out.valid[b]
                    served = {"boxes": out.boxes[b][v].float(),
                              "scores": out.scores[b][v].float(),
                              "tokens": out.captions[b][v],
                              "rois": rec["rois"][b].float(),
                              "roi_valid": rec["roi_valid"][b],
                              "roi_scores": rec["roi_scores"][b].float(),
                              "idx": rec["idx"][b][v]}
                    reading = judge_grit(
                        ref, image, h, cw, served,
                        out.caption_logprobs[b][v].float(), feats)
                    reading["feat_err"] = batch_infer.rel_err(prog[b], feats)
                    readings.append(reading)
            readings += [batch_infer.stage_errors(ref, t, self.dev)
                         for t in self.taps.values()]
        return worst(readings)
