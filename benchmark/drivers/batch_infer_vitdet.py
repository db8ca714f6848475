"""Offline batch captioning with a ViTDet trunk: `batch_infer.py`'s
closed loop, taps and judge, on the ViTDet configuration's weights.

What differs from `batch_infer.Driver`:

  * the program must have a `trunk` field in its `DenseCapConfig`, else
    the run stops at once (`harness.Failure`), before anything is built;
  * the weights come from `benchlib.vitdet.VitWeights` (the trunk under
    "vit", the RPN and fc6 at the neck's channels);
  * for the calls judged, the program's stride-16 features are kept too
    (copied to pinned host memory behind the call, with no wait), and
    the check adds `feat_err`: the norm of the difference between the
    program's features and the reference's on the same canvas over the
    norm of the reference's, the widest over the judged images;
  * the reference is `reference.vitdet_ref.VitReference`.

`rel_pos = False` runs the program without its relative-position terms
(every block's tables zeroed after the build): a broken program the
check has to reject (`control_vitdet.py`, the benchmark's tests).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from benchlib import harness, vitdet
from benchlib import program as pg
from drivers import batch_infer
from reference.densecap_ref import f32_math
from reference.judge import judge, worst
from reference.vitdet_ref import VitReference


@contextlib.contextmanager
def vit_weights():
    """`program.weights_numpy` gives the ViTDet tree inside the block."""
    plain = pg.weights_numpy
    pg.weights_numpy = vitdet.weights_numpy
    try:
        yield
    finally:
        pg.weights_numpy = plain


class Driver(batch_infer.Driver):
    def __init__(self, run):
        from densecap_tpu_torch.config import DenseCapConfig

        if "trunk" not in {f.name for f in dataclasses.fields(DenseCapConfig)}:
            raise harness.Failure("the program's DenseCapConfig has no "
                                  "`trunk` field: it cannot build a ViTDet "
                                  "trunk")
        super().__init__(run)
        self.rel_pos = True

    def setup(self):
        with vit_weights():
            super().setup()
        if not self.rel_pos:
            for blk in self.model.vit.blocks:
                blk.attn.rel_h.zero_()
                blk.attn.rel_w.zero_()
        # the judged calls' features, to host buffers made here (pinned
        # on the card)
        cfg = self.run.cfg
        shape = ((int(self.w["batch"]), int(cfg["vit_out_channels"]))
                 + (vitdet.grid(cfg),) * 2)
        bufs = {i: torch.empty(shape, pin_memory=self.dev.type == "cuda")
                for i in self.taps}
        self.feats = {}
        tap_call = {id(t): i for i, t in self.taps.items()}
        features = self.model.features

        def tapped(images, img_h, img_w):
            f = features(images, img_h, img_w)
            i = tap_call.get(id(self.tap))
            if i is not None:
                self.feats[i] = bufs[i].copy_(f, non_blocking=True)
            return f

        self.model.features = tapped

    def check(self):
        run, w = self.run, self.w
        weights = vitdet.VitWeights(run.cfg, run.seed, self.dev)
        ref = VitReference(weights.tree, run.cfg)
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
                    ref.features = lambda *a: feats  # judge's own call
                    reading = judge(ref, image, h, cw, served)
                    del ref.features
                    reading["feat_err"] = batch_infer.rel_err(prog[b], feats)
                    readings.append(reading)
            readings += [batch_infer.stage_errors(ref, t, self.dev)
                         for t in self.taps.values()]
        return worst(readings)
