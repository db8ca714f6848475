"""Offline batch captioning: `DenseCap.forward_test_batch` in a closed loop.

The loop is a frozen copy of `bench_torch.py`'s: two seeded input batches
in turns, each call's checksum (the sum of boxes, scores, captions and
counts, a scalar on the card) read once `depth` later calls were issued.
It runs for the window's seconds, then reads the checksums still in
flight and synchronises; the rate is images over all of that time.

The inputs are the benchmark's: B canvases of `canvas` (H, W) holding
`content` (h, w) frames of standard normals times 30 drawn on the device
from the seed, zero past the frame. From outside the program the driver
keeps, for the calls drawn from the seed for the check, the proposals
and their scores that `localize_test` returned and the picks of the
final NMS, beside the outputs; and, for `check.rows` rows of each image,
the recognition network's input and output and the vocab projection's
input and output at every decode step (copied to pinned host memory
behind the call, with no wait), so that the check can judge those two
stages on the program's own inputs.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchlib import program as pg
from benchlib.weights import Weights
from reference.densecap_ref import Reference, f32_math
from reference.judge import judge, worst


class Taps:
    """The rows of one call that the check judges at two stages: the first
    `rows` of each of the B images, at the recognition network's input
    and output and at the vocab projection's input and output (one pair
    a decode step). Without `like` (a probe, in set-up) they are copied to
    the host to learn the shapes; with it they go, without a wait, to host
    buffers shaped like the probe's."""

    NAMES = ("recog_in", "recog_out", "proj_in", "proj_out")

    def __init__(self, B, rows, like=None, pin=False):
        self.B, self.rows = B, rows
        self.got = {k: [] for k in self.NAMES}
        self.bufs = None
        if like is not None:
            self.bufs = {k: [torch.empty(t.shape, dtype=t.dtype,
                                         pin_memory=pin) for t in v]
                         for k, v in like.got.items()}

    def put(self, name, x):
        K = x.shape[0] // self.B
        dev = x.device
        idx = (torch.arange(self.B, device=dev)[:, None] * K
               + torch.arange(self.rows, device=dev)[None]).flatten()
        part = x.detach().index_select(0, idx)
        got = self.got[name]
        if self.bufs is None:
            got.append(part.cpu())
        elif len(got) < len(self.bufs[name]):
            got.append(self.bufs[name][len(got)].copy_(part,
                                                       non_blocking=True))


def checksum(out):
    return (out.boxes.float().sum() + out.scores.float().sum()
            + out.captions.sum() + out.num.sum())


class Driver:
    def __init__(self, run):
        self.run = run
        self.w = run.workload["inputs"]
        self.dev = torch.device(run.device)
        self.quantize = False  # the control: the program's int8 path on

    def setup(self):
        import densecap_tpu_torch.models.densecap as dc_mod
        from densecap_tpu_torch.ops.cuda import build
        from densecap_tpu_torch.utils.checkpoint import to_torch

        run, w, dev = self.run, self.w, self.dev
        if dev.type == "cuda":
            build.load()
        self.pcfg = pg.program_config(run.cfg)
        params = pg.weights_numpy(run.cfg, run.seed, dev)
        if self.quantize:
            from densecap_tpu_torch.ops.quant import quantize_for_inference
            params = quantize_for_inference(params, quantize_lm_proj=True)
        self.model = to_torch(params, self.pcfg, dev)
        del params
        B = int(w["batch"])
        H, W = w["canvas"]
        h, cw = w["content"]
        gen = torch.Generator(device=dev).manual_seed(run.seed)
        self.images = torch.randn((2, B, H, W, 3), generator=gen,
                                  device=dev).mul_(30.0)
        self.images[:, :, h:] = 0  # the canvas past the frame is padding
        self.images[:, :, :, cw:] = 0
        self.hs = torch.full((B,), float(h), device=dev)
        self.ws = torch.full((B,), float(cw), device=dev)

        # from outside: what the proposals' and the final NMS's calls give
        self.cap = {}
        loc_fn, nms_fn = dc_mod.localize_test, dc_mod.nms

        def localize(*a, **kw):
            out = loc_fn(*a, **kw)
            self.cap["rois"], self.cap["roi_valid"] = (out.roi_boxes,
                                                       out.roi_valid)
            self.cap["roi_scores"] = out.roi_scores
            return out

        def final_nms(*a, **kw):
            idx, valid = nms_fn(*a, **kw)
            self.cap["idx"] = idx
            return idx, valid

        dc_mod.localize_test, dc_mod.nms = localize, final_nms
        self._restore = (dc_mod, loc_fn, nms_fn)
        self.tap = None
        recog, lm = self.model.recog, self.model.lm
        recog_fwd, project = recog.forward, lm.project

        def recog_tap(x, *a, **kw):
            y = recog_fwd(x, *a, **kw)
            if self.tap is not None:
                self.tap.put("recog_in", x)
                self.tap.put("recog_out", y)
            return y

        def proj_tap(h):
            scores = project(h)
            if self.tap is not None:
                self.tap.put("proj_in", h)
                self.tap.put("proj_out", scores)
            return scores

        recog.forward, lm.project = recog_tap, proj_tap
        if run.tracing:
            self.decode = pg.CudaSpans()
            lm = self.model.lm
            self.steps = []
            inner = self.decode.wrap(lm.greedy_decode)

            def decode(vectors, seq_length):
                seq, lps = inner(vectors, seq_length)
                end = lm.vocab_size + 1
                is_end = seq == end
                first = torch.where(is_end.any(1), is_end.int().argmax(1),
                                    seq.shape[1])
                self.steps.append((first.max() + 1).clamp(max=seq.shape[1]))
                return seq, lps

            lm.greedy_decode = decode
        B, rows = int(w["batch"]), int(run.workload["check"]["rows"])
        probe = self.tap = Taps(B, rows)
        for i in range(2):  # warm-up: both batches, every shape
            float(checksum(self.call(i)))
            self.tap = None
        t0 = time.perf_counter()
        float(checksum(self.call(0)))
        t_call = time.perf_counter() - t0
        n_est = max(2, int(0.8 * run.seconds / max(t_call, 1e-3)))
        # the calls judged, from the seed: as many of one input batch as
        # of the other
        rng = np.random.default_rng([run.seed, 3])
        n = int(run.workload["check"]["calls"])
        self.sample = set()
        for parity in (0, 1):
            pool = np.arange(parity, n_est, 2)
            self.sample |= {int(i) for i in rng.choice(
                pool, size=min((n + 1 - parity) // 2, len(pool)),
                replace=False)}
        self.kept = {}
        self.taps = {i: Taps(B, rows, like=probe, pin=dev.type == "cuda")
                     for i in self.sample}
        del probe
        if run.tracing:
            self.decode.events.clear()
            self.steps.clear()

    def call(self, i):
        return self.model.forward_test_batch(self.images[i % 2], self.hs,
                                             self.ws)

    def keep(self, i, out):
        self.kept[i] = {"out": out, **self.cap}

    def window(self, seconds):
        depth = int(self.w["depth"])
        futures = []
        calls = 0
        last_kept = max(self.sample)
        with self.run.window():
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds or calls <= last_kept:
                self.tap = self.taps.get(calls)
                out = self.call(calls)
                self.tap = None
                if calls in self.sample:
                    self.keep(calls, out)
                futures.append(checksum(out))
                calls += 1
                if len(futures) > depth:
                    float(futures.pop(0))
            for f in futures:
                float(f)
            if self.dev.type == "cuda":
                torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
        B = int(self.w["batch"])
        self.run.counters.update(calls=calls, images=calls * B)
        if self.run.tracing:
            self.run.spans["decode_ms"] = self.decode.ms()
            self.run.counters["decode_steps"] = [int(s) for s in self.steps]
        return {"metrics": {"infer_images_per_s": calls * B / elapsed},
                "attempted": calls * B, "failed": 0}

    def release(self):
        if getattr(self, "_restore", None):
            dc_mod, loc_fn, nms_fn = self._restore
            dc_mod.localize_test, dc_mod.nms = loc_fn, nms_fn
            self._restore = None
        self.model = None
        self.cap = {}

    def check(self):
        run, w = self.run, self.w
        weights = Weights(run.cfg, run.seed, self.dev)
        ref = Reference(weights.tree, run.cfg)
        readings = []
        h, cw = w["content"]
        with f32_math():
            for i, rec in sorted(self.kept.items()):
                out = rec["out"]
                for b in range(out.boxes.shape[0]):
                    v = out.valid[b]
                    served = {"boxes": out.boxes[b][v].float(),
                              "scores": out.scores[b][v].float(),
                              "tokens": out.captions[b][v],
                              "rois": rec["rois"][b].float(),
                              "roi_valid": rec["roi_valid"][b],
                              "roi_scores": rec["roi_scores"][b].float(),
                              "idx": rec["idx"][b][v]}
                    readings.append(judge(ref, self.images[i % 2][b],
                                          float(h), float(cw), served))
            readings += [stage_errors(ref, t, self.dev)
                         for t in self.taps.values()]
        return worst(readings)


def rel_err(prog, ref):
    return float(torch.linalg.vector_norm(prog - ref)
                 / torch.linalg.vector_norm(ref))


@torch.no_grad()
def stage_errors(ref, taps, dev):
    """The recognition network (fc6, fc7) and the vocab projection judged
    on the program's own inputs: the norm of the difference between the
    program's outputs and the reference's over the norm of the
    reference's, over the kept rows (and decode steps)."""
    out = {}
    if taps.got["recog_in"]:
        x = taps.got["recog_in"][0].to(dev).float()
        y = taps.got["recog_out"][0].to(dev).float()
        out["recog_err"] = rel_err(y, ref.codes(x))
    if taps.got["proj_in"]:
        h = torch.cat(taps.got["proj_in"]).to(dev).float()
        s = torch.cat(taps.got["proj_out"]).to(dev).float()
        out["proj_err"] = rel_err(s, ref.logits(h))
    return out
