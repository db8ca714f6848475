"""Device time of the port's B=8 flagship inference, stage by stage.

Twin of scripts/stage_profile_b8.py and, with `--batch 1`, of
scripts/profile_inference.py's single-image case. `forward_test_batch`
is cut into the stages it runs, in order, each a function of the
outputs of the ones before (`STAGES`); chained, they give
`forward_test_batch`'s outputs (tests/test_torch_tools.py holds them
equal), so the breakdown describes the program that runs:

  normalize   uint8 canvases -> f32, mean subtracted, zero past the frame
  trunk       VGG-16 (`DenseCap.features`)
  rpn         the RPN conv and heads, anchors and box transforms
  select      clip, the extent mask, softmax and the pre-NMS top-k sort
  k1          the RPN's NMS (kernel K1) to test_max_proposals
  k2          the survivors' boxes and RoI align (kernel K2)
  recog       fc6 / fc7
  heads       objectness and box heads, the box transform, the final K1
  decode      greedy LSTM decode (beam search where `run_stages` is
              given a beam)

Each stage is timed alone on device-resident inputs: CUDA events around
`--reps` back-to-back calls, repeated `--iters` times, the median per
call. The whole forward (normalize + `forward_test_batch`) is timed the
same way and printed beside the sum of the stages.

    python scripts/torch_stage_profile_b8.py [--batch 8] [--reps 10]
        [--device cuda|cpu]

Defaults: bench's program (vocab 10 000, 1000 proposals, bf16, random
weights from seed 0, so the decode runs all 15 steps) on the 720 px square
canvas with 720x540 content, as the JAX script runs it. Last line: one
JSON object with every stage's ms, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_tool_common as tc  # noqa: E402
from torch_mfu_estimate import decode_steps  # noqa: E402
from densecap_tpu_torch.models.densecap import TestOutput  # noqa: E402
from densecap_tpu_torch.models.localization import (  # noqa: E402
    _anchor_center_valid, gather_rows)
from densecap_tpu_torch.models.vgg16 import feat_extent  # noqa: E402
from densecap_tpu_torch.ops.boxes import (  # noqa: E402
    clip_boxes, xcycwh_to_x1y1x2y2)
from densecap_tpu_torch.ops.nms import nms  # noqa: E402
from densecap_tpu_torch.ops.roi_align import roi_align  # noqa: E402
from densecap_tpu_torch.ops.transforms import apply_box_transform  # noqa: E402
from densecap_tpu_torch.utils.checkpoint import (  # noqa: E402
    init_params, to_torch)
from densecap_tpu_torch.utils.image import normalize_uint8_images  # noqa: E402


def normalize(m, s):
    s["images"] = normalize_uint8_images(s["raw"], s["h"], s["w"])


def trunk(m, s):
    s["feats"] = m.features(s["images"], s["h"], s["w"])


def rpn(m, s):
    s["rpn"] = m.rpn(s["feats"], m.cfg.anchor_tensor(s["feats"].device),
                     m.cfg.field_centers)


def select(m, s):
    """localize_test up to the NMS: (boxes, NMS inputs)."""
    cfg, feats, out = m.cfg, s["feats"], s["rpn"]
    _, _, Hf, Wf = feats.shape
    fh, fw = feat_extent(s["h"], s["w"])
    valid = _anchor_center_valid(Hf, Wf, cfg.num_anchors, fh, fw)
    boxes, clip_valid = clip_boxes(out.boxes, s["w"][:, None],
                                   s["h"][:, None])
    valid = valid & clip_valid
    probs = torch.softmax(out.scores, dim=-1)[..., 0]
    pre_k = cfg.test_pre_nms_topk
    s["boxes"], s["probs"], s["extent"] = boxes, probs, (fh, fw)
    if 0 < pre_k < boxes.shape[1]:
        masked = torch.where(valid, probs, -torch.inf)
        neg_sorted, sorted_idx = torch.sort(-masked, dim=1, stable=True)
        top_scores = -neg_sorted[:, :pre_k]
        top_idx = sorted_idx[:, :pre_k]
        s["nms_in"] = (xcycwh_to_x1y1x2y2(gather_rows(boxes, top_idx)),
                       top_scores, top_scores > -torch.inf, True, top_idx)
    else:
        s["nms_in"] = (xcycwh_to_x1y1x2y2(boxes), probs, valid, False, None)


def k1(m, s):
    bx, sc, valid, presorted, top_idx = s["nms_in"]
    idx, s["roi_valid"] = nms(bx, sc, m.cfg.test_rpn_nms_thresh,
                              m.cfg.test_max_proposals, valid=valid,
                              presorted=presorted)
    s["idx"] = idx if top_idx is None else top_idx.gather(1, idx.long())


def k2(m, s):
    cfg = m.cfg
    s["roi_boxes"] = gather_rows(s["boxes"], s["idx"])
    fh, fw = s["extent"]
    s["roi_feats"] = roi_align(
        s["feats"].permute(0, 2, 3, 1).contiguous(), s["roi_boxes"],
        s["h"], s["w"], fh, fw, cfg.output_height, cfg.output_width)


def recog(m, s):
    s["codes"] = m.recog(s["roi_feats"].flatten(0, 1))


def heads(m, s):
    cfg, codes = m.cfg, s["codes"]
    B, K = s["roi_boxes"].shape[:2]
    scores = m._linear(codes, m.obj_w, m.obj_b)[:, 0].reshape(B, K)
    trans = m._linear(codes, m.box_w, m.box_b).reshape(B, K, 4)
    boxes = apply_box_transform(s["roi_boxes"], trans)
    codes = codes.reshape(B, K, -1)
    valid = s["roi_valid"]
    if cfg.clip_final_boxes:
        boxes, _ = clip_boxes(boxes, s["w"][:, None], s["h"][:, None])
    if cfg.test_final_nms_thresh > 0:
        idx, valid = nms(xcycwh_to_x1y1x2y2(boxes), scores,
                         cfg.test_final_nms_thresh, K, valid=valid)
        boxes, scores, codes = (gather_rows(x, idx)
                                for x in (boxes, scores, codes))
    s["final"] = boxes, scores, codes, valid


def decode(m, s):
    boxes, scores, codes, valid = s["final"]
    B, K = scores.shape
    flat = codes.reshape(B * K, -1)
    if s.get("beam", 0) > 0:
        caps, lps, _ = m.lm.beamsearch(flat, m.cfg.seq_length, s["beam"])
    else:
        caps, lps = m.lm.greedy_decode(flat, m.cfg.seq_length)
    T = caps.shape[1]
    s["out"] = TestOutput(boxes=boxes, scores=scores,
                          captions=caps.reshape(B, K, T),
                          caption_logprobs=lps.reshape(B, K, T), valid=valid,
                          num=valid.sum(1, dtype=torch.int32))


STAGES = (("normalize", normalize), ("trunk", trunk), ("rpn", rpn),
          ("select", select), ("k1", k1), ("k2", k2), ("recog", recog),
          ("heads", heads), ("decode", decode))


@torch.inference_mode()
def run_stages(model, raw, h, w, beam=0):
    """The stages chained on uint8 canvases `raw` (B, H, W, 3) and their
    f32 extents -> (the state, every stage's outputs; its "out" is what
    `forward_test_batch` returns on the normalized canvases)."""
    s = {"raw": raw, "h": h.float(), "w": w.float(), "beam": beam}
    for _, fn in STAGES:
        fn(model, s)
    return s


def make_inputs(B, H, W, content_w, dev, seed=1):
    """uint8 canvases from a seed and their true sizes (H x content_w)."""
    raw = np.random.RandomState(seed).randint(0, 256, (B, H, W, 3),
                                              dtype=np.uint8)
    return (torch.from_numpy(raw).to(dev),
            torch.full((B,), float(H), device=dev),
            torch.full((B,), float(content_w), device=dev))


def time_stage(fn, reps, iters, dev):
    per = [tc.ms_per_call(fn, reps, dev, warmup=1 if i == 0 else 0)
           for i in range(iters)]
    return tc.median(per) if dev.type == "cuda" else tc.NOT_MEASURED


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    tc.add_model_flags(ap)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--canvas_w", type=int, default=None,
                    help="canvas width (default the square)")
    ap.add_argument("--reps", type=int, default=10,
                    help="back-to-back calls per timing")
    ap.add_argument("--iters", type=int, default=3)
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    dev = tc.card(args.device)
    device = tc.print_device(dev)
    cfg = tc.model_config(args)
    model = to_torch(init_params(cfg, seed=0), cfg, dev)
    B, S = args.batch, cfg.image_size
    W = args.canvas_w or S
    raw, h, w = make_inputs(B, S, W, S * 0.75, dev)
    state = run_stages(model, raw, h, w)
    stages, counts = {}, {}
    with torch.inference_mode():
        for name, fn in STAGES:
            (ms, counts[name]) = tc.launches_of(lambda fn=fn: time_stage(
                lambda: fn(model, state), args.reps, args.iters, dev))
            stages[name] = ms
            print(f"{name:10s} " + (ms if isinstance(ms, str) else
                                    f"{ms:8.3f} ms/call "
                                    f"({ms / B:.3f} ms/image)"), flush=True)

        def whole():
            images = normalize_uint8_images(raw, h, w)
            return model.forward_test_batch(images, h, w)

        full, counts["forward"] = tc.launches_of(
            lambda: time_stage(whole, args.reps, args.iters, dev))
    total = (tc.NOT_MEASURED if dev.type != "cuda"
             else sum(stages.values()))
    print(f"sum of stages {total}; whole forward {full} (ms per call of "
          f"B={B})", flush=True)
    if dev.type == "cuda":
        for stage, kernel in (("k1", "nms"), ("k2", "roi_align"),
                              ("heads", "nms")):
            if not counts[stage][kernel]:
                raise SystemExit(f"{kernel} never launched in {stage}")
    return tc.emit({
        "check": "stage_profile_b8", "device": device, "batch": B,
        "canvas": [S, W], "stages_ms": stages,
        "sum_ms": total, "forward_ms": full,
        "decode_steps": decode_steps(state["out"].captions.cpu().numpy(),
                                     cfg.vocab_size + 1, cfg.seq_length),
        "launches": counts})


if __name__ == "__main__":
    main()
