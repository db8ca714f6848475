"""Device time of the port's B=8 flagship inference, stage by stage.

Twin of scripts/stage_profile_b8.py and, with `--batch 1`, of
scripts/profile_inference.py's single-image case. The stages are the
program's own spans (`utils/profiling.py`): the tool runs
`normalize_uint8_images` in a span of its own, `normalize`, then
`forward_test_batch`, `--reps` x `--iters` times after one unrecorded
call, with the spans recording, and prints each span the program opened,
indented under its parent, in the order it opened them:

  normalize       uint8 canvases -> f32, mean subtracted, zero past the
                  frame (the tool's span)
  infer.forward   the whole forward, and under it
    trunk         VGG-16 (`DenseCap.features`)
    localize      `localize_test`: `rpn` (the RPN conv and heads),
                  `proposals` (clip, softmax, the pre-NMS top-k sort and
                  the RPN's NMS, kernel K1), `roi_align` (kernel K2)
    recog         fc6 / fc7, the objectness and box heads
    final_nms     the final clip and NMS (K1)
    decode        the greedy LSTM decode, with its counters

Each row: the mean device ms and host ms a span (`SpanStore.summary`);
under the table, the sum of the root's children against the root. A span
the program gains shows here without an edit.

    python scripts/torch_stage_profile_b8.py [--batch 8] [--reps 10]
        [--device cuda|cpu]

Defaults: bench's program (vocab 10 000, 1000 proposals, bf16, random
weights from seed 0, so the decode runs all 15 steps) on the 720 px square
canvas with 720x540 content, as the JAX script runs it. Last line: one
JSON object with the span table, and the card's name and power limit.
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
from densecap_tpu_torch.utils import profiling  # noqa: E402
from densecap_tpu_torch.utils.checkpoint import (  # noqa: E402
    init_params, to_torch)
from densecap_tpu_torch.utils.image import normalize_uint8_images  # noqa: E402

ROOT = "infer.forward"


def make_inputs(B, H, W, content_w, dev, seed=1):
    """uint8 canvases from a seed and their true sizes (H x content_w)."""
    raw = np.random.RandomState(seed).randint(0, 256, (B, H, W, 3),
                                              dtype=np.uint8)
    return (torch.from_numpy(raw).to(dev),
            torch.full((B,), float(H), device=dev),
            torch.full((B,), float(content_w), device=dev))


def profile(model, raw, h, w, calls):
    """`calls` recorded calls of normalize + `forward_test_batch` after
    an unrecorded one -> (the last output, the span rows, launches)."""
    def forward():
        with profiling.span("normalize", raw.device):
            images = normalize_uint8_images(raw, h, w)
        return model.forward_test_batch(images, h, w)

    def run():
        for _ in range(calls):
            out = forward()
        return out

    forward()
    tc.sync(raw.device)
    return tc.recorded(run)


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    tc.add_model_flags(ap)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--canvas_w", type=int, default=None,
                    help="canvas width (default the square)")
    ap.add_argument("--reps", type=int, default=10,
                    help="recorded calls per iteration")
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
    calls = args.reps * args.iters
    out, rows, counts = profile(model, raw, h, w, calls)
    table = tc.print_span_rows(rows, dev)
    root = next(r for r in rows if r["key"] == ROOT)
    if dev.type == "cuda":
        for kernel, per_call in (("nms", 2), ("roi_align", 1)):
            if counts[kernel] != per_call * calls:
                raise SystemExit(f"{kernel} launched {counts[kernel]} times "
                                 f"in {calls} calls, not {per_call} a call")
    return tc.emit({
        "check": "stage_profile_b8", "device": device, "batch": B,
        "canvas": [S, W], "calls": calls, "stages_ms": table,
        "sum_ms": tc.measured(tc.children_sum(rows, ROOT)["device_ms"], dev),
        "forward_ms": tc.measured(root["device_ms"], dev),
        "decode_steps": decode_steps(out.captions.cpu().numpy(),
                                     cfg.vocab_size + 1, cfg.seq_length),
        "launches": counts})


if __name__ == "__main__":
    main()
