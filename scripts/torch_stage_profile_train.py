"""Device time of the port's B=8 flagship train step, stage by stage.

Twin of scripts/stage_profile_train.py. The stages are the program's own
spans (`utils/profiling.py`): the tool runs `Trainer.step` `--reps` x
`--iters` times after one unrecorded step, with the spans recording, and
prints each span the step opened, indented under its parent, in the
order it opened them:

  train.step          the whole step, and under it
    train.forward     `batched_loss`: `trunk` (frozen: no gradient),
                      `localize` (`rpn`, `sampler`, `roi_align`: kernel
                      K2), `recog` (fc6 / fc7 with dropout, the heads and
                      their losses), `lm.train` (the teacher-forced LSTM)
    train.backward    the backward (K2b for the RoI positions)
    train.optimizer   weight decay and Adam over the f32 masters

Each row: the mean device ms and host ms a span (`SpanStore.summary`);
under the table, the sum of the root's children against the root. A span
the program gains shows here without an edit. The kernels alone are
timed in chip_smoke.py's kernel phases.

Defaults: the frozen step at B=8 on the 720 px square with 720x540
content, vocab 10 000, sampler 256, 128 gt slots (20 valid), bf16,
`fuse_conv_pool` on (K3 in trunk1, as chip_smoke.py trains), random
weights from seed 0.

    python scripts/torch_stage_profile_train.py [--reps 10]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_tool_common as tc  # noqa: E402
from densecap_tpu_torch.parallel.train_step import Trainer  # noqa: E402
from densecap_tpu_torch.utils.checkpoint import (  # noqa: E402
    init_params, to_torch)

ROOT = "train.step"


def profile(trainer, batch, gen, calls):
    """`calls` recorded `Trainer.step`s after an unrecorded one -> (the
    last step's losses, the span rows, launches)."""
    def run():
        for _ in range(calls):
            out = trainer.step(batch, generator=gen)
        return out

    trainer.step(batch, generator=gen)
    tc.sync(batch["image"].device)
    return tc.recorded(run)


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    tc.add_model_flags(ap)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--sampler_batch_size", type=int, default=256)
    ap.add_argument("--max_gt_boxes", type=int, default=128)
    ap.add_argument("--reps", type=int, default=10,
                    help="recorded steps per iteration")
    ap.add_argument("--iters", type=int, default=3)
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    dev = tc.card(args.device)
    device = tc.print_device(dev)
    cfg = tc.model_config(args, sampler_batch_size=args.sampler_batch_size,
                          max_gt_boxes=args.max_gt_boxes,
                          fuse_conv_pool=True)
    model = to_torch(init_params(cfg, seed=0), cfg, dev, train=True)
    trainer = Trainer(model, learning_rate=1e-5)
    B, S = args.batch, cfg.image_size
    batch = tc.train_batch(model.cfg, B, S, S, S * 0.75, dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    calls = args.reps * args.iters
    _, rows, counts = profile(trainer, batch, gen, calls)
    table = tc.print_span_rows(rows, dev)
    root = next(r for r in rows if r["key"] == ROOT)
    if dev.type == "cuda":
        # K2b for the positions in every step, K3 for trunk1's two pools
        for kernel, per_step in (("roi_align", 1), ("roi_align_bwd", 1),
                                 ("conv_pool", 2)):
            if counts[kernel] != per_step * calls:
                raise SystemExit(f"{kernel} launched {counts[kernel]} times "
                                 f"in {calls} steps, not {per_step} a step")
    return tc.emit({
        "check": "stage_profile_train", "device": device, "batch": B,
        "canvas": [S, S], "calls": calls, "stages_ms": table,
        "sum_ms": tc.measured(tc.children_sum(rows, ROOT)["device_ms"], dev),
        "step_ms": tc.measured(root["device_ms"], dev), "launches": counts})


if __name__ == "__main__":
    main()
