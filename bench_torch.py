"""Benchmark of the PyTorch port: flagship inference throughput at 1000
proposals per image on the H100.

Twin of bench.py on the port's entry point, `DenseCap.forward_test_batch`:
VGG-16 trunk -> RPN -> pre-NMS top 6000 -> K1 NMS to 1000 RoIs -> K2 RoI
align -> fc6/fc7 -> heads and the final K1 -> greedy LSTM decode, bf16,
vocab 10 000, B=8 canvases of the 720x544 bucket holding 720x540 content,
random weights from `init_params(cfg, seed=0)`. Random weights never
emit END, so the decode runs all 15 steps: the worst-case decode. A trained
model's checkpoint (`--checkpoint`, e.g. the `.npz` of
`scripts/torch_trained_weights_bench.py --save`) measures the early exit.

Two input batches alternate over 24 timed calls, each call's checksum (the
sum of boxes, scores, captions and counts, a scalar on the card) read back
once `depth` later calls have been issued, as bench.py's loop does. The
greedy decode reads the host once a step, so a call cannot stay in flight
behind another and the depth changes little: the loop keeps bench.py's
shape and reports what it measures.

    python bench_torch.py [--checkpoint ck.npz] [--iters 24] [--depth 2]
        [--device cuda|cpu]

Prints the card's name and power limit, then ONE JSON line:
{"metric", "value", "unit", "vs_baseline", ...}, vs_baseline against the
reference's best published single-GPU figure, 10 FPS at 50 proposals and
480 px. On the CPU the value reads "not measured".
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
import sys

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "scripts"))

import torch_tool_common as tc  # noqa: E402
from densecap_tpu_torch.utils.checkpoint import (  # noqa: E402
    init_params, load_checkpoint, to_torch)

METRIC = "torch_inference_images_per_sec_1000_proposals"
BASELINE_FPS = 10.0  # the reference's single-machine demo (50 proposals!)


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    tc.add_model_flags(ap)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--canvas_w", type=int, default=544,
                    help="canvas width (the 720x544 bucket)")
    ap.add_argument("--iters", type=int, default=24)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--checkpoint", default="",
                    help="trained weights (a port .npz); default random "
                         "weights from seed 0")
    return ap


def load_model(args, dev):
    """(model, weights label): the checkpoint's weights under its config
    with this run's proposals and dtype, or random ones from seed 0."""
    cfg = tc.model_config(args)
    if args.checkpoint:
        params, _, ck_cfg = load_checkpoint(args.checkpoint)
        cfg = ck_cfg.replace(test_max_proposals=args.proposals,
                             compute_dtype=cfg.compute_dtype)
        return to_torch(params, cfg, dev), f"checkpoint {args.checkpoint}"
    return (to_torch(init_params(cfg, seed=0), cfg, dev),
            "random, seed 0 (worst-case decode)")


def make_inputs(args, image_size, dev):
    """Two alternating batches (2, B, S, canvas_w, 3) from seed 1 and the
    true extents of every image: S x 0.75 S (720x540 content)."""
    S, B = image_size, args.batch
    content_w = S * 0.75
    batches = torch.from_numpy(tc.random_canvases(
        (2, B, S, args.canvas_w, 3), 1)).to(dev)
    hs = torch.full((B,), float(S), device=dev)
    ws = torch.full((B,), float(content_w), device=dev)
    return batches, hs, ws


def checksum(out):
    """The scalar each call returns: boxes + scores + captions + num."""
    return (out.boxes.float().sum() + out.scores.float().sum()
            + out.captions.sum() + out.num.sum())


def run(model, batches, hs, ws, iters, depth, dev):
    """bench.py's loop: `iters` calls over the two batches in turns, a
    call's checksum read once `depth` later calls were issued. -> seconds
    (host clock; the card synchronised at the end)."""
    futures = []
    tc.sync(dev)
    t0 = time.perf_counter()
    for i in range(iters):
        futures.append(checksum(model.forward_test_batch(
            batches[i % 2], hs, ws)))
        if len(futures) > depth:
            float(futures.pop(0))
    for f in futures:
        float(f)
    tc.sync(dev)
    return time.perf_counter() - t0


def main(argv=None):
    args = build_argparser().parse_args(argv)
    dev = tc.card(args.device)
    device = tc.print_device(dev)
    model, weights = load_model(args, dev)
    S = model.cfg.image_size
    batches, hs, ws = make_inputs(args, S, dev)
    for i in range(2):  # warm-up: both batches
        float(checksum(model.forward_test_batch(batches[i], hs, ws)))
    (dt, counts) = tc.launches_of(
        lambda: run(model, batches, hs, ws, args.iters, args.depth, dev))
    if dev.type == "cuda" and not (counts["nms"] and counts["roi_align"]):
        raise SystemExit(f"K1 or K2 never launched: {counts}")
    ips = tc.measured(args.iters * args.batch / dt, dev)
    return tc.emit({
        "metric": METRIC, "value": ips, "unit": "images/sec",
        "vs_baseline": (ips if isinstance(ips, str) else ips / BASELINE_FPS),
        "device": device, "weights": weights, "batch": args.batch,
        "canvas": [S, args.canvas_w], "iters": args.iters,
        "depth": args.depth,
        "ms_per_call": tc.measured(dt * 1e3 / args.iters, dev),
        "launches": counts})


if __name__ == "__main__":
    main()
