"""Serving modes of the port on the card: full-program throughput for each
serving knob, and the demo setting's single-image latency.

Twin of scripts/serving_modes_bench.py, on `forward_test_batch` with
random weights from seed 0 (vocab 10 000, bf16; the decode's worst case):

  * flagship at B=8 on the 720x544 bucket with 720x540 content, 1000
    proposals, at `test_pre_nms_topk` 6000 (the default), 2000 and -1
    (every anchor into K1: 18 360 boxes an image on this canvas);
  * the webcam setting (480 px, 50 proposals, the reference demo's) at
    B=8: images/s;
  * the webcam setting at batch 1, each call synchronised (what a live
    client feels): p50 and p99 over `--single_iters` calls.

Throughput rows run bench_torch.py's loop (`--iters` calls over two
batches, depth 2, after `--warmup` calls), host clock. Latency: host clock
around each call and the card's synchronisation.

    python scripts/torch_serving_modes_bench.py [--iters 24]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_tool_common as tc  # noqa: E402
import bench_torch  # noqa: E402
from densecap_tpu_torch.utils.checkpoint import (  # noqa: E402
    init_params, to_torch)


def pipeline(model, B, S, W, content_w, iters, warmup, dev):
    """ms per call of bench_torch's loop at depth 2, and the launches."""
    batches = torch.from_numpy(tc.random_canvases((2, B, S, W, 3), 1)).to(dev)
    hs = torch.full((B,), float(S), device=dev)
    ws = torch.full((B,), float(content_w), device=dev)
    for i in range(warmup):
        float(bench_torch.checksum(model.forward_test_batch(
            batches[i % 2], hs, ws)))
    dt, counts = tc.launches_of(
        lambda: bench_torch.run(model, batches, hs, ws, iters, 2, dev))
    return tc.measured(dt / iters * 1e3, dev), counts


def latency(model, S, iters, dev):
    """Host ms of each synchronised single-image call (seed 2)."""
    im = torch.from_numpy(tc.random_canvases((1, S, S, 3), 2)).to(dev)
    h = torch.full((1,), float(S), device=dev)
    for _ in range(2):
        model.forward_test_batch(im, h, h)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = model.forward_test_batch(im, h, h)
        float(out.boxes.float().sum() + out.scores.float().sum())
        tc.sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def row(tag, ms, B, counts, dev):
    r = {"ms_per_call": ms, "images_per_s": tc.rate(B, ms),
         "launches": counts}
    print(f"{tag}: " + (ms if isinstance(ms, str) else
                        f"{ms:.2f} ms/step {r['images_per_s']:.1f} img/s")
          + f"; launches {counts}", flush=True)
    if dev.type == "cuda" and not (counts["nms"] and counts["roi_align"]):
        raise SystemExit(f"{tag}: K1 or K2 never launched")
    return r


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    tc.add_model_flags(ap)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--canvas_w", type=int, default=544)
    ap.add_argument("--topks", default="6000,2000,-1")
    ap.add_argument("--webcam_size", type=int, default=480)
    ap.add_argument("--webcam_proposals", type=int, default=50)
    ap.add_argument("--iters", type=int, default=24)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--single_iters", type=int, default=20)
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    dev = tc.card(args.device)
    device = tc.print_device(dev)
    cfg = tc.model_config(args)
    # the weights do not depend on the canvas, the proposals or the top-k
    model = to_torch(init_params(cfg, seed=0), cfg, dev)
    B, S = args.batch, cfg.image_size
    res = {}
    for topk in (int(k) for k in args.topks.split(",")):
        model.cfg = cfg.replace(test_pre_nms_topk=topk)
        ms, counts = pipeline(model, B, S, args.canvas_w, S * 0.75,
                              args.iters, args.warmup, dev)
        res[f"flagship_topk_{topk}"] = row(
            f"flagship topk={topk} B={B} {S}x{args.canvas_w}", ms, B,
            counts, dev)
    ws = args.webcam_size
    model.cfg = cfg.replace(image_size=ws,
                            test_max_proposals=args.webcam_proposals)
    ms, counts = pipeline(model, B, ws, ws, ws, args.iters, args.warmup, dev)
    res["webcam_batch"] = row(
        f"webcam {ws}px/{args.webcam_proposals} props B={B}", ms, B, counts,
        dev)
    times = latency(model, ws, args.single_iters, dev)
    res["webcam_single"] = {
        "p50_ms": tc.measured(float(np.percentile(times, 50)), dev),
        "p99_ms": tc.measured(float(np.percentile(times, 99)), dev),
        "calls": args.single_iters}
    print(f"webcam single-image synced: {res['webcam_single']}", flush=True)
    return tc.emit({"check": "serving_modes_bench", "device": device,
                    "batch": B, **res})


if __name__ == "__main__":
    main()
