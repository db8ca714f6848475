"""Time K2b, the RoI-align backward, alone on the card at the training
shape, in the checkout given by --repo (default: this one).

    python scripts/torch_k2b_alone.py [--repo DIR]

Builds DIR's kernel library and times K2b's launches alone on the inputs
of chip_smoke.py's K2b phase (8 x 384 boxes on (8, 45, 45, 512) f32,
seed 6), prepared by DIR's `roi_align.prepare_cuda`: 20 calls captured in
a CUDA graph, median of 10 replays, in both modes (the positions alone,
as while the trunk is frozen, and with d feats). A library with
`dc_roi_align_bwd` is timed through that one launch; an older one with
`dc_roi_align_bwd_coords` and `dc_roi_align_bwd_feats` (two launches)
through those. Prints one JSON line. Compare two checkouts in one call,
in turns: parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
# chip_smoke.py's K2 / K2b image sizes on the 720 px canvas, and B
IMG_H = (720, 540, 720, 480, 700, 720, 360, 720)
IMG_W = (540, 720, 720, 720, 500, 333, 720, 96)
B, K, C = 8, 384, 512


def k2b_inputs(torch, feat_extent, dev):
    """chip_smoke.py phase_roi_bwd's inputs: feats, boxes, img_h, img_w,
    fh, fw and the upstream gradient."""
    rng = np.random.default_rng(6)
    feats = torch.from_numpy(
        rng.standard_normal((B, 45, 45, C), dtype=np.float32)).to(dev)
    img_h = torch.tensor(IMG_H, dtype=torch.float32, device=dev)
    img_w = torch.tensor(IMG_W, dtype=torch.float32, device=dev)
    fh, fw = feat_extent(img_h, img_w)
    xy = rng.uniform(0, 720.0, (B, K, 2))
    wh = rng.uniform(8, 300, (B, K, 2)) * 1.5
    boxes = torch.from_numpy(
        np.concatenate([xy, wh], -1).astype(np.float32)).to(dev)
    gout = torch.from_numpy(
        rng.standard_normal((B, K, 7, 7, C), dtype=np.float32)).to(dev)
    return feats, boxes, img_h, img_w, fh, fw, gout


def graph_ms(torch, fn, reps=20, runs=10):
    """Median ms of one fn() alone: reps calls in a CUDA graph, replayed
    between two CUDA events (as chip_smoke.py's graph_ms)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=str(ROOT),
                    help="checkout whose densecap_tpu_torch is timed")
    args = ap.parse_args(argv)
    repo = Path(args.repo).resolve()
    sys.path.insert(0, str(repo))
    import torch

    from densecap_tpu_torch.models.vgg16 import feat_extent
    from densecap_tpu_torch.ops import roi_align as roi_mod
    from densecap_tpu_torch.ops.cuda import build

    if not torch.cuda.is_available():
        raise SystemExit("torch_k2b_alone: no CUDA device")
    dev = torch.device("cuda", 0)
    feats, boxes, img_h, img_w, fh, fw, gout = k2b_inputs(
        torch, feat_extent, dev)
    yf, xf, ii, fhh, fww = roi_mod.prepare_cuda(feats, boxes, img_h, img_w,
                                                fh, fw)
    g = gout.reshape(B * K, 7, 7, C)
    d_yf, d_xf = torch.empty_like(yf), torch.empty_like(xf)
    d_xf_rows = torch.empty((B * K, 7, 7), device=dev)
    d_feats = torch.zeros_like(feats)
    lib = build.load()
    fused = hasattr(lib, "dc_roi_align_bwd")

    def run(with_feats):
        if fused:
            roi_mod.launch_bwd(g, feats, yf, xf, ii, fhh, fww, d_yf,
                               d_xf_rows, d_feats if with_feats else None)
            return
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = (yf.data_ptr(), xf.data_ptr(), ii.data_ptr(), fhh.data_ptr(),
                fww.data_ptr(), B * K, 45, 45, C, 7, 7)
        if with_feats:
            build.check(lib.dc_roi_align_bwd_feats(
                g.data_ptr(), *ptrs, d_feats.data_ptr(), stream),
                "roi_align_bwd_feats")
        build.check(lib.dc_roi_align_bwd_coords(
            g.data_ptr(), feats.data_ptr(), *ptrs, d_yf.data_ptr(),
            d_xf.data_ptr(), stream), "roi_align_bwd")

    ms = {mode: graph_ms(torch, lambda: run(mode == "d_feats"))
          for mode in ("frozen", "d_feats")}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"repo": str(repo),
                      "form": "one launch" if fused else "two launches",
                      "kernel_ms": ms, "device": smi}))


if __name__ == "__main__":
    main()
