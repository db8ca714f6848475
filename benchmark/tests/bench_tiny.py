"""Small runs of the harness on the CPU for the benchmark's tests: the
cells' files at the published widths (VGG-16, fc 4096, LSTM 512, vocab
10 000, so that the numbers compared have their full-size scale) on
224 px images with few proposals, RoIs and boxes; the program in f32,
where it agrees with the reference to rounding."""

from __future__ import annotations

import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from benchlib import harness, spec  # noqa: E402


def tiny(name, precision="float32"):
    """(bench, workload, cfg) of cell `name` at a tiny size."""
    bench = spec.benchmark()
    wl = spec.workload_file(name)
    cfg = spec.load_json(BENCH / "configs" / f"{wl['config']}.json")
    cfg.update(test_pre_nms_topk=300, compute_dtype=precision, image_size=224,
               sampler_batch_size=16, max_gt_boxes=8)
    if "inputs" in wl:
        cfg.update(test_max_proposals=30)
        wl["inputs"].update(batch=2, canvas=[224, 176], content=[224, 168])
    if "batch" in wl:
        wl["batch"].update(size=2, canvas=224, gt_min=2, gt_max=6, pool=4)
    return bench, wl, cfg


def run_tiny(name, seconds=1.0, trace=0, seed=2**31 + 12345, **kw):
    bench, wl, cfg = tiny(name, **kw)
    run = harness.Run(name, seed, seconds, trace, time.perf_counter(),
                      device="cpu", bench=bench, workload=wl, cfg=cfg)
    return harness.execute(run, chips_checked=False, modules_checked=False)
