"""What the per-layer metric readers share (`metrics/<name>.py`). Each
reader returns None where its run has nothing to read."""

from __future__ import annotations

import statistics

from . import flops, roofline
from .trace import kernel_stats


def mean_span_ms(run, key):
    ms = run.spans.get(key)
    return statistics.fmean(ms) if ms else None


def idle_pct(run):
    t = run.trace
    if not t or not t["window_s"] or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def kernel_roofline_pct(run, needle, least_ms):
    """least_ms over the kernel's mean time in the trace, in %."""
    if not run.trace:
        return None
    n, secs = kernel_stats(run.trace["ops"], needle)
    if not n:
        return None
    return 100.0 * least_ms / (secs / n * 1e3)


def mfu_pct(run, total_flops):
    if not run.trace or not total_flops:
        return None
    return (100.0 * total_flops / run.trace["window_s"]
            / roofline.PEAKS["bf16_flops"])


def infer_flops(run):
    """The forward's FLOPs over the traced window's calls, each at the
    decode steps its captions took."""
    w, cfg = run.workload["inputs"], run.cfg
    H, W = w["canvas"]
    return sum(flops.inference_flops(cfg, int(w["batch"]), H, W, s)["total"]
               for s in run.counters.get("decode_steps", []))
