"""The traced run's device trace: `torch.profiler` with CPU and CUDA
activity around the measured window, written as a Chrome trace at a fixed
path in the checkout, then reduced here to what the metric readers and
the result line take:

  * busy_s: the union of the intervals in which a kernel, copy or memset
    ran on the device;
  * window_s: the traced window's length (host clock);
  * ops: {device op name: [launches, seconds]};
  * breakdown: the 10 device ops that took most time, and the 10 largest
    sums of idle time by what the host was doing in the middle of each
    idle gap (the innermost CPU op or CUDA runtime call under way then).
"""

from __future__ import annotations

import bisect
import json
import os
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
SHORT_GAP_US = 10.0


class DeviceTrace:
    """Context manager: profile the block, then `reduce()` the trace."""

    def __init__(self, path):
        self.path = path
        self.window_s = None
        self.prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        kw = {}
        try:  # calls the program makes from threads of its own count too
            from torch._C._profiler import _ExperimentalConfig

            kw["experimental_config"] = _ExperimentalConfig(
                profile_all_threads=True)
        except (ImportError, TypeError):
            pass
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA], **kw)
        self.prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self.prof.__exit__(*exc)
        if exc[0] is None:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            self.prof.export_chrome_trace(self.path)
        self.prof = None
        return False

    def reduce(self):
        with open(self.path) as f:
            events = json.load(f)["traceEvents"]
        os.remove(self.path)
        out = reduce_events(events)
        out["window_s"] = self.window_s
        return out


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def reduce_events(events):
    """Chrome trace events -> {"busy_s", "ops", "breakdown"} (times in
    seconds; the trace's are in microseconds)."""
    dev, host = [], []
    ops = defaultdict(lambda: [0, 0.0])
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur))
            rec = ops[ev["name"]]
            rec[0] += 1
            rec[1] += dur * 1e-6
        elif cat in HOST_CATS:
            host.append((ts, ts + dur, ev["name"]))
    merged = _merge(dev)
    busy_us = sum(e - s for s, e in merged)
    host.sort()
    starts = [h[0] for h in host]
    idle = defaultdict(float)
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        gap = s1 - e0
        if gap < SHORT_GAP_US:
            idle[f"gaps under {SHORT_GAP_US:g} us"] += gap * 1e-6
            continue
        idle[_host_label(host, starts, (e0 + s1) / 2)] += gap * 1e-6
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1][1])[:10]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_us * 1e-6, "ops": {k: v for k, v in ops.items()},
            "breakdown": {"device_ops": [[k, v[1]] for k, v in top_ops],
                          "idle_gaps": [[k, v] for k, v in top_idle]}}


def _host_label(host, starts, t, scan=64):
    """The innermost host event under way at time t: the latest-starting
    one among the `scan` before t that still covers it."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 1 - scan), -1):
        s, e, name = host[j]
        if e >= t:
            return name
    return "no host op under way"


def kernel_stats(ops, needle):
    """(launches, seconds) summed over the device ops whose name holds
    `needle`."""
    n, s = 0, 0.0
    for name, (count, secs) in ops.items():
        if needle in name:
            n += count
            s += secs
    return n, s
