"""Stage timing and device traces (twin of densecap_tpu/utils/profiling.py).

`StageTimer` is the JAX package's host-side stage breakdown, copied: call
`torch.cuda.synchronize()` inside a stage for device-true numbers.
`device_trace` is a `torch.profiler` window in place of `jax.profiler`:
it records CPU activity and, on a CUDA device, the card's kernels, and
writes a Chrome trace (chrome://tracing, Perfetto, TensorBoard).
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from collections import defaultdict

import torch


class StageTimer:
    def __init__(self, enabled=True):
        self.enabled = enabled
        self.times = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self):
        parts = []
        for name in sorted(self.times):
            avg = self.times[name] / max(self.counts[name], 1)
            parts.append(f"{name}: {1000 * avg:.1f}ms")
        return "timing[" + ", ".join(parts) + "]"

    def reset(self):
        self.times.clear()
        self.counts.clear()


@contextlib.contextmanager
def device_trace(logdir, cuda=None):
    """Trace the block with `torch.profiler` and write a Chrome trace,
    `<host>_<pid>.pt.trace.json`, into `logdir`. cuda: also record the
    card's activity (default: when a CUDA device is available). Yields
    the profiler, whose `key_averages()` sums the time by operator and
    kernel."""
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"{socket.gethostname()}_{os.getpid()}.pt.trace.json"))
