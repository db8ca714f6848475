"""What the drivers share to build the program under test, the port
(`densecap_tpu_torch`), and to record spans around its calls from
outside, without editing it."""

from __future__ import annotations

import dataclasses
import time

import torch

from .weights import Weights

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def program_config(cfg):
    """The port's DenseCapConfig from a configuration file's dict."""
    from densecap_tpu_torch.config import DenseCapConfig

    names = {f.name for f in dataclasses.fields(DenseCapConfig)}
    kw = {k: v for k, v in cfg.items() if k in names}
    kw["compute_dtype"] = DTYPES[cfg["compute_dtype"]]
    return DenseCapConfig(**kw)


def weights_numpy(cfg, seed, device):
    """The seed's weight tree (made on the device) as the numpy tree the
    port's weight bridge takes."""
    w = Weights(cfg, seed, device)
    tree = w.tree_numpy()
    del w
    return tree


class CudaSpans:
    """CUDA events around calls, read once the device is synchronized (on
    a machine without CUDA, the host clock: the CPU tests' runs)."""

    def __init__(self):
        self.events = []
        self.cuda = torch.cuda.is_available()

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def wrap(self, fn):
        def wrapped(*a, **kw):
            start = self.mark()
            out = fn(*a, **kw)
            self.events.append((start, self.mark()))
            return out
        return wrapped

    def ms(self):
        if not self.cuda:
            return [(e - s) * 1e3 for s, e in self.events]
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]
