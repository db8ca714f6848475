"""The reader of `grit.graph_steps` on the CPU: None with no window, and
with decode spans that count no graph step (the eager steps of a program
that has no graph path, or of the CPU); where the spans count graph
steps, their mean a span."""

from __future__ import annotations

import time

import bench_tiny
from benchlib import harness, spec

CELL = "infer_grit_b8_1024_p1000"
SEED = 2**31 + 12345


def tiny_run():
    bench, wl, cfg = bench_tiny.tiny(CELL)
    return harness.Run(CELL, SEED, 1.0, 0, time.perf_counter(),
                       device="cpu", bench=bench, workload=wl, cfg=cfg)


def window(graph_steps):
    """A run whose window holds one `textdec.decode` span of 15 steps
    for each entry of `graph_steps`, counting that many graph steps."""
    from densecap_tpu_torch.utils import profiling

    run = tiny_run()
    run.window_start = time.perf_counter()
    was = profiling.set_recording(True)
    try:
        for n in graph_steps:
            with profiling.span("textdec.decode"):
                profiling.count("textdec.steps", 15)
                if n:
                    profiling.count("textdec.graph_steps", n)
    finally:
        profiling.set_recording(was)
    run.window_s = time.perf_counter() - run.window_start
    return run


def test_graph_steps_reads_the_decode_spans_counter():
    reader = spec.metric_reader("grit.graph_steps")
    assert reader.read(tiny_run()) is None
    assert reader.read(window([0, 0])) is None
    assert reader.read(window([15, 13])) == 14.0
