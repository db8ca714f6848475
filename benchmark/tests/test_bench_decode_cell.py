"""K5's two readers: `decode_cell_roofline` puts the least time of the
cell's LSTM step (operations-bound, 0.0339 ms at P = 8000, E = H = 512)
over `lstm_cell_kernel`'s mean time in the trace, and
`infer.decode_cell_steps` reads the `decode` span's counter; both give
None where the program has no K5 (the parent, the CPU)."""

from __future__ import annotations

import json
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

from benchlib import spec

BENCH = Path(__file__).resolve().parents[1]
CFG = json.loads((BENCH / "configs" /
                  "densecap_vgg16_720_p1000.json").read_text())
ROOFLINE = spec.metric_reader("decode_cell_roofline")
STEPS = spec.metric_reader("infer.decode_cell_steps")


def _run(ops=None, window=(None, None)):
    return SimpleNamespace(
        cfg=CFG, workload={"inputs": {"batch": 8}},
        trace=None if ops is None else {"ops": ops},
        window_start=window[0], window_s=window[1])


def test_least_time_of_the_cell():
    least, by = ROOFLINE.least_ms(8000, 512, 512)
    assert by == "operations"
    assert least == pytest.approx(2 * 8000 * 1024 * 2048 / 989e12 * 1e3)
    assert least == pytest.approx(0.03393, abs=1e-5)
    # bytes: x, h, c in and h, c out in f32, W in bf16, b in f32
    nbytes = 8000 * 512 * 4 * 5 + 1024 * 2048 * 2 + 2048 * 4
    assert ROOFLINE.least_ms(1, 512, 512)[1] == "bytes"
    assert ROOFLINE.least_ms(8000, 512, 512)[0] > nbytes / 3.35e12 * 1e3


def test_roofline_reads_the_kernel():
    name = "void (anonymous namespace)::lstm_cell_kernel(CUtensorMap_st, ...)"
    ops = {name: [16, 16 * 0.08e-3], "greedy_head_kernel<2>": [15, 1e-3]}
    least, _ = ROOFLINE.least_ms(8000, 512, 512)
    assert ROOFLINE.read(_run(ops)) == pytest.approx(100 * least / 0.08)
    assert ROOFLINE.read(_run({"greedy_head_kernel<2>": [15, 1e-3]})) is None
    assert ROOFLINE.read(_run()) is None


def test_steps_read_the_counter(monkeypatch):
    from densecap_tpu_torch.utils import profiling as prof

    store = prof.SpanStore()
    monkeypatch.setattr(prof, "STORE", store)
    t0 = time.perf_counter()
    was = prof.set_recording(True)
    try:
        for steps in (16, 16, 13):
            with prof.span("decode"):
                prof.count("decode.cell_steps", steps)
        with prof.span("decode"):  # a decode off K5: counts none
            pass
    finally:
        prof.set_recording(was)
    window = (t0, time.perf_counter() - t0 + 1.0)
    assert STEPS.read(_run(window=window)) == pytest.approx(45 / 4)
    assert STEPS.read(_run()) is None
    monkeypatch.setattr(prof, "STORE", prof.SpanStore())
    assert STEPS.read(_run(window=window)) is None
