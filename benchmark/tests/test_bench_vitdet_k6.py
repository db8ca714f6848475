"""`vitdet.attn_k6_blocks` reads the `vit.attn.k6` counter of the two
attention spans, per `trunk` span: the ViTDet-B call's 12 cores where
each ran as K6; None for a program without the counter (the parent, the
CPU) or without spans in the window."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest

from benchlib import spec

BLOCKS = spec.metric_reader("vitdet.attn_k6_blocks")


def _run(window=(None, None)):
    return SimpleNamespace(window_start=window[0], window_s=window[1])


def _call(prof, k6=True, globals_=4, windows=8):
    with prof.span("trunk"):
        for name, n in (("vit.attn.global", globals_),
                        ("vit.attn.window", windows)):
            for _ in range(n):
                with prof.span(name):
                    if k6:
                        prof.count("vit.attn.k6")


@pytest.fixture
def prof(monkeypatch):
    from densecap_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "STORE", profiling.SpanStore())
    was = profiling.set_recording(True)
    yield profiling
    profiling.set_recording(was)


def _window(t0):
    return (t0, time.perf_counter() - t0 + 1.0)


def test_a_call_through_k6_reads_its_twelve_cores(prof):
    t0 = time.perf_counter()
    for _ in range(3):
        _call(prof)
    assert BLOCKS.read(_run(_window(t0))) == pytest.approx(12.0)


def test_calls_off_k6_count_none_of_their_cores(prof):
    t0 = time.perf_counter()
    _call(prof)
    _call(prof, k6=False)
    assert BLOCKS.read(_run(_window(t0))) == pytest.approx(6.0)


def test_without_the_counter_or_the_window_it_reads_none(prof):
    t0 = time.perf_counter()
    _call(prof, k6=False)
    assert BLOCKS.read(_run(_window(t0))) is None
    assert BLOCKS.read(_run()) is None
