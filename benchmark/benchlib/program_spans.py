"""The program's own spans and counters, read for the traced window.

The port records them (`densecap_tpu_torch.utils.profiling.STORE`) while
a `torch.profiler` session is on, as it is through a traced run's window.
Each reading is a mean per span over the spans that started and ended
inside the window: device ms (the stream from the span's start marker to
its end marker), host ms, or a counter of the span. A program that keeps
no such store, or no such span, gives None.
"""

from __future__ import annotations


def store():
    """The program's store of spans, or None."""
    try:
        from densecap_tpu_torch.utils import profiling
    except ImportError:
        return None
    st = getattr(profiling, "STORE", None)
    return st if callable(getattr(st, "summary", None)) else None


def window_summary(run, name):
    """The store's summary of span `name` over the window, or None."""
    st = store()
    if st is None or run.window_start is None or run.window_s is None:
        return None
    start = int(run.window_start * 1e9)
    end = int((run.window_start + run.window_s) * 1e9)
    s = st.summary(name, start_ns=start, end_ns=end)
    return s if s and s.get("count") else None


def device_ms(run, name):
    s = window_summary(run, name)
    return None if s is None else s["device_ms"]


def host_ms(run, name):
    s = window_summary(run, name)
    return None if s is None else s["host_ms"]


def counter(run, name, key, field):
    """The mean per span `name` of counter `key`'s `field` ("n", or
    "host_ms": the host time of the reads it counts)."""
    s = window_summary(run, name)
    if s is None:
        return None
    return float(s["counters"].get(key, {}).get(field, 0.0))
