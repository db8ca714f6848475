"""Spans and counters inside the program, stage timing and device traces
(twin of densecap_tpu/utils/profiling.py, whose `StageTimer` report and
`device_trace` this module keeps).

Spans. `span(name, device=None)` marks a stage of the program:

    with span("trunk"):
        ...

It records only while a `torch.profiler` session is active, or while
`set_recording(True)` holds (the train CLI's `--timing 1`). Otherwise it
returns a shared object that does nothing, after one check; `count` and
`host_read` then do no more than their plain work. An active span:

  * enters `torch.profiler.record_function(name)` under the profiler, so
    it lands in the Chrome trace as a `user_annotation`, on the
    profiler's clock;
  * keeps its host start and end (`time.perf_counter_ns`);
  * on a CUDA device (its own `device`, else its parent's), records a
    timing event pair on the device's current stream. Its device time runs
    from the stream reaching the start marker to it reaching the end
    marker, idle gaps inside included; it is resolved once the end marker
    has been reached (`SpanStore.resolve`), and a span never synchronizes
    to get it. Off CUDA the device time is the host time;
  * knows its parent, the innermost span open on its thread, and its
    call: a span opened under no other (`infer.forward`, `train.step`)
    starts a call with the next sequence number, and the spans under it
    share that number.

Finished spans go to `STORE`, a ring of `STORE_CAPACITY` records that
counts the records it drops; `SpanStore.summary` gives, per name (and
parent), the count and the mean host and device ms. The profiler's
Chrome trace (`device_trace`) is the one exporter.

`count(name, n)` adds n to the counter `name` of the innermost open span,
and `host_read(name, x)` is `bool(x)` counted so, with the host time it
blocked for.

`StageTimer` keeps the JAX twin's report, as a view over spans: each
stage's time is its spans' device time.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import socket
import threading
import time
from collections import defaultdict, deque

import torch

STORE_CAPACITY = 1 << 16

_forced = False
_now = time.perf_counter_ns
_autograd_profiler = torch.autograd.profiler
if hasattr(_autograd_profiler, "_is_profiler_enabled"):
    def _profiler_enabled():
        # set by every torch.profiler session, one that profiles all
        # threads too (torch.autograd._profiler_enabled() reads False on
        # the calling thread then)
        return _autograd_profiler._is_profiler_enabled
else:
    _profiler_enabled = torch.autograd._profiler_enabled
_local = threading.local()


def set_recording(on):
    """Spans record without a profiler while on; -> the previous value."""
    global _forced
    was, _forced = _forced, bool(on)
    return was


def recording():
    return _forced or _profiler_enabled()


def _stack():
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Off:
    """What `span` gives while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Span:
    """One recorded span (see the module's doc); a context manager."""

    __slots__ = ("name", "device", "parent", "call", "t0", "t1", "counters",
                 "_events", "_stream", "_device_ms", "_annotation")

    def __init__(self, name, device=None):
        self.name = name
        self.device = device
        self.counters = None
        self._events = self._stream = self._device_ms = None
        self._annotation = None

    def __enter__(self):
        stack = _stack()
        parent = self.parent = stack[-1] if stack else None
        if parent is None:
            self.call = STORE.new_call()
        else:
            self.call = parent.call
            if self.device is None:
                self.device = parent.device
        stack.append(self)
        if _profiler_enabled():
            self._annotation = _autograd_profiler.record_function(self.name)
            self._annotation.__enter__()
        dev = self.device
        if dev is not None and dev.type == "cuda":
            self._stream = torch.cuda.current_stream(dev)
            self._events = STORE.events(self._stream.device_index)
            self._events[1].record(self._stream)
        self.t0 = _now()
        return self

    def __exit__(self, *exc):
        self.t1 = _now()
        if self._events is not None:
            self._events[2].record(self._stream)
            self._stream = None
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
            self._annotation = None
        _stack().pop()
        STORE.add(self)
        if self.parent is None:
            STORE.resolve()
        return False

    @property
    def parent_name(self):
        return None if self.parent is None else self.parent.name

    @property
    def host_ms(self):
        return (self.t1 - self.t0) / 1e6

    @property
    def device_ms(self):
        """The device time, or None while its end marker is ahead."""
        if self._events is None and self._device_ms is None:
            return self.host_ms
        return self._device_ms


def span(name, device=None):
    """A span named `name` (see the module's doc); `device`: where its
    work runs (default: its parent's; host only at the root)."""
    if _forced or _profiler_enabled():
        return Span(name, device)
    return _OFF


def _tally(name, n, ns):
    stack = _stack()
    if stack:
        top = stack[-1]
        if top.counters is None:
            top.counters = {}
        c = top.counters.setdefault(name, [0, 0])
        c[0] += n
        c[1] += ns
    c = STORE.counters.setdefault(name, [0, 0])
    c[0] += n
    c[1] += ns


def count(name, n=1):
    """Add n to the counter `name` while spans record."""
    if _forced or _profiler_enabled():
        _tally(name, n, 0)


def host_read(name, x):
    """bool(x); while spans record, counted under `name` with the host
    time the read blocked for."""
    if not (_forced or _profiler_enabled()):
        return bool(x)
    t0 = _now()
    out = bool(x)
    _tally(name, 1, _now() - t0)
    return out


class SpanStore:
    """The finished spans: a ring of `capacity` records (`dropped` counts
    those it let go), the spans whose device time is still ahead, the
    counters' totals ({name: [n, host ns]}) and a pool of CUDA event
    pairs."""

    def __init__(self, capacity=STORE_CAPACITY):
        self.records = deque(maxlen=capacity)
        self.dropped = 0
        self.added = 0
        self.counters = {}
        self._ahead = deque()
        self._free = defaultdict(list)
        self._lock = threading.Lock()
        self._calls = itertools.count(1)

    def new_call(self):
        return next(self._calls)

    def events(self, device_index):
        """(device index, start, end): a pair of timing events."""
        try:
            return self._free[device_index].pop()
        except IndexError:
            return (device_index, torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))

    def add(self, rec):
        if len(self.records) == self.records.maxlen:
            self.dropped += 1
        self.records.append(rec)
        self.added += 1
        if rec._events is not None:
            self._ahead.append(rec)

    def resolve(self, wait=False):
        """Resolve the device times whose end marker the device has
        reached, in the order the spans ended; `wait`: wait for all."""
        if not self._lock.acquire(blocking=wait):
            return
        try:
            ahead = self._ahead
            while ahead:
                rec = ahead[0]
                index, start, end = events = rec._events
                if wait:
                    end.synchronize()
                elif not end.query():
                    break
                rec._device_ms = start.elapsed_time(end)
                rec._events = None
                self._free[index].append(events)
                ahead.popleft()
        finally:
            self._lock.release()

    def spans(self, name=None, parent=..., start_ns=None, end_ns=None):
        """The kept records named `name` (any name if None) whose parent
        is named `parent` (None: no parent; any if omitted) and that lie
        within [start_ns, end_ns] (perf_counter_ns)."""
        return [r for r in list(self.records)
                if (name is None or r.name == name)
                and (parent is ... or r.parent_name == parent)
                and (start_ns is None or r.t0 >= start_ns)
                and (end_ns is None or r.t1 <= end_ns)]

    def summary(self, name, parent=..., start_ns=None, end_ns=None):
        """{"count", "host_ms", "device_ms", "counters"} over `spans(...)`
        (means per span; "counters": {name: {"n", "host_ms"}}, each a mean
        per span, a span without the counter counting 0), waiting for the
        device times still ahead; None if there is no such span."""
        self.resolve(wait=True)
        recs = self.spans(name, parent, start_ns, end_ns)
        if not recs:
            return None
        n = len(recs)
        totals = defaultdict(lambda: [0, 0])
        for r in recs:
            for k, (c, ns) in (r.counters or {}).items():
                totals[k][0] += c
                totals[k][1] += ns
        return {"count": n,
                "host_ms": sum(r.host_ms for r in recs) / n,
                "device_ms": sum(r.device_ms for r in recs) / n,
                "counters": {k: {"n": c / n, "host_ms": ns / 1e6 / n}
                             for k, (c, ns) in totals.items()}}


STORE = SpanStore()


class _Stage(Span):
    __slots__ = ("timer",)

    def __init__(self, timer, name):
        super().__init__(name)
        self.timer = timer

    def __exit__(self, *exc):
        super().__exit__(*exc)
        timer, ms = self.timer, self.device_ms
        timer.counts[self.name] += 1
        if ms is None:
            timer._pending.append((self.name, self))
        else:
            timer.times[self.name] += ms / 1e3
        return False


class StageTimer:
    """Mean ms per stage, in the JAX twin's report format, as a view over
    spans. `stage(name)` is a span that records while the timer is
    enabled; `spans` maps the names of spans the program opens itself to
    the stage each counts as, while spans record (`set_recording`). A
    stage's time is its spans' device time (host time off CUDA), in
    `times` once known: at once for host times, else from `report()` (or
    `resolve()`) on, which waits for the device times still ahead."""

    def __init__(self, enabled=True, spans=None):
        self.enabled = enabled
        self.times = defaultdict(float)
        self.counts = defaultdict(int)
        self.spans = dict(spans or {})
        self._pending = []
        self._seen = STORE.added

    def stage(self, name):
        """A span of `name` (its parent's device, see `span`), counted as
        stage `name`, while the timer is enabled."""
        return _Stage(self, name) if self.enabled else _OFF

    def resolve(self):
        """Fold the finished spans into `times`, waiting for the device
        times still ahead."""
        new = min(STORE.added - self._seen, len(STORE.records))
        self._seen = STORE.added
        if self.spans and new:
            for rec in itertools.islice(reversed(STORE.records), new):
                if rec.name in self.spans and not isinstance(rec, _Stage):
                    stage = self.spans[rec.name]
                    self.counts[stage] += 1
                    self._pending.append((stage, rec))
        STORE.resolve(wait=True)
        for stage, rec in self._pending:
            self.times[stage] += rec.device_ms / 1e3
        self._pending = []

    def report(self):
        self.resolve()
        parts = []
        for name in sorted(self.times):
            avg = self.times[name] / max(self.counts[name], 1)
            parts.append(f"{name}: {1000 * avg:.1f}ms")
        return "timing[" + ", ".join(parts) + "]"

    def reset(self):
        self.times.clear()
        self.counts.clear()
        self._pending = []
        self._seen = STORE.added


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
