"""One run of one cell: set-up, the measured window, the peak memory, the
check against the reference, the metrics, and the result line.

The driver named in the cell's file does the cell's work
(`drivers/<driver>.py`, class `Driver`):

  * `setup()`: build the program's object and warm every shape the
    window uses (set-up time);
  * `window(seconds)`: the measured window, entered through
    `run.window()`; returns {"metrics": end-to-end values, "attempted",
    "failed"};
  * `release()`: drop the program's state and stop what the driver
    started (after the peak is read, and on an error); idempotent;
  * `check()`: {number: value} from the reference, compared with the
    cell's `limits`.

Per-layer metrics (`--trace 1`) are read by `metrics/<name>.py`
(`read(run) -> number or None`) from what the driver recorded in
`run.spans` and `run.counters` and from the device trace (`run.trace`).
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time

from . import spec
from .trace import DeviceTrace

FORBIDDEN = ("jax", "jaxlib", "flax", "densecap_tpu")
TRACE_PATH = spec.ROOT / "build" / "bench_trace" / "trace.json"


class Failure(SystemExit):
    """Ends the run with a non-zero code and no result line."""

    def __init__(self, msg, code=2):
        print(f"benchmark: {msg}", file=sys.stderr, flush=True)
        super().__init__(code)


class Run:
    def __init__(self, name, seed, seconds, trace, t_start, device="cuda",
                 bench=None, workload=None, cfg=None):
        self.bench = bench if bench is not None else spec.benchmark()
        self.name = name
        self.entry = spec.cell_entry(self.bench, name)
        self.workload = (workload if workload is not None
                         else spec.workload_file(name))
        self.cfg = (cfg if cfg is not None else
                    spec.config_file(self.bench, self.workload["config"]))
        self.seed, self.seconds = int(seed), float(seconds)
        self.tracing = bool(trace)
        self.t_start = t_start
        self.device = device
        self.spans, self.counters = {}, {}
        self.trace = None
        self.window_start = self.window_s = None

    @contextlib.contextmanager
    def window(self):
        """The measured window: marks its start (the end of set-up) and,
        in a traced run, runs under the profiler."""
        tracer = DeviceTrace(str(TRACE_PATH)) if self.tracing else None
        self.window_start = time.perf_counter()
        if tracer:
            tracer.__enter__()
        try:
            yield
        finally:
            if tracer:
                tracer.__exit__(*sys.exc_info())
            self.window_s = time.perf_counter() - self.window_start
        if tracer:
            self.trace = tracer.reduce()


def card_info():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True)
    return smi.stdout.strip() or smi.stderr.strip()


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def execute(run, chips_checked=True, modules_checked=True):
    """Run the cell; -> the result dict (printed by `report`). The CPU
    tests skip the look for a chip and, since their test process has
    loaded JAX for the port's own tests, the look at the modules."""
    import torch

    if run.device == "cuda" and chips_checked:
        if not torch.cuda.is_available():
            raise Failure("no CUDA device")
        if torch.cuda.device_count() < int(run.entry["chips"]):
            raise Failure(f"{torch.cuda.device_count()} CUDA devices, the "
                          f"cell needs {run.entry['chips']}")
    import importlib.util

    if importlib.util.find_spec("densecap_tpu_torch") is None:
        raise Failure("the program (densecap_tpu_torch) is not here")
    cuda = run.device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    driver = spec.driver_module(run.workload["driver"]).Driver(run)
    try:
        driver.setup()
        outcome = driver.window(run.seconds)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
    finally:
        driver.release()
    if cuda:
        torch.cuda.empty_cache()
    numbers = driver.check()
    bad = forbidden_modules() if modules_checked else []
    if bad:
        raise Failure(f"these modules were loaded: {bad}", code=3)
    limits = run.workload["limits"]
    checks = {k: {"value": numbers.get(k), "limit": limits[k]}
              for k in limits}
    correct = all(v["value"] is not None and math.isfinite(v["value"])
                  and v["value"] <= v["limit"] for v in checks.values())
    extra = {k: v for k, v in numbers.items() if k not in limits}

    metrics = {}
    if run.tracing:
        for m in spec.cell_metrics(run.bench, run.name, "per_layer"):
            value = spec.metric_reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(outcome["metrics"])
        values["setup_s"] = run.window_start - run.t_start
        values["peak_mem_gib"] = peak / 2**30
        for m in spec.cell_metrics(run.bench, run.name, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": int(run.entry["chips"]),
              "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": outcome["attempted"],
              "failed": outcome["failed"], "metrics": metrics,
              "device": device}
    if run.tracing and run.trace is not None:
        device["busy_s"] = run.trace["busy_s"]
        device["window_s"] = run.trace["window_s"]
        result["breakdown"] = run.trace["breakdown"]
    result["card"] = card_info() if cuda else "cpu"
    result["counters"] = {k: v for k, v in run.counters.items()
                          if isinstance(v, (int, float))}
    result["reference_extra"] = extra
    result["checks"] = checks
    return result


def report(result):
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
