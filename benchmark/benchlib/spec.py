"""Reading the benchmark's data: `BENCHMARK.json`, one file per cell,
configuration, driver and per-layer metric. The harness finds each by its
name; a new cell, configuration or metric is a new file.

  * cell:          benchmark/workloads/<cell>.json
  * configuration: the `file` that BENCHMARK.json gives it
  * driver:        benchmark/drivers/<driver>.py (the cell's "driver")
  * metric reader: benchmark/metrics/<metric>.py
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=None):
    return load_json(Path(root or ROOT) / "BENCHMARK.json")


def cell_entry(bench, name):
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def workload_file(name, bench_dir=None):
    return load_json(Path(bench_dir or BENCH_DIR) / "workloads"
                     / f"{name}.json")


def config_file(bench, name, root=None):
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(Path(root or ROOT) / c["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver_module(driver, bench_dir=None):
    return load_module(Path(bench_dir or BENCH_DIR) / "drivers"
                       / f"{driver}.py",
                       f"bench_driver_{driver}")


def metric_reader(metric, bench_dir=None):
    return load_module(Path(bench_dir or BENCH_DIR) / "metrics"
                       / f"{metric}.py",
                       "bench_metric_" + metric.replace(".", "_")
                       .replace("-", "_"))


def cell_metrics(bench, name, kind):
    """The metrics of `kind` ("end_to_end" or "per_layer") that cell
    `name` reports: those that list it, or, without a list, those whose
    end-to-end metric (`moves`) the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in names)]
