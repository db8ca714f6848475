"""BENCHMARK.json and the benchmark's files: the contract's rules, and a
new configuration, cell or metric taking only new files."""

from __future__ import annotations

import json
import re
import shutil
import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

from benchlib import harness, spec  # noqa: E402

B = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in B["workloads"]]


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["command"] == ["python3", "benchmark/run.py"]
    assert B["paths"] == ["benchmark"]
    assert 1 <= B["run_seconds"] <= 51
    assert len(json.dumps(B)) <= 64 * 1024


def test_names_and_units():
    names = ([c["name"] for c in B["configs"]] + CELLS
             + [m["name"] for m in B["end_to_end"] + B["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in B["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert c["file"].startswith("benchmark/")


def test_metrics_entries():
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200
        e2e = next(e for e in B["end_to_end"] if e["name"] == m["moves"])
        for w in m["workloads"]:
            assert w in CELLS
            assert "workloads" not in e2e or w in e2e["workloads"], (m, w)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    entry = spec.cell_entry(B, cell)
    wl = spec.workload_file(cell)
    for k in ("config", "traffic", "chips", "why"):
        assert wl[k] == entry[k], k
    assert entry["chips"] == 1
    cfg = spec.config_file(B, wl["config"])
    assert cfg["name"] == wl["config"]
    assert (BENCH / "drivers" / f"{wl['driver']}.py").is_file()
    e2e = {m["name"] for m in spec.cell_metrics(B, cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    per = spec.cell_metrics(B, cell, "per_layer")
    assert per
    for m in per:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e
    assert wl["limits"]


def test_configs_keep_the_published_widths():
    for c in B["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["fc_dim"] == 4096 and cfg["rnn_size"] == 512
        assert cfg["rnn_encoding_size"] == 512 and cfg["seq_length"] == 15
        assert c["reduced"] == cfg["reduced"]


def test_new_entries_take_only_new_files(tmp_path):
    """A dummy configuration, cell and per-layer metric, each a new file
    beside copies of the existing ones, run through the harness with no
    edit to any file that was there."""
    root = tmp_path / "repo"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" /
                      "densecap_vgg16_720_p1000.json").read_text())
    cfg.update(name="dummy_cfg", vocab_size=20, fc_dim=64, rnn_size=16,
               rnn_encoding_size=16, image_size=64, test_max_proposals=20,
               test_pre_nms_topk=200, compute_dtype="float32")
    (root / "benchmark" / "configs" / "dummy_cfg.json").write_text(
        json.dumps(cfg))
    wl = json.loads((BENCH / "workloads" /
                     "infer_b8_720_p1000.json").read_text())
    wl.update(config="dummy_cfg", traffic="dummy_traffic")
    wl["inputs"].update(batch=2, canvas=[64, 48], content=[64, 45])
    (root / "benchmark" / "workloads" / "dummy_cell.json").write_text(
        json.dumps(wl))
    (root / "benchmark" / "metrics" / "dummy_calls.py").write_text(
        "def read(run):\n    return float(run.counters['calls'])\n")
    bench["configs"].append({"name": "dummy_cfg", "source": "a test",
                             "file": "benchmark/configs/dummy_cfg.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "dummy_cell", "config": "dummy_cfg",
                               "traffic": "dummy_traffic", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "infer_b8_720_p1000" in m["workloads"]:
            m["workloads"].append("dummy_cell")
    bench["per_layer"].append({
        "name": "dummy_calls", "unit": "calls", "better": "higher",
        "source": "program_counter", "layer": "test",
        "moves": "infer_images_per_s", "workloads": ["dummy_cell"]})
    bdir = root / "benchmark"
    old = (spec.BENCH_DIR, spec.ROOT)
    spec.BENCH_DIR, spec.ROOT = bdir, root
    try:
        run = harness.Run("dummy_cell", 7, 1.0, 1, time.perf_counter(),
                          device="cpu", bench=bench,
                          workload=spec.workload_file("dummy_cell", bdir),
                          cfg=spec.config_file(bench, "dummy_cfg", root))
        res = harness.execute(run, chips_checked=False,
                              modules_checked=False)
    finally:
        spec.BENCH_DIR, spec.ROOT = old
    assert res["correct"]
    assert res["metrics"]["dummy_calls"]["value"] >= 1
