"""The per-layer metrics read from the program's own spans and counters
(`benchlib/program_spans.py`): a traced run of each cell at a tiny size
on the CPU gives each of them a number that agrees with the benchmark's
own wrappers around the same calls; a program without the store (as the
port was before it had one) gives none of them and the run ends as
before."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

import bench_tiny

BENCH = json.loads((Path(bench_tiny.BENCH).parent
                    / "BENCHMARK.json").read_text())
READERS = {m["name"]: m["workloads"] for m in BENCH["per_layer"]
           if (Path(bench_tiny.BENCH) / "metrics" / f"{m['name']}.py"
               ).read_text().count("benchlib.program_spans")}
INFER, TRAIN = "infer_b8_720_p1000", "train_b8_720"


def test_ten_readers():
    assert sorted(READERS) == sorted([
        "infer.trunk_ms", "infer.localize_ms", "infer.recog_ms",
        "infer.decode_ms", "infer.decode_wait_ms", "infer.decode_reads",
        "train.forward_ms", "train.backward_ms", "train.optimizer_ms",
        "train.step_host_ms"])


@pytest.mark.parametrize("cell", [INFER, TRAIN])
def test_every_reader_reads_a_traced_run(cell):
    res = bench_tiny.run_tiny(cell, trace=1)
    assert res["correct"], res["checks"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    names = [n for n, cells in READERS.items() if cell in cells]
    assert names
    for n in names:
        assert m[n] > 0, n
    if cell == INFER:
        # random weights never emit END: 15 reads a call
        assert m["infer.decode_reads"] == 15.0
        assert m["infer.decode_wait_ms"] <= m["infer.decode_ms"]
        assert m["infer.decode_ms"] == pytest.approx(m["decode_ms.infer"],
                                                     rel=0.03)
    else:
        assert m["train.optimizer_ms"] >= m["train.adam_ms"]


def test_a_program_without_spans_gives_none(monkeypatch):
    from densecap_tpu_torch.utils import profiling

    # the port as it was before: no span records, and no store
    monkeypatch.setattr(profiling, "_profiler_enabled", lambda: False)
    monkeypatch.delattr(profiling, "STORE")
    res = bench_tiny.run_tiny(INFER, trace=1)
    assert res["correct"], res["checks"]
    assert "decode_ms.infer" in res["metrics"]
    assert not set(READERS) & set(res["metrics"])
