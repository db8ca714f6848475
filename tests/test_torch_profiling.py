"""Stage timing and traces in the port: `StageTimer` against the JAX
package's on the same recorded times, `device_trace` on the CPU, and the
train CLI's `--timing` and `--profile_dir`."""

import glob
import json
import re

import pytest
import torch

from densecap_tpu.utils import profiling as jprof
from densecap_tpu_torch.cli import train as train_cli
from densecap_tpu_torch.utils import profiling as prof
from test_torch_train_cli import _args, dataset, narrow_fc  # noqa: F401

torch.set_num_threads(2)


@pytest.mark.parametrize("times,counts", [
    ({}, {}),
    ({"step": 0.0523}, {"step": 1}),
    ({"data": 0.0031, "step": 1.2049}, {"data": 7, "step": 6}),
    ({"z": 1e-5, "a": 3.0, "eval": 0.25}, {"z": 3, "a": 0, "eval": 2}),
])
def test_report_equals_jax(times, counts):
    mine, ref = prof.StageTimer(), jprof.StageTimer()
    for t in (mine, ref):
        t.times.update(times)
        t.counts.update(counts)
    assert mine.report() == ref.report()


def test_stages_record_as_jax():
    mine, ref = prof.StageTimer(), jprof.StageTimer()
    off = prof.StageTimer(enabled=False)
    for t in (mine, ref, off):
        for _ in range(3):
            with t.stage("data"):
                pass
        with t.stage("step"):
            pass
    assert dict(mine.counts) == dict(ref.counts) == {"data": 3, "step": 1}
    assert off.report() == "timing[]"
    mine.reset()
    assert mine.report() == "timing[]"


def test_device_trace_on_the_cpu(tmp_path):
    x = torch.ones(64, 64)
    with prof.device_trace(str(tmp_path / "tr"), cuda=False) as p:
        (x @ x).sum()
    names = {e.key for e in p.key_averages()}
    assert "aten::mm" in names
    (path,) = glob.glob(str(tmp_path / "tr" / "*.pt.trace.json"))
    with open(path) as f:
        assert json.load(f)["traceEvents"]


def test_train_cli_timing_report(dataset, tmp_path, narrow_fc,  # noqa: F811
                                 capsys):
    train_cli.main(_args(dataset, str(tmp_path / "ck" / "t"), 2)
                   + ["--timing", "1"])
    out = capsys.readouterr().out
    lines = re.findall(r"timing\[data: [\d.]+ms, step: [\d.]+ms\]", out)
    assert len(lines) == 2, out  # one per log step


@pytest.mark.parametrize("iters", [5, 4], ids=["window", "ends_inside"])
def test_train_cli_profile_dir(dataset, tmp_path, narrow_fc, capsys,  # noqa: F811
                               iters):
    trace_dir = tmp_path / "trace"
    train_cli.main(_args(dataset, str(tmp_path / "ck" / "p"), iters)
                   + ["--profile_dir", str(trace_dir),
                      "--save_checkpoint_every", "1000"])
    (path,) = glob.glob(str(trace_dir / "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    out = capsys.readouterr().out
    assert ("wrote a trace of steps 3-5" in out) == (iters >= 5)
