"""Stage timing, spans and traces in the port: `StageTimer` against the
JAX package's on the same recorded times, `device_trace` on the CPU, the
program's spans and counters off and under the profiler (a tiny model's
`forward_test_batch` and `Trainer.step`), the bounded store, and the train
CLI's `--timing` and `--profile_dir`."""

import glob
import json
import re

import numpy as np
import pytest
import torch

from densecap_tpu.utils import profiling as jprof
from densecap_tpu_torch.cli import train as train_cli
from densecap_tpu_torch.config import DenseCapConfig
from densecap_tpu_torch.parallel.train_step import Trainer
from densecap_tpu_torch.utils import profiling as prof
from densecap_tpu_torch.utils.checkpoint import init_params, to_torch
from test_torch_train_cli import _args, dataset, narrow_fc  # noqa: F401

torch.set_num_threads(2)
TINY = DenseCapConfig(
    vocab_size=20, seq_length=4, image_size=96,
    anchors=((8, 8), (16, 16), (12, 24), (24, 12)), test_max_proposals=12,
    rnn_size=32, rnn_encoding_size=32, fc_dim=64, rpn_num_filters=32,
    sampler_batch_size=16, max_gt_boxes=6, drop_prob=0.0,
    compute_dtype=torch.float32)
INFER_TREE = {"infer.forward": None, "trunk": "infer.forward",
              "localize": "infer.forward", "rpn": "localize",
              "proposals": "localize", "roi_align": "localize",
              "recog": "infer.forward", "final_nms": "infer.forward",
              "decode": "infer.forward"}
TRAIN_TREE = {"train.step": None, "train.forward": "train.step",
              "trunk": "train.forward", "localize": "train.forward",
              "rpn": "localize", "sampler": "localize",
              "roi_align": "localize", "recog": "train.forward",
              "lm.train": "train.forward", "train.backward": "train.step",
              "train.optimizer": "train.step"}


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
    lines = re.findall(r"timing\[data: [\d.]+ms, step: [\d.]+ms, "
                       r"train\.backward: [\d.]+ms, "
                       r"train\.forward: [\d.]+ms, "
                       r"train\.optimizer: [\d.]+ms\]", out)
    assert len(lines) == 2, out  # one per log step
    assert not prof.recording()  # the CLI switched the spans off again


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


def _model(end_first=False):
    """The tiny inference model; `end_first`: every row emits END at the
    first step (the vocab projection's END class far ahead)."""
    params = init_params(TINY, seed=3)
    if end_first:
        params["lm"]["proj"]["b"][TINY.vocab_size] = 1e4
    return to_torch(params, TINY, torch.device("cpu"))


def _images():
    rng = np.random.default_rng(0)
    ims = torch.from_numpy((rng.standard_normal((2, 96, 96, 3)) * 30
                            ).astype(np.float32))
    ims[1, 72:] = 0
    return ims, torch.tensor([96.0, 72.0]), torch.tensor([96.0, 96.0])


def _train_batch():
    rng = np.random.default_rng(1)
    xy = rng.uniform(20, 70, (2, 6, 2))
    wh = rng.uniform(12, 40, (2, 6, 2))
    labels = rng.integers(1, 21, (2, 6, 4))
    labels[:, :, 3] = 0
    return {"image": torch.from_numpy(rng.integers(
                0, 256, (2, 96, 96, 3), dtype=np.uint8)),
            "height": torch.tensor([96.0, 72.0]),
            "width": torch.tensor([80.0, 96.0]),
            "gt_boxes": torch.from_numpy(np.concatenate(
                [xy, wh], -1).astype(np.float32)),
            "gt_labels": torch.from_numpy(labels).long(),
            "gt_valid": torch.tensor([[1, 1, 1, 1, 0, 0],
                                      [1, 1, 1, 0, 0, 0]], dtype=torch.bool)}


def _train_step():
    """A fresh Trainer's first step: (losses, parameters after it)."""
    model = to_torch(init_params(TINY, seed=4), TINY, torch.device("cpu"),
                     train=True)
    trainer = Trainer(model, learning_rate=1e-3)
    out = trainer.step(_train_batch(),
                       generator=torch.Generator().manual_seed(0))
    return out, {k: v.detach().clone() for k, v in model.named_parameters()}


def _new_records(since):
    return list(prof.STORE.records)[len(prof.STORE.records)
                                    - (prof.STORE.added - since):]


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_spans_off_record_nothing(monkeypatch):
    """No profiler, no `--timing`: the forward and a train step record no
    span and no counter, and make no CUDA event and no annotation of a
    span (torch's optimizer enters annotations of its own)."""
    def refuse(*a, **k):
        raise AssertionError("a CUDA event with the spans off")

    entered = []
    inner = torch.autograd.profiler.record_function

    def annotation(name, *a, **k):
        entered.append(name)
        return inner(name, *a, **k)

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        annotation)
    assert not prof.recording()
    added, counters = prof.STORE.added, dict(prof.STORE.counters)
    _model().forward_test_batch(*_images())
    _train_step()
    assert prof.STORE.added == added
    assert prof.STORE.counters == counters
    assert not set(entered) & (set(INFER_TREE) | set(TRAIN_TREE)), entered


def test_spans_change_no_output():
    """The forward and a train step give bit-identical outputs with the
    spans off and on, under the profiler."""
    model = _model()
    off = model.forward_test_batch(*_images())._asdict()
    off_step = _train_step()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        on = model.forward_test_batch(*_images())._asdict()
        on_step = _train_step()
    _equal(off, on)
    for a, b in zip(off_step, on_step):
        _equal(a, b)


def _trace_annotations(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            out.setdefault(e["name"], []).append(e)
    return out


def _check_tree(recs, tree, annotations):
    """recs hold each span of `tree` (name -> parent's name) once, under
    one call id, and each span's annotation in the trace lasts as long as
    its host time (to the annotation's own cost)."""
    assert sorted(r.name for r in recs) == sorted(tree)
    assert {r.name: r.parent_name for r in recs} == tree
    assert len({r.call for r in recs}) == 1
    for r in recs:
        (ann,) = annotations[r.name]
        us = r.host_ms * 1e3
        assert us - 1 <= ann["dur"] <= us + 1000 + 0.02 * us, r.name
        assert r.device_ms == r.host_ms


def _reads(captions, T):
    """The greedy loop's host reads: one before each step, up to the step
    after the one in which the last row emitted its first END."""
    is_end = captions.reshape(-1, T) == TINY.vocab_size + 1
    if not bool(is_end.any(1).all()):
        return T
    return min(T, int(is_end.int().argmax(1).max()) + 2)


@pytest.mark.parametrize("end_first", [False, True], ids=["random", "end"])
def test_forward_span_tree(tmp_path, end_first):
    model = _model(end_first)
    since = prof.STORE.added
    with prof.device_trace(str(tmp_path), cuda=False):
        out = model.forward_test_batch(*_images())
    recs = _new_records(since)
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    _check_tree(recs, INFER_TREE, _trace_annotations(path))
    (decode,) = [r for r in recs if r.name == "decode"]
    reads, wait_ns = decode.counters["decode.reads"]
    assert reads == _reads(out.captions, TINY.seq_length)
    assert (reads == 2) == end_first
    assert 0 < wait_ns <= decode.t1 - decode.t0
    s = prof.STORE.summary("decode", parent="infer.forward",
                           start_ns=decode.t0)
    assert s["count"] == 1
    assert s["counters"]["decode.reads"] == {"n": reads,
                                             "host_ms": wait_ns / 1e6}


def test_train_step_span_tree(tmp_path):
    since = prof.STORE.added
    with prof.device_trace(str(tmp_path), cuda=False):
        _train_step()
    recs = _new_records(since)
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    _check_tree(recs, TRAIN_TREE, _trace_annotations(path))


def test_store_counts_what_it_drops(monkeypatch):
    store = prof.SpanStore(capacity=3)
    monkeypatch.setattr(prof, "STORE", store)
    was = prof.set_recording(True)
    try:
        for i in range(5):
            with prof.span("outer"):
                with prof.span("inner"):
                    prof.count("things", i)
    finally:
        prof.set_recording(was)
    assert len(store.records) == 3 and store.added == 10
    assert store.dropped == 7
    assert [r.name for r in store.records] == ["outer", "inner", "outer"]
    s = store.summary("inner", parent="outer")
    assert s["count"] == 1 and s["counters"]["things"]["n"] == 4
    assert store.counters["things"] == [10, 0]


def test_stage_timer_reads_program_spans():
    """A timer counts the spans the program opens as its stages while
    spans record, and reports them beside its own in the JAX format."""
    timer = prof.StageTimer(spans={"train.step": "step"})
    was = prof.set_recording(True)
    try:
        with timer.stage("data"):
            pass
        _train_step()
        _train_step()
    finally:
        prof.set_recording(was)
    assert re.fullmatch(r"timing\[data: [\d.]+ms, step: [\d.]+ms\]",
                        timer.report())
    assert dict(timer.counts) == {"data": 1, "step": 2}
    assert timer.times["step"] > 0


def test_spans_record_under_a_profiler_of_all_threads():
    """The benchmark's traced run profiles every thread, a session in
    which torch.autograd._profiler_enabled() reads False on the calling
    thread: the spans record all the same."""
    from torch._C._profiler import _ExperimentalConfig

    since = prof.STORE.added
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            experimental_config=_ExperimentalConfig(
                profile_all_threads=True)):
        assert prof.recording()
        _model().forward_test_batch(*_images())
    assert not prof.recording()
    assert sorted(r.name for r in _new_records(since)) == sorted(INFER_TREE)


def test_train_cli_timing_report_on_each_rank(dataset, tmp_path):  # noqa: F811
    """Two gloo ranks with `--timing 1`: each prints its own report (rank
    1 after `rank 1: `), with the gradients' all-reduce beside the data
    wait and the step."""
    from test_torch_distributed import _spawn

    code = ("import functools, sys, torch\n"
            "from densecap_tpu_torch.cli import train\n"
            "from densecap_tpu_torch.config import DenseCapConfig\n"
            "torch.set_num_threads(1)\n"
            "train.DenseCapConfig = functools.partial(DenseCapConfig, "
            "fc_dim=64)\n"
            "train.main(sys.argv[2:] + ['--process_id', sys.argv[1]])\n")
    outs = _spawn(code, _args(dataset, str(tmp_path / "ck" / "r"), 2) + [
        "--num_processes", "2", "--coordinator_address",
        f"file://{tmp_path}/store", "--timing", "1"], tmp_path)
    report = (r"timing\[data: [\d.]+ms, step: [\d.]+ms, "
              r"train\.backward: [\d.]+ms, train\.forward: [\d.]+ms, "
              r"train\.grad_reduce: [\d.]+ms, train\.optimizer: [\d.]+ms\]")
    assert len(re.findall("^" + report, outs[0], re.M)) == 2, outs[0]
    assert len(re.findall("^rank 1: " + report, outs[1], re.M)) == 2, outs[1]
