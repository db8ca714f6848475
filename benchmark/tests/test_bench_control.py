"""The control and the planted faults of `correct`, at a tiny size on the
CPU: a sound run passes the cells' limits; the program's own int8 path,
the reference in the program's place at fp8, and runs with the timed
path broken underneath (a token altered where it is produced, half of
the batch's answers replaced, a step that leaves the state unchanged,
half of the batch left out of the loss, in the whole run or only in the
measured window), do not. The full-size control runs on the card:
`python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --kind
<kind>`."""

from __future__ import annotations

import time

import pytest
import torch

import bench_tiny
from benchlib import harness

INFER = "infer_b8_720_p1000"
TRAIN = "train_b8_720"
START_STEPS = 3  # the training cell's `check.steps`, taken in set-up


def fails(result):
    return not result["correct"]


def start_passes(result):
    """The numbers of the start from the seed (not of the window's step)
    are within their limits."""
    return all(v["value"] <= v["limit"] for k, v in result["checks"].items()
               if not k.startswith("step_"))


@pytest.mark.parametrize("cell", [INFER, TRAIN])
def test_sound_run_passes(cell):
    res = bench_tiny.run_tiny(cell)
    assert res["correct"], res["checks"]


def test_altered_token_fails(monkeypatch):
    from densecap_tpu_torch.models.lstm import LanguageModel

    inner = LanguageModel.greedy_decode

    def altered(self, vectors, seq_length):
        seq, lps = inner(self, vectors, seq_length)
        seq = seq.clone()
        seq[:, 0] = seq[:, 0] % self.vocab_size + 1
        return seq, lps

    monkeypatch.setattr(LanguageModel, "greedy_decode", altered)
    assert fails(bench_tiny.run_tiny(INFER))


def test_half_the_batch_replaced_fails(monkeypatch):
    from densecap_tpu_torch.models.densecap import DenseCap

    inner = DenseCap.forward_test_batch

    def half(self, images, h, w, **kw):
        n = images.shape[0] // 2
        images = torch.cat([images[:n], images[:n]])
        return inner(self, images, h, w, **kw)

    monkeypatch.setattr(DenseCap, "forward_test_batch", half)
    assert fails(bench_tiny.run_tiny(INFER))


@pytest.mark.parametrize("after", [0, START_STEPS], ids=["run", "window"])
def test_unchanged_state_fails(monkeypatch, after):
    """Adam's step a no-op from the first step, or only once set-up's
    steps are done: the window's kept step catches the second."""
    inner = torch.optim.Adam.step
    calls = []

    def step(self, *a, **k):
        calls.append(1)
        if len(calls) <= after:
            return inner(self, *a, **k)
        return None

    monkeypatch.setattr(torch.optim.Adam, "step", step)
    res = bench_tiny.run_tiny(TRAIN)
    assert fails(res)
    if after:
        assert start_passes(res), res["checks"]


@pytest.mark.parametrize("after", [0, START_STEPS], ids=["run", "window"])
def test_half_the_batch_left_out_fails(monkeypatch, after):
    from densecap_tpu_torch.parallel import train_step

    inner = train_step.batched_loss
    calls = []

    def half(model, batch, generator=None, debug_sampler=None, denom=None):
        calls.append(1)
        if len(calls) > after:
            n = batch["image"].shape[0] // 2
            batch = {k: v[:n] for k, v in batch.items()}
        return inner(model, batch, generator, debug_sampler, denom)

    monkeypatch.setattr(train_step, "batched_loss", half)
    res = bench_tiny.run_tiny(TRAIN)
    assert fails(res)
    if after:
        assert start_passes(res), res["checks"]


def tiny_run(cell, seed=5):
    bench, wl, cfg = bench_tiny.tiny(cell)
    return harness.Run(cell, seed, 1.0, 0, time.perf_counter(), device="cpu",
                       bench=bench, workload=wl, cfg=cfg)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_lower_precision_reads_above_the_sound_program(kind):
    """At the tiny size the limits of the full size do not apply: the
    program's int8 path, and the fp8 reference in its place, have to read
    at least three times what the program (bf16) reads on one of the
    numbers the cell compares."""
    import control

    low = control.inference_readings(tiny_run(INFER), kind,
                                     torch.device("cpu"), seconds=1.0)
    sound = bench_tiny.run_tiny(INFER, precision="bfloat16")["checks"]
    assert any(k in low and low[k] >= 3 * sound[k]["value"] > 0
               for k in sound), (low, sound)


def test_fp8_training_reference_reads_above_the_sound_program():
    """The training control at the small size: the fp8 reference reads at
    least three times what the program (bf16) reads on one compared
    number."""
    import control

    low = control.train_readings(tiny_run(TRAIN), "fp8", torch.device("cpu"))
    sound = bench_tiny.run_tiny(TRAIN, precision="bfloat16")["checks"]
    assert any(low[k] >= 3 * sound[k]["value"] > 0 for k in sound), (low,
                                                                     sound)


@pytest.mark.gpu
@pytest.mark.parametrize("cell,kind", [
    (INFER, "int8"), (TRAIN, "fp8"), (TRAIN, "half")])
def test_control_on_the_card(cell, kind):
    """The control of each cell, and the half-batch fault of the training
    cell, at the cell's own size on the card (`python -m pytest
    --noconftest benchmark/tests -m gpu` there): the cell's limits reject
    them."""
    import json
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, str(bench_tiny.BENCH / "control.py"), "--workload",
         cell, "--seeds", "7", "--kind", kind], capture_output=True,
        text=True, check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["rejected_by"], line
