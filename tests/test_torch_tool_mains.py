"""Every measurement script of the port run through its `main`, on the CPU
at a tiny size, and without a card.

  * with `--device cpu` each runs to its end and prints, last, one JSON
    object holding the device's name and power limit; no number sits
    under a device metric's name (a time, a rate, an MFU, a peak
    memory): those read "not measured". The evaluator-scale bench is
    host-only work on the host clock, so its numbers stay;
  * with the default `--device cuda` and no card, each exits non-zero
    before it runs anything;
  * the throughput tune goes on past a batch size that fails and exits
    non-zero at the end.

tests/test_torch_tools.py holds their programs to the JAX package's;
tests/test_torch_real_eval.py runs the runbook.
"""

import json
import re
import sys
from contextlib import redirect_stdout
from io import StringIO
from pathlib import Path

import pytest
import torch

from densecap_tpu_torch.config import DenseCapConfig
from densecap_tpu_torch.utils.checkpoint import init_params, save_params

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import bench_torch  # noqa: E402
import torch_beam_early_exit_bench  # noqa: E402
import torch_beam_profile  # noqa: E402
import torch_eval_scale_bench  # noqa: E402
import torch_mfu_estimate  # noqa: E402
import torch_prenms_topk_check  # noqa: E402
import torch_real_eval  # noqa: E402
import torch_serving_modes_bench  # noqa: E402
import torch_stage_profile_b8  # noqa: E402
import torch_stage_profile_train  # noqa: E402
import torch_throughput_tune  # noqa: E402
import torch_transfer_latency_probe  # noqa: E402

torch.set_num_threads(2)
MODEL = ["--vocab_size", "20", "--seq_length", "4", "--image_size", "64",
         "--proposals", "8", "--fc_dim", "32", "--rnn_size", "16",
         "--rpn_num_filters", "16", "--dtype", "float32"]
TRAIN = ["--sampler_batch_size", "16", "--max_gt_boxes", "8"]
CKPT = "{tmp}/tiny.npz"
TINY_ARGS = {
    bench_torch: MODEL + ["--canvas_w", "48", "--batch", "2", "--iters", "2"],
    torch_mfu_estimate: MODEL + TRAIN + ["--bucket_w", "48", "--batch", "2",
                                         "--iters", "1"],
    torch_stage_profile_b8: MODEL + ["--batch", "2", "--reps", "1",
                                     "--iters", "1"],
    torch_stage_profile_train: MODEL + TRAIN + ["--batch", "2", "--reps",
                                                "1", "--iters", "1"],
    torch_transfer_latency_probe: ["--iters", "2", "--batch", "2",
                                   "--image_size", "32", "--canvas_w", "24",
                                   "--max_gt_boxes", "4",
                                   "--seq_length", "3"],
    torch_throughput_tune: MODEL + TRAIN + [
        "--batches", "1,2", "--depths", "2,4", "--iters", "2",
        "--train_batches", "2", "--train_iters", "1"],
    torch_serving_modes_bench: MODEL + [
        "--batch", "2", "--canvas_w", "48", "--iters", "2", "--warmup", "1",
        "--single_iters", "2", "--webcam_size", "48",
        "--webcam_proposals", "4", "--topks=64,-1"],
    torch_prenms_topk_check: MODEL + [
        "--steps", "2", "--n_train", "4", "--n_val", "2", "--box_range",
        "8,24", "--cache", "{tmp}/topk.npz", "--topks=-1,100,50"],
    torch_beam_profile: MODEL + ["--iters", "1"],
    torch_beam_early_exit_bench: ["--checkpoint", CKPT, "--image_size", "64",
                                  "--proposals", "8", "--noise_image",
                                  "--iters", "1"],
    torch_eval_scale_bench: ["--images", "6", "--dets", "20",
                             "--meteor_subset", "50"],
}
SCRIPTS = list(TINY_ARGS) + [torch_real_eval]
HOST_ONLY = {torch_eval_scale_bench}
# names of device metrics: times, rates, shares of the peak, memory
DEVICE_METRIC = re.compile(
    r"(^|_)(ms|s|mfu|gib|value|vs_baseline|speedup)$|per_s|tflops|_ms_")


def name(mod):
    return mod.__name__


def device_numbers(obj, key=""):
    """(key, value) of every number under a device metric's name."""
    if isinstance(obj, dict):
        return [x for k, v in obj.items() for x in device_numbers(v, str(k))]
    if isinstance(obj, list):
        return [x for v in obj for x in device_numbers(v, key)]
    if (isinstance(obj, (int, float)) and not isinstance(obj, bool)
            and DEVICE_METRIC.search(key)):
        return [(key, obj)]
    return []


@pytest.fixture
def tiny_checkpoint(tmp_path):
    cfg = DenseCapConfig(vocab_size=20, seq_length=4, image_size=64,
                         fc_dim=32, rnn_size=16, rnn_encoding_size=16,
                         rpn_num_filters=16, compute_dtype=torch.float32)
    save_params(str(tmp_path / "tiny.npz"), init_params(cfg, seed=0),
                extra={"meta": json.dumps({"config": cfg.to_json()})})
    return tmp_path


@pytest.mark.parametrize("mod", list(TINY_ARGS), ids=name)
def test_main_on_the_cpu(mod, tiny_checkpoint):
    argv = [a.format(tmp=tiny_checkpoint) for a in TINY_ARGS[mod]]
    buf = StringIO()
    with redirect_stdout(buf):
        mod.main(argv + ["--device", "cpu"])
    last = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert last["device"] == {"name": "cpu", "power_limit_w": "not measured"}
    if mod not in HOST_ONLY:
        assert device_numbers(last) == []
    text = json.dumps(last)
    assert "not measured" in text or mod in HOST_ONLY


def test_tune_goes_on_past_a_failed_batch(monkeypatch):
    """A B that fails is printed and the sweep goes on; the run still
    exits non-zero, after its JSON line names the failure."""
    real = torch_throughput_tune.inference

    def inference(model, B, *a):
        if B == 1:
            raise torch.cuda.OutOfMemoryError("no room at B=1")
        return real(model, B, *a)

    monkeypatch.setattr(torch_throughput_tune, "inference", inference)
    buf = StringIO()
    with redirect_stdout(buf), pytest.raises(SystemExit) as e:
        torch_throughput_tune.main(TINY_ARGS[torch_throughput_tune]
                                   + ["--device", "cpu"])
    assert e.value.code not in (0, None)
    last = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert last["failed"] == ["inference B=1: OutOfMemoryError"]
    assert list(last["inference"]) == ["2"] and list(last["train_frozen"])


@pytest.mark.parametrize("mod", SCRIPTS, ids=name)
def test_without_a_card_exits_nonzero(mod, monkeypatch, tiny_checkpoint):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a.format(tmp=tiny_checkpoint) for a in TINY_ARGS.get(mod, [])]
    buf = StringIO()
    with redirect_stdout(buf), pytest.raises(SystemExit) as e:
        mod.main(argv)
    assert e.value.code not in (0, None)
    assert "no CUDA card" in str(e.value.code)
    assert "{" not in buf.getvalue()  # nothing measured, no result line
