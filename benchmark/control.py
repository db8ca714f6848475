"""The control of `correct`: readings that the check has to reject.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3
        [--kind int8|bf16|fp8|half]

`int8` (the batch cell's control): the program itself with its own int8
path on (`ops.quant.quantize_for_inference`: fc6, fc7 and the vocab
projection in int8), run through the cell's driver on the cell's inputs
for a short window and judged as a run judges it; `bf16`: the program as
it is, the same way (sound readings). `fp8`: the reference put in the
program's place, every operand of every convolution and matrix product
rounded to float8 e4m3 (per-tensor scale): for the batch cell its
outputs for the judged inputs go through the judge (its end-to-end
numbers); for the training cell (its control) its start from the seed
and one step replayed from the f32 reference's state after the start are
compared with the f32 reference's as a run compares the program's.
`half` (training): a planted fault, the reference on half of each batch
with the mean over that half, against the whole batch.

Prints one JSON line per seed with the numbers and whether the cell's
limits reject them. The benchmark's runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

import torch  # noqa: E402

from benchlib import harness, spec  # noqa: E402
from benchlib.weights import Weights  # noqa: E402
from reference.densecap_ref import Reference, f32_math  # noqa: E402
from reference.judge import judge, worst  # noqa: E402


def batch_inputs(run, dev):
    """The batch cell's inputs, as its driver makes them."""
    w = run.workload["inputs"]
    B, (H, W), (h, cw) = int(w["batch"]), w["canvas"], w["content"]
    gen = torch.Generator(device=dev).manual_seed(run.seed)
    images = torch.randn((2, B, H, W, 3), generator=gen,
                         device=dev).mul_(30.0)
    images[:, :, h:] = 0
    images[:, :, :, cw:] = 0
    n = int(run.workload["check"]["calls"])
    return [(images[i % 2][b], float(h), float(cw))
            for i in range(n) for b in range(B)]


def program_readings(run, kind, seconds):
    """The batch cell's program itself, with its int8 path on (`int8`) or
    as it is (`bf16`), through the cell's own driver: set-up, a window of
    `seconds`, and the check's numbers."""
    d = spec.driver_module("batch_infer").Driver(run)
    d.quantize = kind == "int8"
    try:
        d.setup()
        d.window(seconds)
    finally:
        d.release()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return d.check()


def inference_readings(run, kind, dev, seconds=5.0):
    """`fp8`: the reference at fp8 in the program's place, on the cell's
    inputs, judged as a run judges the program's outputs (its
    end-to-end numbers; the stage numbers need the program's taps);
    `int8` / `bf16`: the program, see `program_readings`."""
    if kind != "fp8":
        return program_readings(run, kind, seconds)
    inputs = batch_inputs(run, dev)
    low = Reference(Weights(run.cfg, run.seed, dev).tree, run.cfg,
                    precision="fp8")
    with torch.no_grad():
        outs = [low.forward_test(image, h, w) for image, h, w in inputs]
    ref = Reference(Weights(run.cfg, run.seed, dev).tree, run.cfg)
    readings = []
    with torch.no_grad(), f32_math():
        for (image, h, w), out in zip(inputs, outs):
            v = out["valid"]
            n = int(v.sum())
            served = {"boxes": out["boxes"][:n], "scores": out["scores"][:n],
                      "tokens": out["tokens"][:n], "rois": out["rois"],
                      "roi_valid": out["roi_valid"],
                      "roi_scores": out["roi_scores"], "idx": out["idx"][:n]}
            readings.append(judge(ref, image, h, w, served))
    return worst(readings)


def train_readings(run, kind, dev):
    """`fp8`: the reference at fp8 against the f32 reference; `half`: a
    planted fault, the f32 reference on half of each batch, against the
    whole. Both for the start from the seed and for one step replayed
    from the f32 reference's state after the start, as a run replays its
    kept window step (the fp8 reference's sample given to the f32 one,
    as the program's is)."""
    drv = spec.driver_module("train_step")
    d = drv.Driver(run)
    d.host = [drv.pinned(b, dev.type == "cuda")
              for b in drv.make_batches(d.spec, run.cfg, run.seed)]
    losses, g1, delta, ref = d.reference_readings("f32")
    state = tuple({k: x[k].detach().clone() for k in ref.params}
                  for x in (ref.params, ref.m, ref.v)) + (ref.t,)
    gen_state = ref.gen.get_state()
    index = int(run.workload["check"]["steps"]) % len(d.host)
    del ref
    half = kind == "half"
    precision = "fp8" if kind == "fp8" else "f32"
    low_start = d.reference_readings(precision, half=half)[:3]
    out = drv.compare(low_start, (losses, g1, delta))
    low = d.replay(state, index, gen_state, precision, half=half)
    given = None if half else low[3].sample
    ref = d.replay(state, index, gen_state, "f32", given=given)
    out.update(drv.step_numbers(low[:3], ref[:3],
                                getattr(ref[3], "sample_mismatch", 0.0)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--kind", default="fp8",
                    choices=("fp8", "int8", "bf16", "half"))
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--window-seconds", type=float, default=5.0,
                    help="the program's window for int8 / bf16")
    args = ap.parse_args(argv)
    bench = spec.benchmark()
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.Run(args.workload, seed,
                          args.seconds or bench["run_seconds"], 0, T_START)
        dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
        t0 = time.perf_counter()
        if run.workload["driver"] == "train_step":
            nums = train_readings(run, args.kind, dev)
        else:
            nums = inference_readings(run, args.kind, dev,
                                      args.window_seconds)
        limits = run.workload["limits"]
        rejected = [k for k in limits if k in nums and nums[k] > limits[k]]
        print(json.dumps({"workload": args.workload, "kind": args.kind,
                          "seed": seed, "numbers": nums,
                          "rejected_by": rejected,
                          "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
