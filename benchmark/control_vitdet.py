"""The control of `correct` for the ViTDet cells: readings the check has
to reject, beside the sound ones.

    python3 benchmark/control_vitdet.py --workload <cell> --seeds 1,2,3
        [--kind fp8|norel|bf16]

`fp8`: the ViTDet reference put in the program's place, every operand of
every convolution and matrix product rounded to float8 e4m3 (per-tensor
scale), the attention's products and the relative-position terms
included: its outputs for the judged inputs go through the judge, its
features are compared with the f32 reference's as `feat_err`, and its
fc6 / fc7 on the f32 reference's RoI features of each image's first rows
with the f32 ones as `recog_err`. `norel`:
the program without its relative-position terms (its tables zeroed),
through the cell's driver for a short window, judged as a run judges it;
`bf16`: the program as it is, the same way (sound readings).

Prints one JSON line per seed with the numbers and the limits that reject
them. The benchmark's runs never run this.
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

from benchlib import harness, spec, vitdet  # noqa: E402
from control import batch_inputs  # noqa: E402
from reference.densecap_ref import f32_math  # noqa: E402
from reference.judge import judge, worst  # noqa: E402
from reference.vitdet_ref import VitReference  # noqa: E402


def program_readings(run, rel_pos, seconds):
    """The program through the cell's driver, with (`rel_pos`) or without
    its relative-position terms: set-up, a window of `seconds`, the
    check's numbers."""
    d = spec.driver_module(run.workload["driver"]).Driver(run)
    d.rel_pos = rel_pos
    try:
        d.setup()
        d.window(seconds)
    finally:
        d.release()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return d.check()


def rel_err(x, ref):
    return float(torch.linalg.vector_norm(x - ref)
                 / torch.linalg.vector_norm(ref))


def fp8_readings(run, dev):
    """The fp8 reference's outputs and features for the judged inputs,
    judged against the f32 reference, and its fc6 / fc7 (`recog_err`)."""
    tree = vitdet.VitWeights(run.cfg, run.seed, dev).tree
    low = VitReference(tree, run.cfg, precision="fp8")
    ref = VitReference(tree, run.cfg)
    rows = int(run.workload["check"]["rows"])
    readings = []
    with torch.no_grad(), f32_math():
        for image, h, w in batch_inputs(run, dev):
            low_feats = low.features(image, h, w)
            low.features = lambda *a: low_feats  # forward_test's own call
            out = low.forward_test(image, h, w)
            del low.features
            n = int(out["valid"].sum())
            served = {"boxes": out["boxes"][:n], "scores": out["scores"][:n],
                      "tokens": out["tokens"][:n], "rois": out["rois"],
                      "roi_valid": out["roi_valid"],
                      "roi_scores": out["roi_scores"], "idx": out["idx"][:n]}
            feats = ref.features(image, h, w)
            ref.features = lambda *a: feats  # judge's own call
            reading = judge(ref, image, h, w, served)
            del ref.features
            reading["feat_err"] = rel_err(low_feats, feats)
            # fc6 / fc7 at fp8 on the reference's RoI features of the first
            # rows, as the program's `recog_err` judges its own
            x = ref.roi_align(feats, out["rois"][:rows], h, w)
            reading["recog_err"] = rel_err(low.codes(x), ref.codes(x))
            readings.append(reading)
    return worst(readings)


def readings(run, kind, dev, seconds=5.0):
    if kind == "fp8":
        return fp8_readings(run, dev)
    return program_readings(run, kind == "bf16", seconds)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--kind", default="fp8", choices=("fp8", "norel", "bf16"))
    ap.add_argument("--window-seconds", type=float, default=5.0,
                    help="the program's window for norel / bf16")
    args = ap.parse_args(argv)
    bench = spec.benchmark()
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.Run(args.workload, seed, bench["run_seconds"], 0,
                          T_START)
        t0 = time.perf_counter()
        nums = readings(run, args.kind, dev, args.window_seconds)
        limits = run.workload["limits"]
        rejected = [k for k in limits if k in nums and nums[k] > limits[k]]
        print(json.dumps({"workload": args.workload, "kind": args.kind,
                          "seed": seed, "numbers": nums,
                          "rejected_by": rejected,
                          "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
