"""The control of `correct` for the GRiT cells: broken programs the check
has to reject, beside the sound one.

    python3 benchmark/control_grit.py --workload <cell> --seeds 1,2,3
        [--kind prefix_layer|shift|fp8|bf16|fp8_ref]

Each kind but `fp8_ref` runs the program through the cell's driver for a
short window and judges it as a run judges it. The faults patch the
program's text decoder (`densecap_tpu_torch.models.textdec`) from
outside, for the driver's life:

  * `prefix_layer`: each layer's steps read the prefix keys and values of
    the layer before it (layer 0 its own): after the prefill, the cache's
    prefix columns move up one layer;
  * `shift`: the text positions shifted by one in the cache: step t runs
    as text position t + 1 (its position embedding and its column), so
    each step also reads the never-written column of position 0, left
    zero;
  * `fp8`: the decoder's products (the object projection, qkv, output and
    FFN layers) take operands rounded to float8 e4m3 with a per-tensor
    scale, a precision below the configuration's bf16;
  * `bf16`: the program as it is (sound readings);
  * `fp8_ref`: no program: the GRiT reference itself, every operand of
    every product rounded to float8 e4m3 (per-tensor scale), trunk and
    decoder alike, put in the program's place for the judged inputs and
    judged against the f32 reference (`batch_infer_grit.judge_grit`), its
    features compared as `feat_err` and its fc6 / fc7 on the f32
    reference's RoI features of each image's first rows as `recog_err`.

Prints one JSON line per seed with the numbers and the limits that reject
them. The benchmark's runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

import torch  # noqa: E402

from benchlib import harness, spec  # noqa: E402
from reference.densecap_ref import fp8_round  # noqa: E402


@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def prefix_layer():
    from densecap_tpu_torch.models.textdec import TextDecoder

    prefill = TextDecoder.prefill

    def broken(self, *a, **kw):
        cache = prefill(self, *a, **kw)
        P = cache.prefix
        for kv in (cache.k, cache.v):
            kv[1:, :, :, :P] = kv[:-1, :, :, :P].clone()
        return cache

    return patched(TextDecoder, "prefill", broken)


@contextlib.contextmanager
def shift():
    from densecap_tpu_torch.models.textdec import TextDecoder

    prefill, step = TextDecoder.prefill, TextDecoder.step

    def longer(self, *a):
        cache = prefill(self, *a[:-1], a[-1] + 1)
        cache.k[:, :, :, cache.prefix:] = 0
        cache.v[:, :, :, cache.prefix:] = 0
        return cache

    def shifted(self, tok, t, cache):
        return step(self, tok, t + 1, cache)

    with patched(TextDecoder, "prefill", longer), \
            patched(TextDecoder, "step", shifted):
        yield


@contextlib.contextmanager
def fp8():
    from densecap_tpu_torch.models import textdec

    def rounded(product):
        def low(x, w, b, cd):
            return product(fp8_round(x.float()), fp8_round(w.float()), b, cd)
        return low

    with patched(textdec, "linear_cd", rounded(textdec.linear_cd)), \
            patched(textdec, "linear_f32", rounded(textdec.linear_f32)):
        yield


FAULTS = {"prefix_layer": prefix_layer, "shift": shift, "fp8": fp8}


def fp8_ref_readings(run, dev):
    """The fp8 reference's outputs for the judged inputs, judged against
    the f32 reference, with its features and its fc6 / fc7."""
    from benchlib import grit
    from control import batch_inputs
    from drivers.batch_infer import rel_err
    from drivers.batch_infer_grit import judge_grit
    from reference.densecap_ref import f32_math
    from reference.grit_ref import GritReference
    from reference.judge import worst

    tree = grit.GritWeights(run.cfg, run.seed, dev).tree
    low = GritReference(tree, run.cfg, precision="fp8")
    ref = GritReference(tree, run.cfg)
    rows = int(run.workload["check"]["rows"])
    out_rows = []
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
            reading = judge_grit(ref, image, h, w, served,
                                 out["logprobs"][:n], feats)
            reading["feat_err"] = rel_err(low_feats, feats)
            x = ref.roi_align(feats, out["rois"][:rows], h, w)
            reading["recog_err"] = rel_err(low.codes(x), ref.codes(x))
            out_rows.append(reading)
    return worst(out_rows)


def readings(run, kind, seconds=5.0):
    """The program through the cell's driver with fault `kind` (none for
    "bf16"), set-up, a window of `seconds`, the check's numbers; or, for
    "fp8_ref", the fp8 reference's."""
    if kind == "fp8_ref":
        return fp8_ref_readings(run, torch.device(
            "cuda" if torch.cuda.is_available() else "cpu"))
    d = spec.driver_module(run.workload["driver"]).Driver(run)
    d.fault = None if kind == "bf16" else kind
    try:
        d.setup()
        d.window(seconds)
    finally:
        d.release()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return d.check()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--kind", default="fp8",
                    choices=(*FAULTS, "bf16", "fp8_ref"))
    ap.add_argument("--window-seconds", type=float, default=5.0,
                    help="the program's window")
    args = ap.parse_args(argv)
    bench = spec.benchmark()
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.Run(args.workload, seed, bench["run_seconds"], 0,
                          T_START)
        t0 = time.perf_counter()
        nums = readings(run, args.kind, args.window_seconds)
        limits = run.workload["limits"]
        rejected = [k for k in limits if k in nums and nums[k] > limits[k]]
        print(json.dumps({"workload": args.workload, "kind": args.kind,
                          "seed": seed, "numbers": nums,
                          "rejected_by": rejected,
                          "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
