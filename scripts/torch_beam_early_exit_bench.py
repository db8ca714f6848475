"""Beam search's early exit on trained weights, on the card.

Twin of scripts/beam_early_exit_bench.py. Beam 3 is the most
decode-bound serving mode; `LanguageModel.beamsearch(early_exit=True)`
stops its step loop once every beam of every row holds END, where
`early_exit=False` runs all T - 1 steps. On a trained checkpoint (a port
`.npz`, e.g. `scripts/torch_trained_weights_bench.py --save`):

  1. LM only: `beamsearch` at early_exit on and off on the RoI codes of
     one image (`DenseCap.extract_features`, `--proposals` boxes),
     tokens asserted equal;
  2. the full program: `forward_test_batch(use_beam=3)` on that image
     with each variant, tokens asserted equal.

The image is a scene like the trained model's (`make_scene`: coloured
boxes on grey, byte-equal to the JAX script's); `--noise_image` takes
seeded noise instead, where some RoIs never emit END and the early exit
can only cost. Times: the first call (host clock, the card synchronised),
then CUDA events around each of `--iters` calls, the median.

    python scripts/torch_beam_early_exit_bench.py --checkpoint ck.npz
        [--part all|lm|full] [--noise_image] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import functools
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_tool_common as tc  # noqa: E402
from densecap_tpu_torch.utils.checkpoint import load_checkpoint, to_torch  # noqa: E402

BEAM = 3
ITERS = 20


def make_scene(rng, H, W):
    """An in-distribution image for the trained flagship checkpoint
    (coloured boxes on grey), normalized; the JAX script's draws."""
    img = rng.uniform(90, 130, (H, W, 3)).astype(np.float32)
    colors = [(200, 40, 40), (40, 180, 40), (40, 60, 200),
              (220, 210, 40)]
    for _ in range(4):
        w, h = rng.randint(60, 300, 2)
        x = rng.randint(1, W - w - 1)
        y = rng.randint(1, H - h - 1)
        img[y:y + h, x:x + w] = colors[rng.randint(len(colors))]
    return img[:, :, ::-1] - np.array([103.9, 116.8, 123.7], np.float32)


def timed(name, call, iters, dev):
    """(first call s, steady median ms, the first call's output)."""
    tc.sync(dev)
    t0 = time.perf_counter()
    out = call()
    tc.sync(dev)
    first = tc.measured(time.perf_counter() - t0, dev)
    steady = tc.median(tc.call_ms(call, iters, dev, warmup=1))
    print(f"{name}: first call {first} s, steady {steady} ms", flush=True)
    return first, steady, out


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--image_size", type=int, default=720)
    ap.add_argument("--proposals", type=int, default=1000)
    ap.add_argument("--part", default="all", choices=["all", "lm", "full"])
    ap.add_argument("--noise_image", action="store_true",
                    help="seeded noise instead of a scene (the early "
                         "exit's worst case)")
    ap.add_argument("--beam", type=int, default=BEAM)
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--device", default="cuda")
    return ap


@torch.inference_mode()
def main(argv=None):
    args = build_argparser().parse_args(argv)
    dev = tc.card(args.device)
    device = tc.print_device(dev)
    params, _, cfg = load_checkpoint(args.checkpoint)
    S = args.image_size
    cfg = cfg.replace(image_size=S, test_max_proposals=args.proposals)
    model = to_torch(params, cfg, dev)
    del params
    rng = np.random.RandomState(0)
    if args.noise_image:
        img = rng.randn(S, S, 3).astype(np.float32) * 40 + 20
    else:
        img = make_scene(rng, S, S)
    img = torch.from_numpy(np.ascontiguousarray(img, np.float32))[None].to(dev)
    h = torch.full((1,), float(S), device=dev)
    _, feats, _ = model.extract_features(img, h, h, max_boxes=args.proposals)
    feats = feats[0]
    T, END = cfg.seq_length, cfg.vocab_size + 1
    seq_e = model.lm.beamsearch(feats, T, args.beam, early_exit=True)[0]
    lens = tc.lengths_to_end(seq_e.cpu().numpy(), END)
    print(f"caption lengths over {len(lens)} RoIs: mean {lens.mean():.2f} "
          f"max {lens.max()} / T={T} (the loop exits after max+1 steps)",
          flush=True)
    res = {"check": "beam_early_exit_bench", "device": device,
           "weights": args.checkpoint, "noise_image": args.noise_image,
           "rois": len(lens), "caption_len_mean": float(lens.mean()),
           "caption_len_max": int(lens.max()), "seq_length": T}
    if args.part in ("all", "lm"):
        lm = {}
        for early in (False, True):
            lm[early] = timed(
                f"LM-only early_exit={early}",
                lambda early=early: model.lm.beamsearch(
                    feats, T, args.beam, early_exit=early), args.iters, dev)
        if not torch.equal(lm[False][2][0], lm[True][2][0]):
            raise SystemExit("LM-only: early exit changed the tokens")
        res["lm"] = {f"early_exit_{k}": {"first_call_s": v[0],
                                         "steady_ms": v[1]}
                     for k, v in lm.items()}
        res["lm"]["tokens_equal"] = True
        res["lm"]["speedup"] = tc.measured(
            lm[False][1] / lm[True][1] if dev.type == "cuda" else None, dev)
    if args.part in ("all", "full"):
        full, orig = {}, model.lm.beamsearch
        try:  # the variant on the instance; the class's method after
            for early in (False, True):
                model.lm.beamsearch = functools.partial(orig,
                                                        early_exit=early)
                (full[early], counts) = tc.launches_of(lambda: timed(
                    f"full beam-{args.beam} early_exit={early}",
                    lambda: model.forward_test_batch(img, h, h,
                                                     use_beam=args.beam),
                    args.iters, dev))
                if dev.type == "cuda" and not (counts["nms"]
                                               and counts["roi_align"]):
                    raise SystemExit(f"K1 or K2 never launched: {counts}")
        finally:
            del model.lm.beamsearch
        if not torch.equal(full[False][2].captions, full[True][2].captions):
            raise SystemExit("full program: early exit changed the tokens")
        res["full"] = {f"early_exit_{k}": {"first_call_s": v[0],
                                           "steady_ms_per_image": v[1]}
                       for k, v in full.items()}
        res["full"]["tokens_equal"] = True
        res["full"]["launches"] = counts
    return tc.emit(res)


if __name__ == "__main__":
    main()
