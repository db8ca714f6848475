"""Beam search at the flagship geometry on the card: the first call and
the steady ms per image.

Twin of scripts/beam_profile.py: `forward_test_batch` on one 720 px image
(seeded normal pixels x 30, the whole canvas its extent), 1000 proposals,
the Visual Genome vocabulary of 10 497 words, beam 3, bf16, random weights
from seed 0. Beams are folded into the batch (`LanguageModel.beamsearch`),
and the search stops once every beam of every row holds END.

There is no compiler: the first call (host clock, the card synchronised)
includes what PyTorch sets up on first use (the cuBLAS and cuDNN handles
and algorithm choices, the caching allocator's growth to the peak, the
lazy load of CUDA modules); the kernels' library is built and loaded
before it. Steady: CUDA events around each of `--iters` calls after two
more, the median and mean.

    python scripts/torch_beam_profile.py [--beam 3] [--iters 20]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_tool_common as tc  # noqa: E402
from densecap_tpu_torch.utils.checkpoint import (  # noqa: E402
    init_params, to_torch)


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    tc.add_model_flags(ap, vocab_size=10497)
    ap.add_argument("--beam", type=int, default=3)
    ap.add_argument("--iters", type=int, default=20)
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    dev = tc.card(args.device)
    device = tc.print_device(dev)
    cfg = tc.model_config(args)
    model = to_torch(init_params(cfg, seed=0), cfg, dev)
    S = cfg.image_size
    img = torch.from_numpy(tc.random_canvases((1, S, S, 3), 0)).to(dev)
    h = torch.full((1,), float(S), device=dev)

    def call():
        return model.forward_test_batch(img, h, h, use_beam=args.beam)

    tc.sync(dev)
    t0 = time.perf_counter()
    out = call()
    tc.sync(dev)
    first = tc.measured(time.perf_counter() - t0, dev)
    print(f"first call: {first} s", flush=True)
    times, counts = tc.launches_of(
        lambda: tc.call_ms(call, args.iters, dev, warmup=2))
    if dev.type == "cuda" and not (counts["nms"] and counts["roi_align"]):
        raise SystemExit(f"K1 or K2 never launched: {counts}")
    steady = tc.median(times)
    mean = times if isinstance(times, str) else statistics.mean(times)
    print(f"steady: {steady} ms/image median, {mean} mean (beam="
          f"{args.beam}, {cfg.test_max_proposals} RoIs, V={cfg.vocab_size}, "
          f"{S}px)", flush=True)
    return tc.emit({"check": "beam_profile", "device": device,
                    "beam": args.beam, "proposals": cfg.test_max_proposals,
                    "vocab_size": cfg.vocab_size, "image_size": S,
                    "first_call_s": first,
                    "first_call_includes": "no compile: the cuBLAS / cuDNN "
                    "handles and algorithm choices, the allocator's growth, "
                    "lazy CUDA module loads",
                    "steady_ms_median": steady,
                    "steady_ms_mean": mean, "iters": args.iters,
                    "num": int(out.num[0]), "launches": counts})


if __name__ == "__main__":
    main()
