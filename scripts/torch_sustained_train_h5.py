"""Sustained flagship training fed by the port's h5 path, against the same
step fed from memory.

Twin of scripts/sustained_train_h5.py. The reference's train loop reads
the h5 at every step; this script drives the port's real feed --
`DenseCapLoader` (the codec's reads by index) -> `BucketedLoader` ->
`PrefetchingLoader` (a thread) -> `cli/train.py:_to_device` (the pinned,
non-blocking copy) -> `Trainer.step` -- on an h5 that the port's
preprocess wrote (scripts/torch_make_synth_vg.py), and compares three
feeds at the flagship's full width (VGG-16, fc 4096, LSTM 512, vocab
10 000, bf16, 256-RoI sampler, the trunk frozen):

  in_ram   - a pool of batches built by the same bucketed loader, held
             on the card and cycled (no host work per step);
  shipping - the real feed, one batch copied ahead while the step runs;
  loader   - no training: the prefetching loader drained alone, the
             host feed's own capacity.

    python scripts/torch_sustained_train_h5.py --mode shipping \\
        [--h5 build/synthvg/VG-regions.h5] [--steps 300] [--device cuda]

Prints ms/step (host clock around steps that end in a synchronize),
images/s and, on a card, the busy share (device time per step under
torch.profiler over BUSY_WINDOW steps after the timed ones, over the
timed ms/step); then one JSON line with every number and the card's name
and power limit. On a CUDA device it needs the card and the kernels'
build, and never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from densecap_tpu_torch.cli.train import _to_device  # noqa: E402
from densecap_tpu_torch.config import DenseCapConfig  # noqa: E402
from densecap_tpu_torch.data.loader import (  # noqa: E402
    BucketedLoader, DenseCapLoader, PrefetchingLoader)
from densecap_tpu_torch.ops.cuda import build  # noqa: E402
from densecap_tpu_torch.parallel.train_step import (  # noqa: E402
    Trainer, cosine_decay_schedule)
from densecap_tpu_torch.utils.checkpoint import init_params, to_torch  # noqa: E402

SYNTH = ROOT / "build" / "synthvg"
BUSY_WINDOW = 20     # steps traced for the busy share


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--h5", default=str(SYNTH / "VG-regions.h5"))
    ap.add_argument("--json", default=str(SYNTH / "VG-regions-dicts.json"))
    ap.add_argument("--mode", default="shipping",
                    choices=["shipping", "in_ram", "loader"])
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--warmup", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--buckets", default="544x720,720x544")
    ap.add_argument("--max_gt_boxes", type=int, default=128)
    ap.add_argument("--vocab_size", type=int, default=10000,
                    help="flagship LM width (labels use only the synthetic "
                         "vocabulary's low ids)")
    ap.add_argument("--pool_batches", type=int, default=36,
                    help="in_ram: batches held on the card")
    ap.add_argument("--device", default="cuda")
    return ap


def device_line(dev):
    """The device's description: name and count, and for a card
    nvidia-smi's name and power limit."""
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu"}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": torch.cuda.device_count(),
            "nvidia_smi": smi.stdout.strip() or smi.stderr.strip()}


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_ms(prof):
    """Device time of a torch.profiler run: its CUDA kernels and copies,
    without user annotations (their spans cover the kernels inside)."""
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)) / 1e3


def drain_loader(bucketed, args):
    """`loader` mode: batches/s and images/s of the prefetching loader
    alone (real images: repeat padding has weight 0)."""
    pf = PrefetchingLoader(source=bucketed.next_batch, depth=4)
    try:
        for _ in range(args.warmup):
            pf.next()
        t0 = time.perf_counter()
        n = 0
        for _ in range(args.steps):
            _, batch = pf.next()
            n += int((batch["weight"] > 0).sum())
        dt = time.perf_counter() - t0
    finally:
        pf.close()
    return {"batches_per_s": args.steps / dt, "images_per_s": n / dt,
            "seconds": dt}


def train(bucketed, cfg, args, dev):
    """`in_ram` or `shipping`: warm-up steps (every bucket's first
    call), then `steps` timed steps and BUSY_WINDOW traced ones (on a
    card)."""
    total = args.warmup + args.steps + BUSY_WINDOW
    model = to_torch(init_params(cfg, seed=0), cfg, dev, train=True)
    trainer = Trainer(model, learning_rate=cosine_decay_schedule(
        3e-4, total, alpha=0.05))
    gen = torch.Generator(device=dev).manual_seed(1)
    pf = None
    if args.mode == "in_ram":
        pool = [_to_device(bucketed.next_batch()[1], dev)
                for _ in range(args.pool_batches)]

        def feed(i):
            return pool[i % len(pool)]
    else:
        pf = PrefetchingLoader(source=lambda: bucketed.next_batch()[1],
                               depth=4)
        pending = [_to_device(pf.next(), dev)]

        def feed(i):
            # one batch ahead: its copy runs beside this step
            out = pending.pop(0)
            pending.append(_to_device(pf.next(), dev))
            return out
    try:
        losses = None
        for i in range(args.warmup):
            losses = trainer.step(feed(i), generator=gen)
        sync(dev)
        first = float(losses["total_loss"]) if losses else None
        before = dict(build.launches)
        t0 = time.perf_counter()
        for i in range(args.steps):
            losses = trainer.step(feed(args.warmup + i), generator=gen)
        sync(dev)
        dt = time.perf_counter() - t0
        launches = {k: v - before[k] for k, v in build.launches.items()}
        busy = None
        if dev.type == "cuda":
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for i in range(BUSY_WINDOW):
                    trainer.step(feed(args.warmup + args.steps + i),
                                 generator=gen)
                sync(dev)
            busy = {"steps": BUSY_WINDOW,
                    "device_ms_per_step": device_ms(prof) / BUSY_WINDOW}
            busy["share"] = busy["device_ms_per_step"] / (dt * 1e3
                                                          / args.steps)
    finally:
        if pf is not None:
            pf.close()
    return {"ms_per_step": dt * 1e3 / args.steps,
            "images_per_s": args.batch * args.steps / dt, "seconds": dt,
            "loss_first": first, "loss_last": float(losses["total_loss"]),
            "busy": busy, "launches": launches}


def main(argv=None):
    args = build_argparser().parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {args.device}: no CUDA card here")
        build.load()
    device = device_line(dev)
    print(f"device: {json.dumps(device)}", flush=True)
    loader = DenseCapLoader(args.h5, args.json,
                            max_gt_boxes=args.max_gt_boxes)
    try:
        buckets = [tuple(int(v) for v in b.split("x"))
                   for b in args.buckets.split(",") if b]
        bucketed = BucketedLoader(loader, buckets, args.batch, split=0)
        cfg = DenseCapConfig(
            vocab_size=max(args.vocab_size, loader.vocab_size()),
            seq_length=loader.seq_length(), image_size=loader.canvas,
            sampler_batch_size=256, max_gt_boxes=args.max_gt_boxes)
        print(f"cfg: canvas {loader.canvas}, seq {cfg.seq_length}, vocab "
              f"{cfg.vocab_size}, G {cfg.max_gt_boxes}, B {args.batch}, "
              f"buckets {bucketed.buckets}, train images "
              f"{loader.split_size(0)}", flush=True)
        if args.mode == "loader":
            res = drain_loader(bucketed, args)
            print(f"LOADER ONLY: {res['images_per_s']:.1f} images/s, "
                  f"{res['batches_per_s']:.2f} batches/s over {args.steps} "
                  f"batches (host clock)")
        else:
            res = train(bucketed, cfg, args, dev)
            busy = res["busy"]
            print(f"SUSTAINED ({args.mode}, B={args.batch}, buckets "
                  f"{args.buckets}): {res['ms_per_step']:.2f} ms/step, "
                  f"{res['images_per_s']:.1f} images/s over {args.steps} "
                  f"steps (host clock); busy share "
                  + (f"{busy['share']:.1%} ({busy['device_ms_per_step']:.2f}"
                     " ms of device time per step)" if busy
                     else "not measured")
                  + f"; loss {res['loss_first']} -> {res['loss_last']}; "
                    f"launches {res['launches']}")
            if dev.type == "cuda" and not (res["launches"]["roi_align"]
                                           and res["launches"]
                                           ["roi_align_bwd"]):
                raise SystemExit("K2 or K2b never launched in training: "
                                 f"{res['launches']}")
            if not np.isfinite(res["loss_last"]):
                raise SystemExit(f"non-finite loss {res['loss_last']}")
    finally:
        loader.close()
    print(json.dumps({"script": "torch_sustained_train_h5",
                      "mode": args.mode, "device": device,
                      "batch": args.batch, "steps": args.steps,
                      "warmup": args.warmup, "buckets": args.buckets,
                      **res}))


if __name__ == "__main__":
    main()
