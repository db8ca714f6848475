"""Throughput tuning of the port on the card: batch size x pipeline depth
for inference, and the train step's batch scaling with the trunk frozen.

Twin of scripts/throughput_tune.py:

  * inference: bench_torch.py's program and loop (random weights from
    seed 0, vocab 10 000, 1000 proposals, bf16) on the 720 px square with
    720x540 content, at B in `--batches` and depth in `--depths`, 12
    calls each: images/s and the peak memory of each B;
  * training: the frozen step (`Trainer`, trunk frozen, `fuse_conv_pool`
    on, sampler 256, 128 gt slots) at B in `--train_batches`, `--train_iters`
    steps after one warm-up, the card synchronised once at the end:
    ms/step, images/s and the peak memory of each B.

A B that fails (out of memory, a launch error) is printed and the sweep
goes on; the run still exits non-zero at the end, after its JSON line.

    python scripts/torch_throughput_tune.py [--batches 8,12,16]
        [--depths 2,4] [--train_batches 8,16] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
import traceback
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_tool_common as tc  # noqa: E402
import bench_torch  # noqa: E402
from densecap_tpu_torch.parallel.train_step import Trainer  # noqa: E402
from densecap_tpu_torch.utils.checkpoint import (  # noqa: E402
    init_params, to_torch)


def ints(s):
    return [int(x) for x in s.split(",") if x]


def failure(what, e, failed):
    print(f"{what}: FAILED: {type(e).__name__}: {str(e)[:500]}", flush=True)
    traceback.print_exc(limit=2)
    failed.append(f"{what}: {type(e).__name__}")
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def inference(model, B, depths, iters, dev):
    S = model.cfg.image_size
    batches = torch.from_numpy(tc.random_canvases((2, B, S, S, 3), 1)).to(dev)
    hs = torch.full((B,), float(S), device=dev)
    ws = torch.full((B,), S * 0.75, device=dev)
    tc.reset_peak(dev)
    float(bench_torch.checksum(model.forward_test_batch(batches[0], hs, ws)))
    row = {}
    for depth in depths:
        dt = bench_torch.run(model, batches, hs, ws, iters, depth, dev)
        ips = tc.measured(iters * B / dt, dev)
        row[f"depth_{depth}_images_per_s"] = ips
        print(f"inference B={B} depth={depth}: "
              + (ips if isinstance(ips, str) else f"{ips:7.1f} img/s"),
              flush=True)
    row["peak_gib"] = tc.peak_gib(dev)
    return row


def train(params, cfg, B, iters, dev):
    tc.reset_peak(dev)
    model = to_torch(params, cfg, dev, train=True)
    trainer = Trainer(model, learning_rate=1e-5)
    S = cfg.image_size
    batch = tc.train_batch(cfg, B, S, S, S * 0.75, dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    float(trainer.step(batch, generator=gen)["total_loss"])
    tc.sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        losses = trainer.step(batch, generator=gen)
    float(losses["total_loss"])
    tc.sync(dev)
    ms = tc.measured((time.perf_counter() - t0) / iters * 1e3, dev)
    row = {"ms_per_step": ms, "images_per_s": tc.rate(B, ms),
           "peak_gib": tc.peak_gib(dev)}
    print(f"train (frozen) B={B}: "
          + (ms if isinstance(ms, str) else
             f"{ms:7.1f} ms/step {row['images_per_s']:6.1f} img/s")
          + f", peak {row['peak_gib']} GiB", flush=True)
    return row


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    tc.add_model_flags(ap)
    ap.add_argument("--batches", default="8,12,16")
    ap.add_argument("--depths", default="2,4")
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--train_batches", default="8,16")
    ap.add_argument("--train_iters", type=int, default=8)
    ap.add_argument("--sampler_batch_size", type=int, default=256)
    ap.add_argument("--max_gt_boxes", type=int, default=128)
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    dev = tc.card(args.device)
    device = tc.print_device(dev)
    cfg = tc.model_config(args, sampler_batch_size=args.sampler_batch_size,
                          max_gt_boxes=args.max_gt_boxes)
    params = init_params(cfg, seed=0)
    failed, infer, trains = [], {}, {}
    model = to_torch(params, cfg, dev)
    for B in ints(args.batches):
        try:
            infer[B] = inference(model, B, ints(args.depths), args.iters, dev)
        except Exception as e:  # the sweep goes on; the exit code says so
            failure(f"inference B={B}", e, failed)
    del model
    tcfg = cfg.replace(fuse_conv_pool=True, static_freeze_cnn=True)
    for B in ints(args.train_batches):
        try:
            trains[B] = train(params, tcfg, B, args.train_iters, dev)
        except Exception as e:
            failure(f"train B={B}", e, failed)
    tc.emit({"check": "throughput_tune", "device": device,
             "canvas": [cfg.image_size, cfg.image_size],
             "inference": infer, "train_frozen": trains, "failed": failed})
    if failed:
        raise SystemExit(f"failed: {failed}")
    return infer, trains


if __name__ == "__main__":
    main()
