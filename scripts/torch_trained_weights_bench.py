"""Trained-weights measurement of the PyTorch port: what the greedy
decode's early exit is worth on a card.

Random weights essentially never emit END, so the decode runs all 15
steps; a trained model ends its captions after a few words, and the
decode's loop (`models/lstm.py` `greedy_decode`) stops once every row has
emitted END. Twin of scripts/trained_weights_bench.py:

  1. train the flagship configuration (vocab 10 000, seq 15, fc 4096,
     LSTM 512; train fields sampler_batch_size 128, max_gt_boxes 4,
     drop_prob 0) for 1500 steps at B=4 on 16 synthetic 720x544 scenes
     whose captions take 2-9 words (`torch_synth_scenes.caption_scenes`),
     from `init_params(cfg, seed=0)`, lr cosine from 3e-4 (alpha 0.02),
     the trunk's finetuning on from step 0;
  2. time bench.py's program, `forward_test_batch` at B=8 on the 720x544
     canvas with 540 px of content, 1000 proposals, bf16, greedy, on the
     trained weights and on `init_params(cfg, seed=0)`, both as inference
     models (`to_torch`): CUDA events around each call, the two in turns
     (random, trained, trained, random, ...), the median of 24 calls
     each; ms and images/s, and the early exit's gain as a difference and
     a ratio;
  3. the caption lengths of that batch (every valid box of the 8 images),
     counted to the first END: mean, p50 and max, for both weights;
  4. beam 3 on one image, trained against random, the median of 12 calls
     each, in turns.

    python scripts/torch_trained_weights_bench.py [--steps N]
        [--save build/trained_flagship.npz] [--device cuda|cpu]

--save writes the trained weights as the port's checkpoint (`.npz`, with
the config in its meta; `load_checkpoint` reads it). The device rules,
loss lines (every 100 steps), ms/step and busy share are those of
scripts/torch_overfit_sanity.py; K1 and K2 must launch in the timed
calls. The last line is one JSON object with every number and the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_overfit_sanity as overfit  # noqa: E402
import torch_synth_scenes as scenes  # noqa: E402
from torch_tool_common import lengths_to_end  # noqa: E402
from densecap_tpu_torch.config import DenseCapConfig  # noqa: E402
from densecap_tpu_torch.ops.cuda import build  # noqa: E402
from densecap_tpu_torch.utils.checkpoint import (  # noqa: E402
    from_torch, init_params, save_params, to_torch)

B_TRAIN, B_BENCH = 4, 8
GREEDY_CALLS, BEAM_CALLS = 24, 12


def bench_config():
    """(inference config, training config): bench.py's program and the
    train-path fields the JAX script adds (trained_weights_bench.py:115-120)."""
    cfg = DenseCapConfig(vocab_size=10000, seq_length=scenes.CAPTION_SEQ,
                         test_max_proposals=1000)
    return cfg, cfg.replace(sampler_batch_size=128, max_gt_boxes=scenes.G,
                            drop_prob=0.0)


def length_stats(lengths):
    return {"boxes": int(len(lengths)), "mean": float(lengths.mean()),
            "p50": float(np.percentile(lengths, 50)),
            "max": int(lengths.max())}


def time_in_turns(calls, n, dev):
    """{name: median ms} of `n` calls of each fn in `calls`, in turns (the
    names in order, then reversed, ...), CUDA events around each call on
    a card (the host clock around a synchronised call on the CPU)."""
    names = list(calls)
    for name in names:  # warm-up
        calls[name]()
    times = {name: [] for name in names}
    order = names + names[::-1]
    for i in range(n * len(names)):
        name = order[i % len(order)]
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            calls[name]()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            calls[name]()
            times[name].append((time.perf_counter() - t0) * 1e3)
    return {name: statistics.median(t) for name, t in times.items()}


def measure(models, images, h, w, dev):
    """Steps 2-4 of the module's list over `models` ({"random": ...,
    "trained": ...}) on the batch (images, h, w)."""
    res = {}
    build.reset_launches()
    ms = time_in_turns({k: (lambda m=m: m.forward_test_batch(images, h, w))
                        for k, m in models.items()}, GREEDY_CALLS, dev)
    counts = dict(build.launches)
    if dev.type == "cuda":
        overfit.need_launches(counts, ("nms", "roi_align"), "forward")
    B = images.shape[0]
    clock = "CUDA events" if dev.type == "cuda" else "host clock"
    for k in models:
        res[f"greedy_{k}"] = {"ms": ms[k], "images_per_s": B / ms[k] * 1e3}
        print(f"headline {k}: {ms[k]:.2f} ms per batch of {B} "
              f"({B / ms[k] * 1e3:.1f} images/s; median of {GREEDY_CALLS} "
              f"calls, {clock})", flush=True)
    gain = ms["random"] - ms["trained"]
    res["early_exit_gain_ms"] = gain
    res["early_exit_ratio"] = ms["random"] / ms["trained"]
    res["launches"] = counts
    print(f"greedy early-exit benefit on trained weights: {gain:+.2f} ms "
          f"per batch ({res['early_exit_ratio']:.3f}x)")
    for k, m in models.items():
        out = m.forward_test_batch(images, h, w)
        caps = out.captions[out.valid].cpu().numpy()
        stats = length_stats(lengths_to_end(caps, m.cfg.vocab_size + 1))
        res[f"caption_lengths_{k}"] = stats
        print(f"caption lengths ({k}, {stats['boxes']} boxes of {B} "
              f"images): mean {stats['mean']:.2f} p50 {stats['p50']:.0f} "
              f"max {stats['max']}  (T={m.cfg.seq_length})")
    beam = time_in_turns(
        {k: (lambda m=m: m.forward_test_batch(images[:1], h[:1], w[:1],
                                              use_beam=3))
         for k, m in models.items()}, BEAM_CALLS, dev)
    for k in models:
        res[f"beam3_{k}_ms"] = beam[k]
        print(f"beam3 single-image {k}: {beam[k]:.2f} ms/image (median of "
              f"{BEAM_CALLS} calls)", flush=True)
    return res


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--save", default=None,
                    help="write the trained weights here (an .npz under "
                         "build/)")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    dev = overfit.card(args.device)
    device = overfit.device_line(dev)
    print(f"device: {json.dumps(device)}", flush=True)
    cfg, tcfg = bench_config()
    arrays = scenes.caption_scenes()
    data = overfit.Scenes(arrays, dev, scenes.CANVAS_H, scenes.CONTENT_W)
    trainer, stats = overfit.train(tcfg, data, args.steps, B_TRAIN,
                                   alpha=0.02, log_every=100)
    trained = from_torch(trainer.model)
    del trainer
    if args.save:
        save_params(args.save, trained, extra={"meta": json.dumps({
            "vocab_size": cfg.vocab_size, "seq_length": cfg.seq_length,
            "config": cfg.to_json()})})
        print(f"saved the trained flagship checkpoint to {args.save}")
    models = {"random": to_torch(init_params(cfg, seed=0), cfg, dev),
              "trained": to_torch(trained, cfg, dev)}
    del trained
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    bsel = np.random.RandomState(7).choice(data.n, B_BENCH)
    images = data.images[torch.from_numpy(bsel).to(dev)]
    h, w = data.extent(B_BENCH)
    res = measure(models, images, h, w, dev)
    print(json.dumps({"check": "trained_weights_bench", "device": device,
                      "train": stats, **res}))
    return res


if __name__ == "__main__":
    main()
