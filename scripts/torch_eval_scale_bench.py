"""The port's evaluator at Visual Genome test scale, on the host of the
card's machine.

Twin of scripts/eval_scale_bench.py. The VG test split is ~5000 images,
and the reference scores 300 detections an image (~1.5 M records). Host
phases, each on the host clock:

  1. add_result: merge the ground truth and assign each detection, per
     image (`DenseCaptioningEvaluator`, libdcgeom when it builds);
  2. the fallback caption scorer over every record;
  3. the AP grid alone: `evaluate()` with the scores pinned;
  4. the METEOR stdio protocol, the port's chunked one against the
     reference bridge's per-record round trips, over `--meteor_subset`
     records, against a scripted stand-in for the jar (a Python process
     speaking the protocol: the JAX script's fake jar, scoring by word
     overlap, whose scores must agree both ways) and against an echo
     process (the protocol's floor), extrapolated to the whole split.

The detections are the JAX script's (`synth_image`, the same draws in
order). No work runs on the card: `--device cuda` only requires the card's
machine, where the numbers mean something.

    python scripts/torch_eval_scale_bench.py [--images 5000] [--dets 300]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import textwrap
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_tool_common as tc  # noqa: E402
from densecap_tpu_torch import native_lib  # noqa: E402
from densecap_tpu_torch.eval import meteor  # noqa: E402
from densecap_tpu_torch.eval.evaluator import (  # noqa: E402
    DenseCaptioningEvaluator)

FAKE_JAR = textwrap.dedent("""
    import sys
    for line in sys.stdin:
        line = line.rstrip("\\n")
        if line.startswith("SCORE |||"):
            fields = [f.strip() for f in line.split("|||")[1:]]
            *refs, hyp = fields
            h = set(hyp.split())
            best = 0.0
            for r in refs:
                rs = set(r.split())
                inter = len(h & rs); union = len(h | rs)
                best = max(best, inter / union if union else 0.0)
            print(f"stats {best:.6f}", flush=True)
        elif line.startswith("EVAL |||"):
            print(line.split("|||")[1].strip().split()[1], flush=True)
""")

ECHO_JAR = ("import sys\n"
            "for line in sys.stdin:\n"
            "    if line.startswith('SCORE'):\n"
            "        print('stats 0.5', flush=True)\n"
            "    else:\n"
            "        print('0.5', flush=True)\n")


def synth_image(rng, n_dets, vocab):
    """One image's detections and ground truth: the JAX script's draws."""
    n_gt = rng.randint(3, 60)  # VG: ~43 regions/image
    gt_boxes = np.column_stack([
        rng.uniform(30, 600, n_gt), rng.uniform(30, 450, n_gt),
        rng.uniform(10, 200, n_gt), rng.uniform(10, 200, n_gt)])
    gt_text = [" ".join(rng.choice(vocab, rng.randint(2, 8)))
               for _ in range(n_gt)]
    picks = rng.randint(0, n_gt, n_dets)
    boxes = gt_boxes[picks] + rng.normal(0, 25, (n_dets, 4))
    boxes[:, 2:] = np.abs(boxes[:, 2:]) + 4
    text = [gt_text[p] if rng.rand() < 0.4
            else " ".join(rng.choice(vocab, rng.randint(2, 8)))
            for p in picks]
    logprobs = rng.uniform(0, 5, n_dets)
    return logprobs, boxes, text, gt_boxes, gt_text


def vocabulary():
    return np.array([f"w{i}" for i in range(800)])


def score_sync(records, cmd):
    """The reference bridge's synchronous protocol: 4 blocking pipe
    operations per record."""
    proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)
    scores = [0.0] * len(records)
    try:
        for i, rec in enumerate(records):
            refs = rec.get("references") or []
            if not refs:
                continue
            proc.stdin.write("SCORE ||| " + " ||| ".join(refs) + " ||| "
                             + rec.get("candidate", "") + "\n")
            proc.stdin.flush()
            stats = proc.stdout.readline().strip()
            proc.stdin.write(f"EVAL ||| {stats}\n")
            proc.stdin.flush()
            scores[i] = float(proc.stdout.readline().strip())
    finally:
        proc.stdin.close()
        proc.wait()
    return scores


def add_results(images, dets, seed=0, log_every=1000):
    """Phase 1: an evaluator holding `images` synthetic images of `dets`
    detections each, and its seconds."""
    rng = np.random.RandomState(seed)
    vocab = vocabulary()
    ev = DenseCaptioningEvaluator()
    t0 = time.perf_counter()
    for i in range(images):
        ev.add_result(*synth_image(rng, dets, vocab))
        if (i + 1) % log_every == 0:
            print(f"  added {i + 1}/{images} "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
    return ev, time.perf_counter() - t0


def pinned_evaluate(ev, scores):
    """Phase 3: evaluate() with the caption scores pinned -> (result, s)."""
    orig = meteor.score_captions
    meteor.score_captions = lambda records: {"scores": scores,
                                             "method": "pinned"}
    try:
        t0 = time.perf_counter()
        res = ev.evaluate()
        return res, time.perf_counter() - t0
    finally:
        meteor.score_captions = orig


def protocol(records, n_total):
    """Phase 4 against each stand-in: chunked and synchronous seconds."""
    out = {}
    full = n_total / max(len(records), 1)
    for label, src, check in (("scoring", FAKE_JAR, True),
                              ("echo", ECHO_JAR, False)):
        with tempfile.NamedTemporaryFile("w", suffix=".py",
                                         delete=False) as f:
            f.write(src)
            fake = f.name
        cmd = [sys.executable, fake]
        meteor._meteor_cmd, orig_cmd = (lambda jar: cmd), meteor._meteor_cmd
        try:
            t0 = time.perf_counter()
            s_chunk = meteor.score_captions_meteor(records, fake)
            t_chunk = time.perf_counter() - t0
            t0 = time.perf_counter()
            s_sync = score_sync(records, cmd)
            t_sync = time.perf_counter() - t0
        finally:
            meteor._meteor_cmd = orig_cmd
            os.unlink(fake)
        if check and s_chunk != s_sync:
            raise SystemExit("the chunked protocol's scores differ from the "
                             "synchronous one's")
        out[label] = {"records": len(records), "chunked_s": t_chunk,
                      "sync_s": t_sync, "ratio": t_sync / t_chunk,
                      "full_split_chunked_min": t_chunk * full / 60,
                      "full_split_sync_min": t_sync * full / 60}
        print(f"METEOR protocol/{label} ({len(records)} records): chunked "
              f"{t_chunk:.1f}s vs per-record sync {t_sync:.1f}s "
              f"({t_sync / t_chunk:.2f}x); extrapolated full split: "
              f"{t_chunk * full / 60:.1f} vs {t_sync * full / 60:.1f} min",
              flush=True)
    return out


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--images", type=int, default=5000)
    ap.add_argument("--dets", type=int, default=300)
    ap.add_argument("--meteor_subset", type=int, default=100_000)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    dev = tc.card(args.device)
    device = tc.print_device(dev)
    native = native_lib.is_available("dcgeom")
    print(f"libdcgeom: {native}", flush=True)
    ev, t_add = add_results(args.images, args.dets)
    n_rec = len(ev.records)
    print(f"add_result: {args.images} images, {n_rec} records, {t_add:.1f}s "
          f"({args.images / t_add:.0f} img/s)", flush=True)
    t0 = time.perf_counter()
    scores = meteor.score_captions_fallback(ev.records)
    t_fb = time.perf_counter() - t0
    print(f"fallback scorer: {n_rec} records, {t_fb:.1f}s "
          f"({n_rec / t_fb / 1e3:.0f}k rec/s)", flush=True)
    res, t_grid = pinned_evaluate(ev, scores)
    print(f"AP grid: {t_grid:.1f}s  mAP={res['map']:.4f} "
          f"detmap={res['detmap']:.4f}", flush=True)
    proto = protocol(ev.records[:args.meteor_subset], n_rec)
    total = t_add + t_fb + t_grid
    print(f"TOTAL time to mAP (without METEOR): {total / 60:.2f} min",
          flush=True)
    return tc.emit({
        "check": "eval_scale_bench", "device": device, "clock": "host",
        "libdcgeom": native, "images": args.images, "dets": args.dets,
        "records": n_rec, "add_result_s": t_add,
        "add_result_images_per_s": args.images / t_add,
        "fallback_s": t_fb, "fallback_records_per_s": n_rec / t_fb,
        "ap_grid_s": t_grid, "map": res["map"], "detmap": res["detmap"],
        "meteor_protocol": proto, "total_s_without_meteor": total})


if __name__ == "__main__":
    main()
