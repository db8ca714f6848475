"""Data-parallel inference of the port across GPUs: images/s of
`eval_split` and of the serving engine with 1, 2, 4, ... replicas, one per
GPU (`--data_parallel`), and each run's answers against one replica's.

    python scripts/torch_data_parallel.py [--replicas 1,2,4]

The flagship model at full width (`chip_smoke.FLAGSHIP`: VGG-16, fc
4096, vocab 10 000, 720 px canvas, 1000 proposals, bf16), weights from
seed 0. With R replicas the batch is 8 R, so every replica runs shards of
8 frames, as one replica at batch 8 does. Eval over 96 frames must give
one replica's map and detmap (within 1e-6), or the script fails. The
engine serves 128 concurrent 720x540 frames; each request's answer is
held to one replica's (captions equal, boxes within rtol 1e-4 / atol
1e-3) and each setting's second run to its first, and the counts and
the largest box gap are printed. So is the spread of one batch forward:
on the first card again, on a side stream there, and on a copy on each
other card. Runs in turns, R ascending then descending; host clock, the
evaluator included in eval. K1 and K2 must launch in every run. Prints
the cards (name and power limit) and one JSON line. Needs as many GPUs
as the largest R.
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

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (FLAGSHIP, MemoryLoader, check_result,  # noqa: E402
                        eval_examples, need_launches, read_launches,
                        same_answer, timed_batch)
from densecap_tpu_torch.eval.eval_split import eval_split  # noqa: E402
from densecap_tpu_torch.ops.cuda import build  # noqa: E402
from densecap_tpu_torch.parallel.mesh import (data_devices,  # noqa: E402
                                              replicate)
from densecap_tpu_torch.serve.engine import InferenceEngine  # noqa: E402
from densecap_tpu_torch.utils.checkpoint import (init_params,  # noqa: E402
                                                 to_torch)
from densecap_tpu_torch.utils.image import (  # noqa: E402
    preprocess_for_model_uint8, to_model_input)


def forward_spread(model, devices, canvases, hs, ws):
    """The model's batch forward on `devices[0]` against the same forward
    again, on a side stream there, and on a copy on each other device:
    max |d| of boxes and scores, the share of rows with equal captions,
    and whether `valid` is equal."""
    def run(m, dev, stream=None):
        with torch.cuda.device(dev), torch.cuda.stream(
                stream or torch.cuda.current_stream(dev)):
            o = m.forward_test_batch(*to_model_input(canvases, hs, ws, dev))
            torch.cuda.current_stream(dev).synchronize()
        return {k: getattr(o, k).cpu()
                for k in ("boxes", "scores", "captions", "valid")}

    home = devices[0]
    ref = run(model, home)
    runs = {f"{home} again": run(model, home),
            f"{home} side stream": run(model, home, torch.cuda.Stream(home))}
    for dev in devices[1:]:
        runs[str(dev)] = run(replicate(model, dev), dev)
    return {k: {"boxes": float((o["boxes"] - ref["boxes"]).abs().max()),
                "scores": float((o["scores"] - ref["scores"]).abs().max()),
                "captions_equal": float((o["captions"] == ref["captions"])
                                        .all(-1).float().mean()),
                "valid_equal": bool(torch.equal(o["valid"], ref["valid"]))}
            for k, o in runs.items()}


def answer_gap(a, b):
    """Two answers to one frame: (captions equal, boxes of equal count,
    max |d box| in px or None)."""
    same_n = len(a["boxes"]) == len(b["boxes"])
    gap = (float(np.abs(np.subtract(a["boxes"], b["boxes"])).max())
           if same_n and len(a["boxes"]) else None)
    return a["captions"] == b["captions"], same_n, gap


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--replicas", default="1,2,4",
                    help="comma list of replica counts, one GPU each")
    args = ap.parse_args(argv)
    counts = sorted({int(r) for r in args.replicas.split(",")})
    if not torch.cuda.is_available():
        raise SystemExit("torch_data_parallel: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    devices = {r: data_devices(r, "cuda") for r in counts}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(f"[cards] {smi}")
    build.load()
    params = init_params(FLAGSHIP, seed=0)
    vocab = {i: f"w{i}" for i in range(1, FLAGSHIP.vocab_size + 1)}
    model = to_torch(params, FLAGSHIP, devices[counts[0]][0])
    order = counts + counts[::-1]
    rng = np.random.default_rng(4)
    frames = [rng.integers(0, 256, (540, 720, 3), dtype=np.uint8)
              for _ in range(128)]
    canvases = [preprocess_for_model_uint8(f, FLAGSHIP.image_size)
                for f in frames[:8]]
    spread = forward_spread(model, devices[counts[-1]],
                            [c[0] for c in canvases],
                            [c[1] for c in canvases],
                            [c[2] for c in canvases])
    print(f"[forward] 8 frames, max |d| against the first card's forward: "
          f"{spread}")

    loader = MemoryLoader(eval_examples(FLAGSHIP, n=96), vocab)
    eval_rate, aps, launches = {}, {}, {}
    for r in order:
        t0 = time.perf_counter()
        res, c = read_launches(lambda: eval_split(
            model, loader, split=1, batch_size=8 * r, verbose=False,
            compute_losses=False, devices=devices[r]))
        eval_rate.setdefault(r, []).append(96 / (time.perf_counter() - t0))
        aps[r] = (res["ap_results"]["map"], res["ap_results"]["detmap"])
        launches.setdefault(f"eval {r}", c)
        need_launches(c, ("nms", "roi_align"), f"eval over {r} replica(s)")
    print(f"[eval] 96 frames, batch 8 per replica, images/s by replicas "
          f"(order {order}): {eval_rate}; map, detmap {aps}")
    del model

    engines = {r: InferenceEngine(params, FLAGSHIP, vocab,
                                  device=devices[r][0], batch_size=8 * r,
                                  batch_window_ms=50.0, devices=devices[r])
               for r in counts}
    rate, answers = {}, {}
    try:
        for e in engines.values():
            e.warmup()
            timed_batch(e, frames[:32])
        for r in order:
            (wall, results), c = read_launches(
                lambda: timed_batch(engines[r], frames))
            rate.setdefault(r, []).append(len(frames) / wall)
            answers.setdefault(r, []).append(results)
            launches.setdefault(f"engine {r}", c)
            need_launches(c, ("nms", "roi_align"),
                          f"engine over {r} replica(s)")
    finally:
        for e in engines.values():
            e.close()
    base = counts[0]
    # each run against one replica's first run; "again": a count's second
    # run against its first (batches form by arrival, so this is the
    # spread of one setting)
    pairs = {**{r: (answers[base][0], answers[r][-1])
                for r in counts if r != base},
             **{f"{r} again": tuple(answers[r]) for r in counts}}
    agree, gaps = {}, {}
    for k, (a, b) in pairs.items():
        agree[k] = sum(map(same_answer, a, b))
        g = [answer_gap(x, y) for x, y in zip(a, b)]
        box = [x[2] for x in g if x[2] is not None]
        gaps[k] = {"captions_differ": sum(not x[0] for x in g),
                   "box_count_differs": sum(not x[1] for x in g),
                   "max_box_gap_px": max(box) if box else None}
    for runs in answers.values():
        for results in runs:
            for res in results:
                check_result(res, 50)
    print(f"[engine] 128 concurrent 720x540 frames, batch 8 per replica, "
          f"images/s by replicas (order {order}): {rate}; requests "
          f"answered as {base} replica(s) answer them: {agree} of "
          f"{len(frames)}; where they differ {gaps}")
    print(f"[cards] {smi}")
    print(json.dumps({
        "cards": smi.splitlines(), "eval_images_per_s": eval_rate,
        "eval_map_detmap": aps, "engine_images_per_s": rate,
        "engine_agree": agree, "engine_gaps": gaps,
        "forward_spread": spread, "launches": launches}))
    bad_eval = [r for r in counts
                if max(abs(a - b) for a, b in zip(aps[r], aps[base])) > 1e-6]
    if bad_eval:
        raise SystemExit(f"replicas disagree with one in eval: {bad_eval}")


if __name__ == "__main__":
    main()
