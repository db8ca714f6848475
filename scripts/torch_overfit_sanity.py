"""Overfit sanity of the PyTorch port: train from scratch on 16 synthetic
scenes of coloured boxes captioned "<color> box" until the model detects
and captions them, then report RPN recall and the train-set mAP.

Twin of scripts/overfit_sanity.py, on the port's own entry points:
`utils.checkpoint.init_params(cfg, seed=0)` -> `to_torch(train=True)`,
`parallel.train_step.Trainer` with `cosine_decay_schedule(3e-4, steps,
alpha=0.02)` and the trunk's finetuning on from step 0, batches of 4
drawn by `np.random.RandomState(it)`; then `DenseCap.features` +
`models.localization.localize_test` for the RPN's recall@50 at IoU 0.5
on 4 images, and `forward_test_batch` at batch 1 into the evaluator over
the 16 training scenes. Fails unless detmap > 0.15 (the JAX script's
gate); prints OVERFIT SANITY PASSED when mAP > 0.2.

    python scripts/torch_overfit_sanity.py [--full] [--steps N]
        [--device cuda|cpu]

Small config: 192 px, 5 anchors, fc 256, LSTM 64, 6000 steps. --full:
the flagship geometry (720 px, 12 anchors, fc 4096, LSTM 512), 1500
steps. On a CUDA device the script needs the card and the kernels' build
(it fails without either; it never falls back to the CPU or to the plain
versions), and K2 / K2b must launch in training and K1 / K2 in the
evaluation. Prints the loss every 50 steps, the learning curve (train-set
mAP and detmap every 250 steps), ms/step on the host clock, the device
time per step under torch.profiler over 20 steps and the busy share it
gives, and a last JSON line with every number and the card's name and
power limit.
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

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE)]

import torch_synth_scenes as scenes  # noqa: E402
from torch_tool_common import card  # noqa: E402,F401 (the scripts' device rule)
from densecap_tpu_torch.config import DenseCapConfig  # noqa: E402
from densecap_tpu_torch.eval.evaluator import (  # noqa: E402
    DenseCaptioningEvaluator)
from densecap_tpu_torch.models.localization import localize_test  # noqa: E402
from densecap_tpu_torch.ops.boxes import eval_box_recall  # noqa: E402
from densecap_tpu_torch.ops.cuda import build  # noqa: E402
from densecap_tpu_torch.parallel.train_step import (  # noqa: E402
    Trainer, cosine_decay_schedule)
from densecap_tpu_torch.utils.checkpoint import init_params, to_torch  # noqa: E402
from densecap_tpu_torch.utils.text import decode_sequence  # noqa: E402

BOX_IDX2TOK = {i + 1: w for i, w in enumerate(scenes.BOX_VOCAB)}
BATCH = 4
DETMAP_GATE = 0.15   # the JAX script's assert
MAP_PASS = 0.2
BUSY_WINDOW = 20     # steps traced for the busy share
CURVE_EVERY = 250    # steps between the learning curve's evaluations


def overfit_config(full=False):
    """The JAX script's two configs (overfit_sanity.py:71-100)."""
    common = dict(vocab_size=len(scenes.BOX_VOCAB), seq_length=scenes.BOX_SEQ,
                  max_gt_boxes=scenes.G, test_max_proposals=50,
                  drop_prob=0.0)
    if full:
        # the flagship geometry: 12 anchors, fc 4096, LSTM 512
        return DenseCapConfig(image_size=720, sampler_batch_size=128,
                              **common)
    return DenseCapConfig(
        image_size=192,
        anchors=((32, 32), (64, 64), (48, 96), (96, 48), (96, 96)),
        sampler_batch_size=64, test_pre_nms_topk=-1, rnn_size=64,
        rnn_encoding_size=64, fc_dim=256, rpn_num_filters=64, **common)


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


def batch_indices(it, n, b):
    """The images of step `it`: the JAX scripts' draw."""
    return np.random.RandomState(it).choice(n, b, replace=False)


def need_launches(counts, names, path):
    if not all(counts[k] > 0 for k in names):
        raise SystemExit(f"a kernel of the {path} path never launched: "
                         f"{counts}")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _device_ms(prof):
    """Device time of a torch.profiler run: its CUDA kernels and copies,
    without user annotations (their spans cover the kernels inside)."""
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)) / 1e3


class Scenes:
    """A scene set on the device: images (n, H, W, 3) f32, gt boxes,
    labels (long) and valid, one content extent for all, and the texts
    (numpy and lists stay on the host for the evaluator)."""

    def __init__(self, arrays, dev, height, width, texts=None):
        images, gt_boxes, gt_labels, gt_valid = arrays[:4]
        self.n = len(images)
        self.images = torch.from_numpy(images).to(dev)
        self.gt_boxes = gt_boxes
        self.gt_valid = gt_valid
        self.texts = texts
        self.dev_gt = (torch.from_numpy(gt_boxes).to(dev),
                       torch.from_numpy(gt_labels).long().to(dev),
                       torch.from_numpy(gt_valid).to(dev))
        self.height, self.width = float(height), float(width)

    def extent(self, b):
        dev = self.images.device
        return (torch.full((b,), self.height, device=dev),
                torch.full((b,), self.width, device=dev))

    def batch(self, sel):
        idx = torch.from_numpy(sel).to(self.images.device)
        h, w = self.extent(len(sel))
        gb, gl, gv = (t[idx] for t in self.dev_gt)
        return {"image": self.images[idx], "height": h, "width": w,
                "gt_boxes": gb, "gt_labels": gl, "gt_valid": gv}


def launches_since(before):
    return {k: v - before[k] for k, v in build.launches.items()}


def train(cfg, data, steps, batch_size, alpha, log_every=50,
          on_log=None, busy_window=BUSY_WINDOW):
    """Train `cfg` from `init_params(cfg, seed=0)` for `steps` steps of
    `batch_size` scenes of `data` (a `Scenes`), lr cosine from 3e-4 to
    alpha * 3e-4, the trunk's finetuning on from step 0. `on_log(it,
    trainer)` runs after each loss line.

    Returns (trainer, stats): the host seconds of step 0; ms/step of the
    other steps on the host clock, outside the traced window and without
    the logging and `on_log`; on a card, the device time per step of
    `busy_window` steps from the middle of the run under torch.profiler,
    and the busy share, that device time over the untraced ms/step; and
    the kernels' launches in training."""
    dev = data.images.device
    model = to_torch(init_params(cfg, seed=0), cfg, dev, train=True)
    trainer = Trainer(model, learning_rate=cosine_decay_schedule(
        3e-4, steps, alpha=alpha))
    trainer.set_finetune(True)  # from scratch: train the trunk too
    gen = torch.Generator(device=dev).manual_seed(1)
    w0 = max(1, steps // 2 - busy_window // 2)
    window = range(w0, min(steps, w0 + busy_window))
    if dev.type != "cuda" or len(window) < 2:
        window = range(0)
    timed = {"s": 0.0, "steps": 0}
    seg = {"t": 0.0, "steps": 0}

    def close_segment(keep=True):
        _sync(dev)
        now = time.perf_counter()
        if keep:
            timed["s"] += now - seg["t"]
            timed["steps"] += seg["steps"]
        seg.update(t=now, steps=0)
        return now

    _sync(dev)
    before = dict(build.launches)
    t_train = close_segment(keep=False)
    busy = step0_s = prof = None
    for it in range(steps):
        if window and it == window.start:
            close_segment()
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        losses = trainer.step(data.batch(batch_indices(it, data.n,
                                                       batch_size)),
                              generator=gen)
        seg["steps"] += 1
        if window and it == window[-1]:
            _sync(dev)
            prof.__exit__(None, None, None)
            busy = {"steps": len(window),
                    "device_ms_per_step": _device_ms(prof) / len(window)}
            close_segment(keep=False)
        if it == 0:
            step0_s = close_segment(keep=False) - t_train
        if it % log_every == 0 or it == steps - 1:
            vals = {k: float(v) for k, v in losses.items()}
            close_segment()
            print(f"it {it:4d} total {vals['total_loss']:8.4f} "
                  f"cap {vals['captioning_loss']:7.4f} "
                  f"endobj {vals['end_objectness_loss']:6.4f} "
                  f"({time.perf_counter() - t_train:.0f}s)", flush=True)
            if on_log is not None:
                on_log(it, trainer)
            close_segment(keep=False)
    close_segment()
    counts = launches_since(before)
    ms = timed["s"] * 1e3 / timed["steps"] if timed["steps"] else None
    if busy and ms:
        busy["share"] = busy["device_ms_per_step"] / ms
    stats = {"steps": steps, "batch": batch_size, "step0_s": step0_s,
             "ms_per_step": ms, "wall_s": time.perf_counter() - t_train,
             "busy": busy, "launches": counts}
    print(f"train: {steps} steps at B={batch_size} in {stats['wall_s']:.1f} s"
          f" (host clock, evaluation included); step 0 {step0_s:.2f} s, "
          f"then {'-' if ms is None else f'{ms:.2f}'} ms/step; busy share "
          + (f"{busy['share']:.1%} ({busy['device_ms_per_step']:.2f} ms "
             f"device time per step over steps {window.start}-{window[-1]} "
             f"under torch.profiler)" if busy and "share" in busy
             else "not measured")
          + f"; launches {counts}", flush=True)
    if dev.type == "cuda":
        need_launches(counts, ("roi_align", "roi_align_bwd_feats"), "train")
    return trainer, stats


@torch.inference_mode()
def rpn_recall(model, data, n=4):
    """Recall@50 (else @10) at IoU 0.5 of the RPN's proposals, per image
    of the first n."""
    cfg, dev = model.cfg, data.images.device
    h, w = data.extent(1)
    rec = []
    for i in range(n):
        feats = model.features(data.images[i:i + 1], h, w)
        loc = localize_test(model.rpn, feats, h, w, cfg,
                            cfg.anchor_tensor(dev))
        props = loc.roi_boxes[0][loc.roi_valid[0]]
        gt = torch.from_numpy(data.gt_boxes[i][data.gt_valid[i]]).to(dev)
        stats = eval_box_recall(props, gt, ns=(10, 50))
        rec.append(stats.get("0.50_recall_at_50",
                             stats.get("0.50_recall_at_10", 0.0)))
    return rec


@torch.inference_mode()
def evaluate(model, data, idx2tok, show=0):
    """mAP and detmap of `model` on `data` through `forward_test_batch`
    at batch 1 and the evaluator; prints the first `show` images'
    captions. Returns (evaluator results, launches)."""
    cfg, dev = model.cfg, data.images.device
    h, w = data.extent(1)
    ev = DenseCaptioningEvaluator()
    _sync(dev)
    before = dict(build.launches)
    for i in range(data.n):
        out = model.forward_test_batch(data.images[i:i + 1], h, w)
        valid = out.valid[0].cpu().numpy()
        boxes = out.boxes[0].float().cpu().numpy()[valid]
        scores = out.scores[0].float().cpu().numpy()[valid]
        caps = decode_sequence(out.captions[0].cpu().numpy()[valid], idx2tok,
                               cfg.vocab_size)
        gv = data.gt_valid[i]
        ev.add_result(scores, boxes, caps, data.gt_boxes[i][gv],
                      data.texts[i])
        if i < show:
            print(f"img {i}: gt={data.texts[i]} pred={caps[:4]} "
                  f"scores={np.round(scores[:4], 2).tolist()}")
    _sync(dev)
    counts = launches_since(before)
    if dev.type == "cuda":
        need_launches(counts, ("nms", "roi_align"), "eval")
    return ev.evaluate(), counts


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="the flagship geometry at 720 px (1500 steps)")
    ap.add_argument("--steps", type=int, default=None,
                    help="training steps (default 6000, 1500 with --full)")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    dev = card(args.device)
    device = device_line(dev)
    print(f"device: {json.dumps(device)}", flush=True)
    cfg = overfit_config(args.full)
    steps = args.steps or (1500 if args.full else 6000)
    images, gt_boxes, gt_labels, gt_valid, texts = scenes.overfit_scenes(
        args.full)
    S = cfg.image_size
    data = Scenes((images, gt_boxes, gt_labels, gt_valid), dev, S, S, texts)
    curve = []

    def on_log(it, trainer):
        if it and it % CURVE_EVERY == 0:
            res, _ = evaluate(trainer.model, data, BOX_IDX2TOK)
            curve.append({"it": it, "map": res["map"],
                          "detmap": res["detmap"]})
            print(f"curve it {it}: train-set mAP {res['map']:.4f} detmap "
                  f"{res['detmap']:.4f}", flush=True)

    trainer, stats = train(cfg, data, steps, BATCH, alpha=0.02,
                           on_log=on_log)
    rec = rpn_recall(trainer.model, data)
    print("RPN recall@50 iou0.5 on 4 imgs:", [round(r, 2) for r in rec])
    res, counts = evaluate(trainer.model, data, BOX_IDX2TOK, show=3)
    print(f"train-set mAP: {res['map']:.4f}  detmap: {res['detmap']:.4f} "
          f"({res['score_method']})")
    print(json.dumps({
        "check": "overfit_sanity" + (" --full" if args.full else ""),
        "device": device, "map": res["map"], "detmap": res["detmap"],
        "rpn_recall_at_50": rec, "train": stats, "eval_launches": counts,
        "curve": curve}))
    if not res["detmap"] > DETMAP_GATE:
        raise SystemExit(f"detection never learned: detmap "
                         f"{res['detmap']:.4f} <= {DETMAP_GATE}")
    print("OVERFIT SANITY PASSED" if res["map"] > MAP_PASS else
          f"WARNING: captions weak (map <= {MAP_PASS})")
    return res


if __name__ == "__main__":
    main()
