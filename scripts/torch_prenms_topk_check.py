"""What `test_pre_nms_topk` costs in quality on a trained flagship-geometry
model of the port: held-out mAP and the survivors' overlap at top-k -1
(every anchor), 6000 and 2000.

Twin of scripts/prenms_topk_check.py. The reference's test-time NMS scans
every anchor; the default suppresses only the 6000 best-scored proposals.
Here the flagship geometry (720 px, 12 anchors: 24 300 proposals on the
square) is trained from `init_params(cfg, seed=0)` on the JAX script's
colour scenes (`make_scenes`, byte-equal: the same draws in order), B=4,
lr cosine from 3e-4 (alpha 0.05), the trunk's finetuning on from step 0,
batches drawn by `np.random.RandomState(it)`; then 16 held-out scenes
(seed 777) are evaluated at batch 1 at each top-k, and each truncated
run's survivors are matched to the exact run's (`survivor_overlap`: the
share with an IoU >= 0.9 twin).

The trained weights are cached (`--cache`, under build/ by default, with
the config in the checkpoint's meta); a rerun skips training unless
`--retrain`. `--checkpoint` takes trained weights instead, such as those
of `scripts/torch_trained_weights_bench.py --save`, and evaluates them on
held-out scenes of their own kind (`torch_synth_scenes.caption_scenes`,
seed 777, on the 720x544 bucket: 18 360 proposals an image).

    python scripts/torch_prenms_topk_check.py [--steps 2000]
        [--checkpoint ck.npz] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import torch_tool_common as tc  # noqa: E402
import torch_overfit_sanity as overfit  # noqa: E402
import torch_synth_scenes as synth  # noqa: E402
from densecap_tpu_torch.eval.evaluator import (  # noqa: E402
    DenseCaptioningEvaluator)
from densecap_tpu_torch.ops.boxes import iou_pascal, xcycwh_to_x1y1x2y2  # noqa: E402
from densecap_tpu_torch.utils.checkpoint import (  # noqa: E402
    from_torch, load_checkpoint, save_params, to_torch)
from densecap_tpu_torch.utils.text import decode_sequence  # noqa: E402

COLORS = {
    "red": (200, 40, 40), "green": (40, 180, 40), "blue": (40, 60, 200),
    "yellow": (220, 210, 40),
}
VOCAB = ["box"] + list(COLORS)
TOK = {w: i + 1 for i, w in enumerate(VOCAB)}
IDX2TOK = {i + 1: w for i, w in enumerate(VOCAB)}
S = 720
G = 4
L = 3
CACHE = HERE.parent / "build" / "prenms_flagship_params.npz"
BATCH = 4


def make_scenes(n, seed, S=S, box_range=(60, 300)):
    """The JAX script's scenes: (images, gt_boxes, gt_labels, gt_valid,
    texts), byte-equal at its defaults."""
    lo, hi = box_range
    rng = np.random.RandomState(seed)
    images = np.zeros((n, S, S, 3), np.float32)
    gt_boxes = np.zeros((n, G, 4), np.float32)
    gt_labels = np.zeros((n, G, L), np.int32)
    gt_valid = np.zeros((n, G), bool)
    texts = []
    for i in range(n):
        img = rng.uniform(90, 130, (S, S, 3)).astype(np.float32)
        names = []
        for b in range(rng.randint(2, 4)):
            color = list(COLORS)[rng.randint(len(COLORS))]
            w, h = rng.randint(lo, hi, 2)
            x = rng.randint(1, S - w - 1)
            y = rng.randint(1, S - h - 1)
            img[y:y + h, x:x + w] = COLORS[color]
            gt_boxes[i, b] = [x + w / 2.0, y + h / 2.0, w, h]
            gt_labels[i, b, :2] = [TOK[color], TOK["box"]]
            gt_valid[i, b] = True
            names.append(f"{color} box")
        images[i] = img[:, :, ::-1] - np.array([103.9, 116.8, 123.7])
        texts.append(names)
    return images, gt_boxes, gt_labels, gt_valid, texts


def flagship_cfg(args, **kw):
    """The JAX script's config at this run's sizes."""
    return tc.model_config(
        args, vocab_size=len(VOCAB), seq_length=L, sampler_batch_size=128,
        max_gt_boxes=G, test_max_proposals=300, drop_prob=0.0, **kw)


def survivor_overlap(boxes_a, boxes_b, thresh=0.9):
    """Fraction of run-A survivors (xcycwh) having an IoU >= thresh twin
    in run B (pascal IoU, as the JAX script's)."""
    if len(boxes_a) == 0:
        return 1.0
    if len(boxes_b) == 0:
        return 0.0
    m = iou_pascal(xcycwh_to_x1y1x2y2(torch.as_tensor(boxes_a).float()),
                   xcycwh_to_x1y1x2y2(torch.as_tensor(boxes_b).float()))
    return float((m.max(1).values >= thresh).float().mean())


def caption_texts(gt_labels, gt_valid):
    words = {i + 1: w for i, w in enumerate(synth.CAPTION_WORDS)}
    return [[" ".join(words[t] for t in row if t) for row in labels[valid]]
            for labels, valid in zip(gt_labels, gt_valid)]


def train(cfg, args, dev):
    tr = make_scenes(args.n_train, 0, cfg.image_size, args.box_range)
    data = overfit.Scenes(tr, dev, cfg.image_size, cfg.image_size)
    trainer, stats = overfit.train(cfg, data, args.steps, BATCH, alpha=0.05,
                                   log_every=200)
    return trainer.model, stats


@torch.inference_mode()
def evaluate(model, va, idx2tok, topk, height, width):
    """mAP dict and each image's surviving boxes at pre-NMS top-k `topk`,
    batch 1."""
    model.cfg = model.cfg.replace(test_pre_nms_topk=topk)
    dev = model.obj_w.device
    ev = DenseCaptioningEvaluator()
    images = torch.from_numpy(va[0]).to(dev)
    h = torch.full((1,), float(height), device=dev)
    w = torch.full((1,), float(width), device=dev)
    all_boxes = []
    for i in range(len(images)):
        out = model.forward_test_batch(images[i:i + 1], h, w)
        valid = out.valid[0].cpu().numpy()
        boxes = out.boxes[0].float().cpu().numpy()[valid]
        caps = decode_sequence(out.captions[0].cpu().numpy()[valid],
                               idx2tok, model.cfg.vocab_size)
        gv = va[3][i]
        ev.add_result(out.scores[0].float().cpu().numpy()[valid], boxes,
                      caps, va[1][i][gv], va[4][i])
        all_boxes.append(boxes)
    return ev.evaluate(), all_boxes


def load_model(args, dev):
    """(inference model, held-out scenes, idx2tok, height, width, train
    stats)."""
    if args.checkpoint:
        params, _, cfg = load_checkpoint(args.checkpoint)
        cfg = cfg.replace(test_max_proposals=300)
        arrays = synth.caption_scenes(seed=777, n=args.n_val)
        va = (*arrays, caption_texts(arrays[2], arrays[3]))
        words = {i + 1: w for i, w in enumerate(synth.CAPTION_WORDS)}
        return (to_torch(params, cfg, dev), va, words, synth.CANVAS_H,
                synth.CONTENT_W, None)
    cfg = flagship_cfg(args)
    stats = None
    cache = Path(args.cache)
    if cache.exists() and not args.retrain:
        print(f"# loading cached params {cache}", flush=True)
        params, _, cfg = load_checkpoint(str(cache))
    else:
        trained, stats = train(cfg, args, dev)
        params = from_torch(trained)
        del trained
        cache.parent.mkdir(parents=True, exist_ok=True)
        save_params(str(cache), params, extra={"meta": json.dumps({
            "vocab_size": cfg.vocab_size, "seq_length": cfg.seq_length,
            "config": cfg.to_json()})})
        print(f"# params cached to {cache}", flush=True)
    va = make_scenes(args.n_val, 777, cfg.image_size, args.box_range)
    S_ = cfg.image_size
    return to_torch(params, cfg, dev), va, IDX2TOK, S_, S_, stats


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    tc.add_model_flags(ap)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--n_train", type=int, default=64)
    ap.add_argument("--n_val", type=int, default=16)
    ap.add_argument("--retrain", action="store_true")
    ap.add_argument("--cache", default=str(CACHE))
    ap.add_argument("--checkpoint", default="",
                    help="trained flagship weights (a port .npz) instead "
                         "of training")
    ap.add_argument("--topks", default="-1,6000,2000")
    ap.add_argument("--box_range", type=lambda s: tuple(map(int, s.split(","))),
                    default=(60, 300), help="the scenes' box sides lo,hi")
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    dev = tc.card(args.device)
    device = tc.print_device(dev)
    model, va, idx2tok, height, width, stats = load_model(args, dev)
    topks = [int(k) for k in args.topks.split(",")]
    results, boxes, counts = {}, {}, {}
    for topk in topks:
        t0 = time.perf_counter()
        (res, boxes[topk]), counts[topk] = tc.launches_of(
            lambda: evaluate(model, va, idx2tok, topk, height, width))
        results[topk] = {"map": res["map"], "detmap": res["detmap"],
                         "eval_s": tc.measured(time.perf_counter() - t0,
                                               dev)}
        print(f"topk={topk:6d}: mAP {res['map']:.4f} detmap "
              f"{res['detmap']:.4f}; launches {counts[topk]}", flush=True)
        if dev.type == "cuda":
            overfit.need_launches(counts[topk], ("nms", "roi_align"),
                                  f"top-k {topk}")
    exact = boxes[topks[0]]
    for topk in topks[1:]:
        ov = float(np.mean([survivor_overlap(exact[i], boxes[topk][i])
                            for i in range(len(exact))]))
        results[topk]["survivor_overlap"] = ov
        results[topk]["map_delta"] = (results[topk]["map"]
                                      - results[topks[0]]["map"])
        print(f"topk={topk}: survivor overlap vs top-k {topks[0]} {ov:.4f},"
              f" mAP delta {results[topk]['map_delta']:+.4f}", flush=True)
    Hc, Wc = va[0].shape[1:3]
    n_boxes = model.cfg.num_anchors * (Hc // 16) * (Wc // 16)
    if stats and dev.type != "cuda":  # host-clock times of CPU training
        stats = {k: tc.NOT_MEASURED if k in ("step0_s", "ms_per_step",
                                             "wall_s") else v
                 for k, v in stats.items()}
    return tc.emit({"check": "prenms_topk_check", "device": device,
                    "weights": args.checkpoint or "trained here",
                    "anchors_per_image": n_boxes, "n_val": len(va[0]),
                    "train": stats, "by_topk": results})


if __name__ == "__main__":
    main()
