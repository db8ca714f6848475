"""Evaluation CLI (twin of densecap_tpu/cli/evaluate_model.py, after the
reference's evaluate_model.lua).

    python -m densecap_tpu_torch.cli.evaluate_model --checkpoint ck.npz \\
        --data_h5 d.h5 --data_json d.json --split test --device cuda

Runs `eval.eval_split` over a split of the preprocessed h5 and prints one
JSON line: {"map", "detmap", "loss", "score_method"}. `--data_parallel N`
shards each batch of the test pass over N GPUs (cuda:0 .. cuda:N-1 for
`--device cuda`), one replica of the model on each.
"""

from __future__ import annotations

import argparse
import json

from ..data.loader import DenseCapLoader
from ..eval.eval_split import eval_split
from ..utils.checkpoint import load_checkpoint, to_torch
from ..utils.image import parse_buckets
from ._common import (NOT_PORTED, add_quantize_flag, maybe_quantize,
                      resolve_data_parallel, resolve_device)


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                epilog=NOT_PORTED)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--data_h5", required=True)
    p.add_argument("--data_json", required=True)
    p.add_argument("--split", default="test", choices=("val", "test"))
    p.add_argument("--max_images", type=int, default=-1)
    p.add_argument("--num_proposals", type=int, default=1000)
    p.add_argument("--pre_nms_topk", type=int, default=6000,
                   help="NMS scans only the top-K scored anchors (-1 = all)")
    p.add_argument("--rpn_nms_thresh", type=float, default=0.7)
    p.add_argument("--final_nms_thresh", type=float, default=0.3)
    p.add_argument("--max_gt_boxes", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=1,
                   help="images per test pass (> 1 skips the loss pass)")
    p.add_argument("--data_parallel", type=int, default=1,
                   help="shard the batched test pass over this many devices "
                        "(requires --batch_size multiple of it)")
    p.add_argument("--skip_losses", type=int, default=0)
    p.add_argument("--beam_size", type=int, default=0,
                   help="beam width of the caption decode (0 = greedy)")
    p.add_argument("--canvas_buckets", default="",
                   help="comma list of HxW canvases (e.g. 720x544,544x720); "
                        "each batch runs on the smallest that holds it, with "
                        "the outputs of the square canvas")
    p.add_argument("--out_json", default="")
    add_quantize_flag(p)
    p.add_argument("--device", default="cuda",
                   help="torch device, e.g. cuda or cpu")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    if args.data_parallel > 1 and args.batch_size % args.data_parallel:
        raise SystemExit(
            f"--batch_size {args.batch_size} must be a multiple of "
            f"--data_parallel {args.data_parallel}")
    devices = resolve_data_parallel(args.data_parallel, device)
    loader = DenseCapLoader(args.data_h5, args.data_json,
                            max_gt_boxes=args.max_gt_boxes)
    try:
        params, _, cfg = load_checkpoint(args.checkpoint, loader.vocab_size(),
                                         loader.seq_length())
        params = maybe_quantize(params, args.quantize)
        cfg = cfg.replace(
            image_size=loader.canvas,
            test_max_proposals=args.num_proposals,
            test_rpn_nms_thresh=args.rpn_nms_thresh,
            test_final_nms_thresh=args.final_nms_thresh,
            max_gt_boxes=args.max_gt_boxes,
            test_pre_nms_topk=args.pre_nms_topk)
        buckets = (parse_buckets(args.canvas_buckets, loader.canvas)
                   if args.canvas_buckets else None)
        results = eval_split(
            to_torch(params, cfg, device), loader,
            split={"val": 1, "test": 2}[args.split],
            max_images=args.max_images, beam_size=args.beam_size,
            compute_losses=not args.skip_losses, batch_size=args.batch_size,
            canvas_buckets=buckets, devices=devices)
    finally:
        loader.close()
    print(json.dumps({
        "map": results["ap_results"]["map"],
        "detmap": results["ap_results"]["detmap"],
        "loss": results["loss_results"].get("total_loss"),
        "score_method": results["ap_results"]["score_method"],
    }))
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(results, f)


if __name__ == "__main__":
    main()
