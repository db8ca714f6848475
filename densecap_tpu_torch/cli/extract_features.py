"""Feature extraction CLI (twin of densecap_tpu/cli/extract_features.py,
after the reference's extract_features.lua).

    python -m densecap_tpu_torch.cli.extract_features --checkpoint ck.npz \\
        --input_dir imgs/ --output_h5 feats.h5 --device cuda

For each image, the top --boxes_per_image regions after a final NMS at
--final_nms_thresh, written to HDF5 by the port's codec (`utils/h5.py`),
one image's rows at a time: `boxes` (N, 100, 4) original-image
(xc, yc, w, h), `feats` (N, 100, fc_dim) region codes, `valid` (N, 100)
and `paths` (N,), variable-length UTF-8 strings.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..utils import h5
from ..utils.checkpoint import load_checkpoint, to_torch
from ..utils.image import (load_image, parse_buckets, pick_bucket,
                           preprocess_for_model_uint8, to_model_input)
from ._common import (NOT_PORTED, add_quantize_flag, maybe_quantize,
                      resolve_device)


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                epilog=NOT_PORTED)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--input_txt", default="",
                   help="file with one image path per line")
    p.add_argument("--input_dir", default="")
    p.add_argument("--output_h5", required=True)
    p.add_argument("--image_size", type=int, default=720)
    p.add_argument("--boxes_per_image", type=int, default=100)
    p.add_argument("--final_nms_thresh", type=float, default=0.4)
    p.add_argument("--max_images", type=int, default=-1)
    p.add_argument("--canvas_buckets", default="",
                   help="comma list of HxW canvases (as run_model's)")
    add_quantize_flag(p)
    p.add_argument("--device", default="cuda",
                   help="torch device, e.g. cuda or cpu")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    if args.input_txt:
        with open(args.input_txt) as f:
            paths = [line.strip() for line in f if line.strip()]
    elif args.input_dir:
        exts = (".jpg", ".jpeg", ".png")
        paths = sorted(os.path.join(args.input_dir, f)
                       for f in os.listdir(args.input_dir)
                       if f.lower().endswith(exts))
    else:
        raise SystemExit("need --input_txt or --input_dir")
    if args.max_images > 0:
        paths = paths[:args.max_images]

    params, _, cfg = load_checkpoint(args.checkpoint)
    params = maybe_quantize(params, args.quantize)
    cfg = cfg.replace(image_size=args.image_size)
    model = to_torch(params, cfg, device)
    buckets = (parse_buckets(args.canvas_buckets, args.image_size)
               if args.canvas_buckets else None)
    N, K = len(paths), args.boxes_per_image
    with h5.File(args.output_h5, "w") as f:
        d_boxes = f.create_dataset("boxes", (N, K, 4), dtype=np.float32)
        d_feats = f.create_dataset("feats", (N, K, cfg.fc_dim),
                                   dtype=np.float32)
        d_valid = f.create_dataset("valid", (N, K), dtype=bool)
        for i, path in enumerate(paths):
            canvas, h, w, scale = preprocess_for_model_uint8(
                load_image(path), args.image_size)
            if buckets is not None:
                bh, bw = pick_bucket(h, w, buckets)
                canvas = canvas[:bh, :bw]
            boxes, feats, valid = model.extract_features(
                *to_model_input([canvas], [h], [w], device),
                final_nms_thresh=args.final_nms_thresh, max_boxes=K)
            boxes = boxes[0].cpu().numpy()
            # canvas -> original-image coordinates (xcycwh)
            boxes[:, :2] = (boxes[:, :2] - 1) / scale + 1
            boxes[:, 2:] = boxes[:, 2:] / scale
            d_boxes[i] = boxes
            d_feats[i] = feats[0].cpu().numpy()
            d_valid[i] = valid[0].cpu().numpy()
            print(f"{i + 1}/{N}: {path}")
        f.create_dataset("paths", data=np.asarray(
            paths, dtype=h5.string_dtype()))
    print(f"wrote {args.output_h5}")


if __name__ == "__main__":
    main()
