"""Inference CLI (twin of densecap_tpu/cli/run_model.py, after the
reference's run_model.lua).

    python -m densecap_tpu_torch.cli.run_model --checkpoint ck.npz \\
        --input_dir imgs/ --output_dir vis/data --device cuda

Runs the model on one image, a directory of images or a split of the
preprocessed h5, and writes `<output_dir>/results.json` in the schema of
the d3 viewer (`vis/view_results.html`): per image its name, boxes as
original-image (x, y, w, h), objectness scores and captions. With
--output_images it also writes each image with its top boxes drawn in.

A directory of JPEGs is decoded by the native pipeline (`native_lib`,
`native/dcio.cpp`) when it builds: chunks of 16 files on C++ threads, the
next chunk decoding while the model runs the current one. Otherwise, and
with --native_io 0, PIL decodes each file. --quantize int8 runs fc6/fc7
in int8 (`ops/quant.py`).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor

from .. import native_lib
from ..config import VGG_MEAN_BGR
from ..ops.boxes import xcycwh_to_xywh
from ..utils.checkpoint import load_checkpoint, to_torch
from ..utils.image import (load_image, parse_buckets, pick_bucket,
                           preprocess_for_model_uint8, to_model_input)
from ..utils.text import decode_sequence
from ._common import (NOT_PORTED, add_quantize_flag, maybe_quantize,
                      resolve_device)

NATIVE_CHUNK = 16  # files per dcio_load_batch call


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                epilog=NOT_PORTED)
    p.add_argument("--checkpoint", required=True,
                   help=".npz written by utils.checkpoint.save_params")
    p.add_argument("--input_image", default="")
    p.add_argument("--input_dir", default="")
    p.add_argument("--input_split", default="",
                   help="train|val|test (needs --data_h5 / --data_json)")
    p.add_argument("--data_h5", default="")
    p.add_argument("--data_json", default="")
    p.add_argument("--image_size", type=int, default=720)
    p.add_argument("--rpn_nms_thresh", type=float, default=0.7)
    p.add_argument("--final_nms_thresh", type=float, default=0.3)
    p.add_argument("--num_proposals", type=int, default=1000)
    p.add_argument("--pre_nms_topk", type=int, default=6000,
                   help="NMS scans only the top-K scored anchors (-1 = all)")
    p.add_argument("--boxes_to_show", type=int, default=10)
    p.add_argument("--output_dir", default="vis/data")
    p.add_argument("--output_vis", type=int, default=1,
                   help="write results.json")
    p.add_argument("--output_images", type=int, default=0,
                   help="also write each image with its boxes drawn in")
    p.add_argument("--copy_images", type=int, default=0,
                   help="copy the inputs into output_dir for the viewer")
    p.add_argument("--max_images", type=int, default=100)
    p.add_argument("--beam_size", type=int, default=0,
                   help="beam width of the caption decode (0 = greedy)")
    p.add_argument("--canvas_buckets", default="",
                   help="comma list of HxW canvases (e.g. 720x544,544x720); "
                        "each image runs on the smallest that holds it, with "
                        "the outputs of the square canvas")
    p.add_argument("--native_io", type=int, default=1,
                   help="decode an --input_dir of JPEGs with the threaded "
                        "C++ pipeline (native/dcio.cpp); PIL when it does "
                        "not build or the inputs are not all JPEG")
    p.add_argument("--fast_io", type=int, default=0,
                   help="with --native_io: decode large JPEGs at a DCT "
                        "scale that still covers the canvas, then resize "
                        "(faster; pixels not bit-identical to the exact "
                        "path, extents and box mapping identical)")
    add_quantize_flag(p)
    p.add_argument("--device", default="cuda",
                   help="torch device, e.g. cuda or cpu")
    return p


def get_input_images(args):
    if args.input_image:
        return [args.input_image]
    if args.input_dir:
        exts = (".jpg", ".jpeg", ".png", ".ppm")
        return sorted(
            os.path.join(args.input_dir, f)
            for f in os.listdir(args.input_dir)
            if f.lower().endswith(exts))[:args.max_images]
    raise SystemExit("need --input_image, --input_dir or --input_split")


def use_native_io(args, paths):
    """--native_io applies to an --input_dir of JPEGs, when libdcio loads."""
    return bool(args.native_io and args.input_dir
                and all(p.lower().endswith((".jpg", ".jpeg")) for p in paths)
                and native_lib.is_available("dcio"))


def pil_frames(paths, image_size):
    """Yields (path, uint8 canvas, h, w, scale) per file, decoded by PIL."""
    for path in paths:
        canvas, h, w, scale = preprocess_for_model_uint8(load_image(path),
                                                         image_size)
        yield path, canvas, h, w, scale


def native_frames(paths, image_size, fast_dct=False):
    """Yields (path, normalized f32 canvas, h, w, scale) per file that
    decodes, from `native_lib.load_batch` over chunks of NATIVE_CHUNK
    paths; the next chunk decodes on a thread meanwhile. A file that does
    not decode is reported and skipped."""
    chunks = [paths[i:i + NATIVE_CHUNK]
              for i in range(0, len(paths), NATIVE_CHUNK)]
    if not chunks:
        return

    def decode(chunk):
        return native_lib.load_batch(chunk, image_size, VGG_MEAN_BGR,
                                     fast_dct=fast_dct)

    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(decode, chunks[0])
        for ci, chunk in enumerate(chunks):
            canv, hts, wds, ohts, owds, _ = fut.result()
            if ci + 1 < len(chunks):
                fut = pool.submit(decode, chunks[ci + 1])
            for j, path in enumerate(chunk):
                if hts[j] == 0:
                    print(f"{path}: decode failed, skipping")
                    continue
                scale = image_size / float(max(ohts[j], owds[j]))
                yield path, canv[j], float(hts[j]), float(wds[j]), scale


def detect(model, canvas, h, w, beam_size):
    """One canvas (uint8, or normalized f32) -> its valid detections:
    canvas-coordinate xywh boxes (N, 4), scores (N,) and tokens (N, T), as
    numpy."""
    out = model.forward_test_batch(
        *to_model_input([canvas], [h], [w], model.obj_w.device),
        use_beam=beam_size)
    v = out.valid[0]
    return (xcycwh_to_xywh(out.boxes[0][v]).cpu().numpy(),
            out.scores[0][v].cpu().numpy(), out.captions[0][v].cpu().numpy())


def to_original(xywh, scale):
    """Canvas xywh -> original-image xywh (1-indexed), in place."""
    xywh[:, :2] = (xywh[:, :2] - 1) / scale + 1
    xywh[:, 2:] = xywh[:, 2:] / scale
    return xywh


def run_split(args, params, cfg, device):
    """Each image of a split of the preprocessed h5, as it is stored."""
    from ..data.loader import DenseCapLoader

    loader = DenseCapLoader(args.data_h5, args.data_json)
    try:
        # the canvas is the h5's; the vocabulary stays the checkpoint's
        model = to_torch(params, cfg.replace(image_size=loader.canvas),
                         device)
        split = {"train": 0, "val": 1, "test": 2}[args.input_split]
        n = loader.split_size(split)
        if args.max_images > 0:
            n = min(n, args.max_images)
        idx_to_token = loader.idx_to_token()
        loader.reset_iterator(split)
        results = []
        for i in range(n):
            ex = loader.get_example(split=split)
            xywh, scores, tokens = detect(model, ex["image"], ex["height"],
                                          ex["width"], args.beam_size)
            frac = float(ex["width"]) / float(loader.original_widths[ex["ix"]])
            results.append({
                "img_name": ex["filename"],
                "boxes": to_original(xywh, frac).tolist(),
                "scores": scores.tolist(),
                "captions": decode_sequence(tokens, idx_to_token,
                                            cfg.vocab_size),
            })
            print(f"{ex['filename']} ({i + 1}/{n})")
    finally:
        loader.close()
    return results


def write_results(args, results):
    path = os.path.join(args.output_dir, "results.json")
    with open(path, "w") as f:
        json.dump({"results": results}, f)
    print(f"wrote {path}")


def main(argv=None):
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    params, meta, cfg = load_checkpoint(args.checkpoint)
    params = maybe_quantize(params, args.quantize)
    cfg = cfg.replace(
        image_size=args.image_size,
        test_rpn_nms_thresh=args.rpn_nms_thresh,
        test_final_nms_thresh=args.final_nms_thresh,
        test_max_proposals=args.num_proposals,
        test_pre_nms_topk=args.pre_nms_topk)
    os.makedirs(args.output_dir, exist_ok=True)
    if args.input_split:
        write_results(args, run_split(args, params, cfg, device))
        return

    paths = get_input_images(args)
    model = to_torch(params, cfg, device)
    idx_to_token = meta.get("idx_to_token", {})
    buckets = (parse_buckets(args.canvas_buckets, args.image_size)
               if args.canvas_buckets else None)
    native = use_native_io(args, paths)
    if args.fast_io and not native:
        print("warning: --fast_io requires the native decode path "
              "(--native_io with libdcio present, --input_dir, JPEG "
              "inputs); ignored on the PIL path", file=sys.stderr)
    if native:
        print(f"native IO: threaded C++ decode for {len(paths)} images")
        frames = native_frames(paths, args.image_size, bool(args.fast_io))
    else:
        frames = pil_frames(paths, args.image_size)
    results = []
    for path, canvas, h, w, scale in frames:
        if buckets is not None:
            bh, bw = pick_bucket(h, w, buckets)
            canvas = canvas[:bh, :bw]
        xywh, scores, tokens = detect(model, canvas, h, w, args.beam_size)
        xywh = to_original(xywh, scale)
        captions = decode_sequence(tokens, idx_to_token, cfg.vocab_size)
        results.append({
            "img_name": os.path.basename(path),
            "boxes": xywh.tolist(),
            "scores": scores.tolist(),
            "captions": captions,
        })
        print(f"{path}: {len(xywh)} regions")
        if args.copy_images:
            shutil.copy(path, os.path.join(args.output_dir,
                                           os.path.basename(path)))
        if args.output_images:
            from PIL import Image

            from ..utils.vis import densecap_draw

            k = min(args.boxes_to_show, len(xywh))
            stem = os.path.splitext(os.path.basename(path))[0]
            rgb = load_image(path)
            Image.fromarray(densecap_draw(rgb, xywh[:k], captions[:k])).save(
                os.path.join(args.output_dir, stem + "_boxes.png"))
    if args.output_vis:
        write_results(args, results)


if __name__ == "__main__":
    main()
