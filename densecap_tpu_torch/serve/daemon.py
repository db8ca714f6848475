"""Directory-watching inference daemon (twin of densecap_tpu/serve/daemon.py,
after the reference's webcam/daemon.lua).

  python -m densecap_tpu_torch.serve.daemon --checkpoint ck.npz \\
      --input_dir webcam/inputs --output_dir webcam/outputs --device cuda

Kept for tools built against the reference's file-system serving
contract; prefer `serve.server` for anything new. Each scan takes the
.jpg / .jpeg / .png files of the input directory in sorted order, runs
each through the engine, writes `<stem>.json` (as `<stem>.json.tmp`, then
renamed, so a reader never sees half a file) and deletes the input. A
file that does not load (a partial write, say) is skipped and left for
the next scan.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from ..cli._common import add_quantize_flag, maybe_quantize, resolve_device
from ..utils.checkpoint import load_checkpoint
from ..utils.image import load_image
from .engine import InferenceEngine

IMAGE_EXTS = (".jpg", ".jpeg", ".png")


def scan_once(engine, input_dir, output_dir):
    """One pass over `input_dir`; returns the number of images answered."""
    handled = 0
    for name in sorted(os.listdir(input_dir)):
        if not name.lower().endswith(IMAGE_EXTS):
            continue
        path = os.path.join(input_dir, name)
        try:
            rgb = load_image(path)
        except Exception as e:  # noqa: BLE001 — a partial write, or not an
            # image: skip it, keep watching (daemon.lua:63)
            print(f"skipping {name}: {e}")
            continue
        t0 = time.time()
        result = engine.process_array(rgb)
        out_path = os.path.join(output_dir,
                                os.path.splitext(name)[0] + ".json")
        with open(out_path + ".tmp", "w") as f:
            json.dump(result, f)
        os.replace(out_path + ".tmp", out_path)
        os.remove(path)
        handled += 1
        print(f"{name}: {len(result['boxes'])} regions "
              f"in {1000 * (time.time() - t0):.0f} ms")
    return handled


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--input_dir", default="webcam/inputs")
    p.add_argument("--output_dir", default="webcam/outputs")
    p.add_argument("--image_size", type=int, default=480)
    p.add_argument("--num_proposals", type=int, default=50)
    p.add_argument("--max_boxes", type=int, default=50)
    p.add_argument("--poll_interval", type=float, default=0.05,
                   help="seconds between directory scans (daemon.lua:102)")
    add_quantize_flag(p)
    p.add_argument("--device", default="cuda",
                   help="torch device, e.g. cuda or cpu")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    params, meta, cfg = load_checkpoint(args.checkpoint)
    params = maybe_quantize(params, args.quantize)
    cfg = cfg.replace(image_size=args.image_size,
                      test_max_proposals=args.num_proposals)
    engine = InferenceEngine(params, cfg, meta.get("idx_to_token", {}),
                             device=device, max_boxes=args.max_boxes)
    print("warming up...")
    engine.warmup()
    os.makedirs(args.input_dir, exist_ok=True)
    os.makedirs(args.output_dir, exist_ok=True)
    print(f"watching {args.input_dir} -> {args.output_dir}")
    try:
        while True:
            if not scan_once(engine, args.input_dir, args.output_dir):
                time.sleep(args.poll_interval)
    finally:
        engine.close()


if __name__ == "__main__":
    main()
