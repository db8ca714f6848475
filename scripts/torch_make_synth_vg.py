"""A synthetic Visual-Genome-like dataset for the port, run through the
port's preprocess (`densecap_tpu_torch.data.preprocess`) to an h5 and
json pair: the h5 the train CLI, `evaluate_model`, `run_model
--input_split` and the loader read.

Twin of scripts/make_synth_vg.py: from the same seed, the same scenes,
JPEGs, regions.json and splits.json (its `make_scene` has no framework
in it; this script keeps its own copy, so the port imports nothing of
the JAX package). Scenes are VG-like: 32-48 regions each (VG's mean is
~43), 3-8 token phrases, sources of 800x600, 600x800 and 768x768 that
the 720 px canvas really resizes; and learnable (coloured rectangles
with phrases of their colour and size).

    python scripts/torch_make_synth_vg.py --out_dir build/synthvg \\
        --n_portrait 300 --n_landscape 80 --n_square 20
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

COLORS = {
    "red": (200, 40, 40), "green": (40, 180, 40), "blue": (40, 60, 200),
    "yellow": (220, 210, 40), "purple": (150, 40, 190),
    "orange": (230, 140, 30), "white": (235, 235, 235),
    "black": (25, 25, 25),
}
FILLER = ["on", "the", "left", "right", "top", "bottom", "near", "a",
          "region", "with", "texture", "another", "standing", "alone"]


def make_scene(rng, W, H, n_regions):
    """A W x H RGB scene of n_regions coloured boxes on a grey noise
    background, and their regions (VG's x, y, width, height, phrase)."""
    img = rng.randint(85, 135, (H, W, 3)).astype(np.uint8)
    regions = []
    for _ in range(n_regions):
        name = list(COLORS)[rng.randint(len(COLORS))]
        w = int(rng.randint(30, max(31, W // 2)))
        h = int(rng.randint(30, max(31, H // 2)))
        x = int(rng.randint(1, max(2, W - w)))
        y = int(rng.randint(1, max(2, H - h)))
        img[y:y + h, x:x + w] = COLORS[name]
        size = "large" if w * h > W * H // 8 else "small"
        extra = " ".join(
            FILLER[rng.randint(len(FILLER))]
            for _ in range(rng.randint(0, 4)))
        phrase = f"a {size} {name} box" + (f" {extra}" if extra else "")
        regions.append({"phrase": phrase, "x": x, "y": y,
                        "width": w, "height": h})
    return img, regions


def write_sources(out_dir, n_portrait=300, n_landscape=80, n_square=20,
                  regions_per_image=40, val_frac=0.1, seed=0):
    """Write the scenes' JPEGs (images/), regions.json and splits.json
    under out_dir, a raw Visual Genome's layout. -> splits {"train",
    "val", "test": image ids}."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    img_dir = os.path.join(out_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    # VG-like source sizes (4:3-family); all resize on the 720 canvas
    shapes = ([(600, 800)] * n_portrait          # -> 540x720 content
              + [(800, 600)] * n_landscape       # -> 720x540 content
              + [(768, 768)] * n_square)         # -> 720x720 content
    rng.shuffle(shapes)
    data = []
    for i, (W, H) in enumerate(shapes):
        img_id = i + 1
        n_reg = int(rng.randint(regions_per_image - 8,
                                regions_per_image + 9))
        img, regions = make_scene(rng, W, H, n_reg)
        Image.fromarray(img).save(
            os.path.join(img_dir, f"{img_id}.jpg"), quality=90)
        data.append({"id": img_id, "regions": regions})
    ids = [d["id"] for d in data]
    rng.shuffle(ids)
    n_val = max(1, int(len(ids) * val_frac))
    splits = {"val": ids[:n_val], "test": ids[n_val:2 * n_val],
              "train": ids[2 * n_val:]}
    with open(os.path.join(out_dir, "regions.json"), "w") as f:
        json.dump(data, f)
    with open(os.path.join(out_dir, "splits.json"), "w") as f:
        json.dump(splits, f)
    return splits


def make_synth_vg(out_dir, n_portrait=300, n_landscape=80, n_square=20,
                  regions_per_image=40, image_size=720, max_token_length=15,
                  val_frac=0.1, seed=0, num_workers=8):
    """`write_sources` under out_dir, then the port's preprocess of them.
    -> (h5 path, json path, splits {"train", "val", "test": image ids})."""
    from densecap_tpu_torch.data import preprocess as pp

    splits = write_sources(out_dir, n_portrait, n_landscape, n_square,
                           regions_per_image, val_frac, seed)
    img_dir = os.path.join(out_dir, "images")
    h5_out = os.path.join(out_dir, "VG-regions.h5")
    json_out = os.path.join(out_dir, "VG-regions-dicts.json")
    pp.main([
        "--region_data", os.path.join(out_dir, "regions.json"),
        "--image_dir", img_dir,
        "--split_json", os.path.join(out_dir, "splits.json"),
        "--h5_output", h5_out,
        "--json_output", json_out,
        "--image_size", str(image_size),
        "--max_token_length", str(max_token_length),
        "--min_token_instances", "1",
        "--num_workers", str(num_workers),
    ])
    return h5_out, json_out, splits


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out_dir", default=str(ROOT / "build" / "synthvg"))
    ap.add_argument("--n_portrait", type=int, default=300)
    ap.add_argument("--n_landscape", type=int, default=80)
    ap.add_argument("--n_square", type=int, default=20)
    ap.add_argument("--regions_per_image", type=int, default=40)
    ap.add_argument("--image_size", type=int, default=720)
    ap.add_argument("--max_token_length", type=int, default=15)
    ap.add_argument("--val_frac", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num_workers", type=int, default=8)
    args = ap.parse_args(argv)
    h5_out, json_out, splits = make_synth_vg(
        args.out_dir, args.n_portrait, args.n_landscape, args.n_square,
        args.regions_per_image, args.image_size, args.max_token_length,
        args.val_frac, args.seed, args.num_workers)
    print(f"wrote {h5_out} ({os.path.getsize(h5_out) / 1e6:.0f} MB), "
          f"{json_out}; splits train={len(splits['train'])} "
          f"val={len(splits['val'])} test={len(splits['test'])}")


if __name__ == "__main__":
    main()
