"""One-command real-artifact validation of the PyTorch port (doc/REAL_DATA.md).

Twin of scripts/real_eval.py on the port's CLIs. The north-star
correctness number, dense-captioning mAP 5.70 on the Visual Genome test
split with the released checkpoint, needs three artifacts this repository
does not ship and nothing here downloads. This script is the runbook: the
day they exist, one command validates the port on them:

    python scripts/torch_real_eval.py \\
        --t7 artifacts/densecap-pretrained-vgg16.t7 \\
        --region_data artifacts/VG/region_descriptions.json \\
        --image_dir artifacts/VG/images \\
        --split_json info/densecap_splits.json \\
        --jar eval/meteor/meteor-1.5.jar

Steps (each skipped when its output already exists):
  1. check      which artifacts are present; what is missing and where
                the reference gets it (then exit 1);
  2. convert    t7 -> pretrained.npz (`densecap_tpu_torch.cli.convert_t7`);
  3. smoke      `cli.run_model` on one image (`--smoke_image`, by default
                the first JPEG of --image_dir; "" skips it), top captions
                printed;
  4. preprocess raw VG JSON + JPEGs -> h5 / json
                (`densecap_tpu_torch.data.preprocess`), unless --data_h5 /
                --data_json are given or already built;
  5. evaluate   `cli.evaluate_model` on the test split at 1000 proposals;
                the mAP beside the reference's 5.70.

Every step calls a CLI's `main` in-process with `--device` (cuda unless
`--device cpu`): this script adds no model code, so its mocked-artifact
test (tests/test_torch_real_eval.py) covers the wiring of the real run.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_tool_common as tc  # noqa: E402

DOWNLOADS = {
    "t7": ("http://cs.stanford.edu/people/karpathy/densecap/"
           "densecap-pretrained-vgg16.t7.zip  "
           "(reference scripts/download_pretrained_model.sh)"),
    "region_data": ("https://visualgenome.org/static/data/dataset/"
                    "region_descriptions.json.zip + image zips "
                    "(reference README 'Training' section)"),
    "jar": ("http://www.cs.cmu.edu/~alavie/METEOR/download/"
            "meteor-1.5.tar.gz  (reference scripts/setup_eval.sh)"),
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="real-artifact validation runbook of the port")
    p.add_argument("--t7", default="artifacts/densecap-pretrained-vgg16.t7")
    p.add_argument("--jar", default="eval/meteor/meteor-1.5.jar")
    p.add_argument("--region_data",
                   default="artifacts/VG/region_descriptions.json")
    p.add_argument("--image_dir", default="artifacts/VG/images")
    p.add_argument("--split_json", default="info/densecap_splits.json")
    p.add_argument("--data_h5", default="",
                   help="preprocessed h5 (skips the preprocess step)")
    p.add_argument("--data_json", default="")
    p.add_argument("--smoke_image", default=None,
                   help="the smoke step's image (default the first JPEG of "
                        "--image_dir; '' skips the step)")
    p.add_argument("--workdir", default="real_eval_out")
    p.add_argument("--image_size", type=int, default=720)
    p.add_argument("--min_token_instances", type=int, default=15,
                   help="preprocess vocab threshold (reference default)")
    p.add_argument("--num_workers", type=int, default=8,
                   help="preprocess worker processes")
    p.add_argument("--num_proposals", type=int, default=1000)
    p.add_argument("--max_images", type=int, default=-1,
                   help="eval image cap (-1 = full test split)")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--check_only", action="store_true",
                   help="report artifact status and exit")
    p.add_argument("--allow_fallback_scorer", action="store_true",
                   help="proceed without the METEOR jar (scores are "
                        "then NOT comparable to published numbers)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def check_artifacts(args):
    """Returns (ok, missing) and prints a status table."""
    have_pre = args.data_h5 and os.path.exists(args.data_h5) \
        and args.data_json and os.path.exists(args.data_json)
    rows = [
        ("pretrained .t7", args.t7, os.path.exists(args.t7),
         DOWNLOADS["t7"]),
        ("VG region JSON", args.region_data,
         have_pre or os.path.exists(args.region_data),
         DOWNLOADS["region_data"]),
        ("VG image dir", args.image_dir,
         have_pre or os.path.isdir(args.image_dir),
         DOWNLOADS["region_data"]),
        ("METEOR jar", args.jar,
         os.path.exists(args.jar) or args.allow_fallback_scorer,
         DOWNLOADS["jar"]),
    ]
    missing = []
    for name, path, ok, src in rows:
        print(f"  [{'ok' if ok else 'MISSING'}] {name}: {path}")
        if not ok:
            print(f"         get it: {src}")
            missing.append(name)
    return not missing, missing


def smoke_image(args):
    if args.smoke_image is not None:
        return args.smoke_image
    jpegs = sorted(glob.glob(os.path.join(args.image_dir, "*.jpg")))
    return jpegs[0] if jpegs else ""


def main(argv=None):
    args = parse_args(argv)
    dev = tc.card(args.device)
    print("== torch_real_eval: artifact check ==")
    ok, missing = check_artifacts(args)
    if args.check_only or not ok:
        if not ok:
            print(f"cannot proceed; missing: {', '.join(missing)}")
        tc.emit({"check": "real_eval", "device": tc.device_info(dev),
                 "missing": missing})
        return 0 if ok else 1
    os.makedirs(args.workdir, exist_ok=True)
    device = ["--device", str(dev)]

    # 2. convert the released checkpoint
    pretrained = os.path.join(args.workdir, "pretrained.npz")
    if os.path.exists(pretrained):
        print(f"== convert: {pretrained} exists, skipping ==")
    else:
        print("== convert: t7 -> npz ==")
        from densecap_tpu_torch.cli import convert_t7
        convert_t7.main(["--t7", args.t7, "--output", pretrained])

    # 3. smoke inference on one image (eyeball captions vs the README)
    image = smoke_image(args)
    if image and os.path.exists(image):
        print(f"== smoke: run_model on {image} ==")
        from densecap_tpu_torch.cli import run_model
        smoke_dir = os.path.join(args.workdir, "smoke")
        run_model.main([
            "--checkpoint", pretrained,
            "--input_image", image,
            "--image_size", str(args.image_size),
            "--num_proposals", str(args.num_proposals),
            "--output_dir", smoke_dir,
        ] + device)
        results = os.path.join(smoke_dir, "results.json")
        if os.path.exists(results):
            with open(results) as f:
                r = json.load(f)
            print("top captions:", r["results"][0]["captions"][:5])
    else:
        print(f"== smoke: no image at {image!r}, skipping ==")

    # 4. preprocess raw VG unless a prebuilt h5/json was given
    data_h5, data_json = args.data_h5, args.data_json
    if not (data_h5 and data_json):
        data_h5 = os.path.join(args.workdir, "VG-regions.h5")
        data_json = os.path.join(args.workdir, "VG-regions-dicts.json")
        if os.path.exists(data_h5) and os.path.exists(data_json):
            print(f"== preprocess: {data_h5} exists, skipping ==")
        else:
            print("== preprocess: raw VG -> h5 (the long one; >100 GB of "
                  "output at 720 px) ==")
            from densecap_tpu_torch.data import preprocess as pp
            pp.main([
                "--region_data", args.region_data,
                "--image_dir", args.image_dir,
                "--split_json", args.split_json,
                "--h5_output", data_h5,
                "--json_output", data_json,
                "--image_size", str(args.image_size),
                "--min_token_instances", str(args.min_token_instances),
                "--num_workers", str(args.num_workers),
            ])

    # 5. the mAP run
    print(f"== evaluate: test split, {args.num_proposals} proposals ==")
    from densecap_tpu_torch.cli import evaluate_model
    out_json = os.path.join(args.workdir, "eval_results.json")
    evaluate_model.main([
        "--checkpoint", pretrained,
        "--data_h5", data_h5,
        "--data_json", data_json,
        "--split", "test",
        "--num_proposals", str(args.num_proposals),
        "--max_images", str(args.max_images),
        "--batch_size", str(args.batch_size),
        "--out_json", out_json,
    ] + device)
    with open(out_json) as f:
        res = json.load(f)
    map_score = res.get("map", res.get("ap_results", {}).get("map"))
    print(f"== RESULT: mAP {map_score} vs reference 5.70 "
          f"(reference README; paper 5.39) ==")
    if not os.path.exists(args.jar):
        print("   NOTE: fallback scorer was used (no METEOR jar): NOT "
              "comparable to published numbers")
    tc.emit({"check": "real_eval", "device": tc.device_info(dev),
             "map": map_score, "detmap": res.get("ap_results", {}).get(
                 "detmap"), "score_method": res.get("ap_results", {}).get(
                 "score_method"), "workdir": args.workdir})
    return 0


if __name__ == "__main__":
    sys.exit(main())
