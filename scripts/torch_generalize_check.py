"""Generalisation check of the PyTorch port: train on 160 synthetic scenes,
evaluate mAP on 16 held-out scenes (other box layouts), to show that the
port learns localisation and captioning that transfer, not a memory of
the training set.

Twin of scripts/generalize_check.py: the small config (192 px, 5
anchors, fc 256, LSTM 64), 4000 steps at B=8 from `init_params(cfg,
seed=0)`, lr cosine from 3e-4 with alpha 0.05, the trunk's finetuning on
from step 0; training scenes from seed 0, held-out scenes from seed 777.
The JAX script's `roi_align_impl="mxu"` has no twin: the port's RoI align
(K2) computes the exact bilinear sample.

    python scripts/torch_generalize_check.py [--steps N] [--device cuda|cpu]

The device rules, loss lines (every 250 steps), ms/step, busy share and
last JSON line are those of scripts/torch_overfit_sanity.py.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_overfit_sanity as overfit  # noqa: E402
import torch_synth_scenes as scenes  # noqa: E402

N_TRAIN, N_VAL = 160, 16
TRAIN_SEED, VAL_SEED = 0, 777
BATCH = 8


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    dev = overfit.card(args.device)
    device = overfit.device_line(dev)
    print(f"device: {json.dumps(device)}", flush=True)
    cfg = overfit.overfit_config()
    S = cfg.image_size
    tr = scenes.box_scenes(N_TRAIN, TRAIN_SEED, S)
    va = scenes.box_scenes(N_VAL, VAL_SEED, S)  # disjoint layouts
    trainer, stats = overfit.train(
        cfg, overfit.Scenes(tr, dev, S, S), args.steps, BATCH, alpha=0.05,
        log_every=250)
    res, counts = overfit.evaluate(
        trainer.model, overfit.Scenes(va[:4], dev, S, S, va[4]),
        overfit.BOX_IDX2TOK)
    print(f"HELD-OUT mAP: {res['map']:.4f}  detmap: {res['detmap']:.4f} "
          f"({res['score_method']}, {N_VAL} unseen scenes)")
    print(json.dumps({"check": "generalize_check", "device": device,
                      "map": res["map"], "detmap": res["detmap"],
                      "train": stats, "eval_launches": counts}))
    return res


if __name__ == "__main__":
    main()
