"""Training CLI on one device (twin of densecap_tpu/cli/train.py).

    python -m densecap_tpu_torch.cli.train --data_h5 d.h5 --data_json d.json \
        --device cuda --batch_size 8 --max_iters 100000

Trains from random weights (`utils.checkpoint.init_params`, seeded by
`--seed`) on the preprocessed h5 (`densecap_tpu/data/preprocess.py`).
The raw uint8 canvases are normalized on the device. Trunk1 never
trains; trunk2 trains from `--finetune_cnn_after` on, with fresh Adam
state at the flip. Every `--losses_log_every` iterations the losses are
printed and kept; a NaN loss, or one past 100 x the first, aborts.

Every `--save_checkpoint_every` iterations, at `--max_iters`, and after
the first iteration with `--eval_first_iteration`, it evaluates on up to
`--val_images_use` images of the val split (`eval.eval_split`, with the
loss pass) and writes `<checkpoint_path>.json` (options, iteration, loss
history, and `results_history`: the val losses and mAP of every
evaluation). Only when the val mAP beats the best so far does it also
write `<checkpoint_path>.npz` (the parameters in the JAX package's
layout with `__extra__/meta`, readable by both packages' `load_params`)
and `<checkpoint_path>.optim.pt` (the Adam state, `torch.save`).
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from ..config import DenseCapConfig
from ..data.loader import BATCH_KEYS, DenseCapLoader, PrefetchingLoader
from ..eval.eval_split import eval_split
from ..parallel.train_step import Trainer, cosine_decay_schedule
from ..utils import checkpoint as ckpt
from ._common import resolve_device


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="torch device to train on, e.g. cuda or cpu")
    # data
    p.add_argument("--data_h5", default="data/VG-regions.h5")
    p.add_argument("--data_json", default="data/VG-regions-dicts.json")
    p.add_argument("--max_gt_boxes", type=int, default=128)
    # model / loss (train_opts.lua defaults)
    p.add_argument("--sampler_batch_size", type=int, default=256)
    p.add_argument("--sampler_high_thresh", type=float, default=0.7)
    p.add_argument("--sampler_low_thresh", type=float, default=0.3)
    p.add_argument("--train_remove_outbounds_boxes", type=int, default=1)
    p.add_argument("--mid_box_reg_weight", type=float, default=0.05)
    p.add_argument("--mid_objectness_weight", type=float, default=0.1)
    p.add_argument("--end_box_reg_weight", type=float, default=0.1)
    p.add_argument("--end_objectness_weight", type=float, default=0.1)
    p.add_argument("--captioning_weight", type=float, default=1.0)
    p.add_argument("--weight_decay", type=float, default=1e-6)
    p.add_argument("--box_reg_decay", type=float, default=5e-5)
    p.add_argument("--rnn_size", type=int, default=512)
    p.add_argument("--input_encoding_size", type=int, default=512)
    p.add_argument("--drop_prob", type=float, default=0.5)
    # optimization
    p.add_argument("--learning_rate", type=float, default=1e-5)
    p.add_argument("--cosine_decay_steps", type=int, default=-1,
                   help="cosine-decay the lr over this many steps "
                        "(-1 = constant, the reference behavior)")
    p.add_argument("--optim_beta1", type=float, default=0.9)
    p.add_argument("--optim_beta2", type=float, default=0.999)
    p.add_argument("--optim_epsilon", type=float, default=1e-8)
    p.add_argument("--max_iters", type=int, default=-1)
    p.add_argument("--batch_size", type=int, default=1, help="images per step")
    p.add_argument("--finetune_cnn_after", type=int, default=-1)
    # evaluation, checkpointing and logging
    p.add_argument("--val_images_use", type=int, default=1000,
                   help="val images per evaluation (-1 = the whole split)")
    p.add_argument("--save_checkpoint_every", type=int, default=10000,
                   help="evaluate every this many iterations; the "
                        "checkpoint is saved when val mAP improves")
    p.add_argument("--checkpoint_path", default="checkpoints/densecap")
    p.add_argument("--losses_log_every", type=int, default=10)
    p.add_argument("--eval_first_iteration", type=int, default=0,
                   help="also evaluate after the first iteration")
    p.add_argument("--seed", type=int, default=123)
    return p


def _to_device(batch, device):
    out = {k: torch.from_numpy(batch[k]).to(device) for k in BATCH_KEYS}
    out["gt_labels"] = out["gt_labels"].long()
    return out


def save_checkpoint(args, trainer, it, meta):
    prefix = args.checkpoint_path
    ckpt.save_params(prefix + ".npz", ckpt.from_torch(trainer.model),
                     extra={"meta": meta})
    torch.save({"optimizer": trainer.opt.state_dict(), "iter": it,
                "finetune_cnn": trainer.finetune_cnn}, prefix + ".optim.pt")
    print(f"saved checkpoint to {prefix}.npz")


def write_history(args, it, loss_history, results_history):
    prefix = args.checkpoint_path
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    with open(prefix + ".json", "w") as f:
        json.dump({"opt": vars(args), "iter": it,
                   "loss_history": loss_history,
                   "results_history": results_history}, f)


def main(argv=None):
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    loader = DenseCapLoader(args.data_h5, args.data_json,
                            max_gt_boxes=args.max_gt_boxes)
    # evaluation reads its own handle, apart from the prefetch thread's
    val_loader = DenseCapLoader(args.data_h5, args.data_json,
                                max_gt_boxes=args.max_gt_boxes)
    cfg = DenseCapConfig(
        vocab_size=loader.vocab_size(),
        seq_length=loader.seq_length(),
        image_size=loader.canvas,
        rpn_num_filters=256,
        sampler_batch_size=args.sampler_batch_size,
        sampler_high_thresh=args.sampler_high_thresh,
        sampler_low_thresh=args.sampler_low_thresh,
        train_remove_outbounds_boxes=bool(args.train_remove_outbounds_boxes),
        mid_box_reg_weight=args.mid_box_reg_weight,
        mid_objectness_weight=args.mid_objectness_weight,
        end_box_reg_weight=args.end_box_reg_weight,
        end_objectness_weight=args.end_objectness_weight,
        captioning_weight=args.captioning_weight,
        weight_decay=args.weight_decay,
        box_reg_decay=args.box_reg_decay,
        rnn_size=args.rnn_size,
        rnn_encoding_size=args.input_encoding_size,
        drop_prob=args.drop_prob,
        max_gt_boxes=args.max_gt_boxes,
    )
    print(f"vocab_size={cfg.vocab_size} seq_length={cfg.seq_length} "
          f"device={device}")
    lr = args.learning_rate
    if args.cosine_decay_steps > 0:
        lr = cosine_decay_schedule(args.learning_rate,
                                   args.cosine_decay_steps, alpha=0.02)
    model = ckpt.to_torch(ckpt.init_params(cfg, seed=args.seed), cfg, device,
                          train=True)
    trainer = Trainer(model, learning_rate=lr, beta1=args.optim_beta1,
                      beta2=args.optim_beta2, eps=args.optim_epsilon)
    meta = json.dumps({
        "vocab_size": cfg.vocab_size,
        "seq_length": cfg.seq_length,
        "idx_to_token": loader.info["idx_to_token"],
        # the static freeze is a training-time choice, not the model's
        "config": cfg.replace(static_freeze_cnn=False).to_json(),
    })
    generator = torch.Generator(device=device).manual_seed(args.seed + 1)
    prefetch = PrefetchingLoader(loader, args.batch_size, split=0)
    loss_history, results_history = {}, {}
    best_val_score = -1.0
    loss0 = None
    it = 0
    try:
        while args.max_iters < 0 or it < args.max_iters:
            if (args.finetune_cnn_after >= 0 and it >= args.finetune_cnn_after
                    and not trainer.finetune_cnn):
                trainer.set_finetune(True)
                print("enabling CNN finetuning (trunk2 joins the backward)")
            batch = _to_device(prefetch.next(), device)
            losses = trainer.step(batch, generator=generator)
            it += 1
            total = float(losses["total_loss"])
            if it % args.losses_log_every == 0:
                vals = {k: float(v) for k, v in losses.items()}
                loss_history[it] = vals
                print(f"iter {it}: {json.dumps(vals)}")
            # loss explosion watchdog (train.lua:203-208) + NaN guard
            if loss0 is None:
                loss0 = total
            if total != total:
                raise SystemExit(f"loss is NaN at iter {it}; aborting")
            if total > 100 * loss0:
                raise SystemExit(
                    f"loss exploded ({total} > 100 x {loss0}); aborting")
            if (it % args.save_checkpoint_every == 0
                    or (args.eval_first_iteration and it == 1)
                    or 0 < args.max_iters == it):
                results = eval_split(trainer.model, val_loader, split=1,
                                     max_images=args.val_images_use,
                                     verbose=False)
                map_score = results["ap_results"]["map"]
                results_history[it] = {
                    "loss_results": results["loss_results"],
                    "map": map_score}
                print(f"iter {it}: val mAP {100 * map_score:.4f}")
                write_history(args, it, loss_history, results_history)
                if map_score > best_val_score:
                    best_val_score = map_score
                    save_checkpoint(args, trainer, it, meta)
    finally:
        prefetch.close()
        loader.close()
        val_loader.close()


if __name__ == "__main__":
    main()
