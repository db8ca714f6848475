"""Training CLI (twin of densecap_tpu/cli/train.py).

    python -m densecap_tpu_torch.cli.train --data_h5 d.h5 --data_json d.json \
        --device cuda --batch_size 8 --max_iters 100000

Trains from random weights (`utils.checkpoint.init_params`, seeded by
`--seed`), or resumes a run of this CLI (`--checkpoint_start_from
<prefix>`: the model from `<prefix>.npz`, the Adam state, schedule count,
finetune flag and iteration from `<prefix>.optim.pt`; the loss history
starts empty and the loader at the start of the split, as in the JAX CLI).
A JAX run's orbax TrainState becomes such a pair with
`scripts/torch_import_jax_state.py`. Data: the preprocessed h5
(`python -m densecap_tpu_torch.data.preprocess`); the raw uint8 canvases are
normalized on the device, and `--canvas_buckets` crops each batch to the
smallest listed canvas that holds its images (`data.loader
.BucketedLoader`). Trunk1 never trains; trunk2 trains from
`--finetune_cnn_after` on, with fresh Adam state at the flip.

The step's losses are read a few steps late (one scalar each), so the
host does not wait for the card after every step. Every
`--losses_log_every` iterations the losses are printed and kept; a NaN
loss, or one past 100 x the first, aborts (up to 3 steps after the step
that made it). `--timing 1` prints the mean host time of the `data` and
`step` stages on log steps (the step synchronizes the card then);
`--profile_dir` writes a `torch.profiler` trace of steps 3-5 there.

Every `--save_checkpoint_every` iterations, at `--max_iters`, and after
the first iteration with `--eval_first_iteration`, it evaluates on up to
`--val_images_use` images of the val split (`eval.eval_split`, with the
loss pass) and writes `<checkpoint_path>.json` (options, iteration, loss
history, and `results_history`: the val losses and mAP of every
evaluation). Only when the val mAP beats the best so far does it also
write the pair `<checkpoint_path>.npz` (the parameters in the JAX
package's layout with `__extra__/meta`, readable by both packages'
`load_params`) and `<checkpoint_path>.optim.pt`.

Multi-process data parallel training runs one process per GPU (the JAX
CLI runs one per host), each started with the same flags and its own
`--process_id`:

    for r in 0 1 2 3; do python -m densecap_tpu_torch.cli.train ... \
        --batch_size 32 --num_processes 4 --process_id $r \
        --coordinator_address localhost:29500 & done

`--batch_size` is the global batch; each rank loads its share from a
round-robin shard of the split (or, with buckets, its slice of the shared
schedule), samples with a generator seeded `--seed` + 1 + rank (its data
index, below), and the gradients are all-reduced
(`parallel.train_step.Trainer`). Rank 0 alone evaluates, prints and
writes; the others wait for it.

`--model_parallel M` adds tensor parallelism: the N processes form
N / M data slots of M consecutive ranks, and each slot shards fc6, fc7
and the vocab projection over its ranks (`parallel/tensor_parallel.py`).
The JAX CLI meshes the local devices of one process; here every rank is
a process, so M must divide `--num_processes`, and M > 1 in a single
process is an error. The data axis is N / M: `--batch_size` must be a
multiple of it, and the loader shard and the sampler's seed (`--seed` +
1 + data index) follow the data index, so the ranks of one slot load,
sample and drop out alike. At each evaluation every rank gathers the full
parameters and Adam state; rank 0 evaluates an unsharded model of them
and writes them, so a checkpoint resumes at any M.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
from collections import deque

import torch

from ..config import DenseCapConfig
from ..data.loader import (BATCH_KEYS, BucketedLoader, DenseCapLoader,
                           PrefetchingLoader)
from ..eval.eval_split import eval_split
from ..parallel import distributed
from ..parallel.train_step import Trainer, cosine_decay_schedule
from ..utils import checkpoint as ckpt
from ..utils.profiling import StageTimer, device_trace
from ._common import NOT_PORTED, resolve_device

# Loss dicts wait this many steps before their one scalar is read.
FETCH_LAG = 3


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                epilog=NOT_PORTED)
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
    p.add_argument("--canvas_buckets", default="",
                   help="comma list of HxW canvas buckets (e.g. "
                        "'720x576,576x720'): each batch is cropped to the "
                        "smallest that holds its images; the square canvas "
                        "is always one")
    p.add_argument("--checkpoint_start_from", default="",
                   help="resume from the <prefix>.npz / <prefix>.optim.pt "
                        "pair of an earlier run")
    p.add_argument("--timing", type=int, default=0,
                   help="print the data and step stages' mean host ms on "
                        "log steps")
    p.add_argument("--profile_dir", default="",
                   help="write a torch.profiler trace of steps 3-5 here")
    # multi-process runs (parallel/distributed.py): one process per GPU,
    # the same flags, a unique --process_id
    p.add_argument("--coordinator_address", default="",
                   help="host:port of rank 0 (or a tcp:// or file:// URL)")
    p.add_argument("--num_processes", type=int, default=1)
    p.add_argument("--process_id", type=int, default=0)
    p.add_argument("--model_parallel", type=int, default=1,
                   help="ranks per model group: fc6, fc7 and the vocab "
                        "projection are sharded over them; must divide "
                        "--num_processes")
    return p


def _to_device(batch, device):
    """The batch keys (and `weight`, when the batch has one) as tensors on
    `device`; on a CUDA device from pinned memory without blocking, so
    the copy runs beside the step in flight."""
    cuda = device.type == "cuda"
    out = {}
    for k in BATCH_KEYS + ("weight",):
        if k in batch:
            t = torch.from_numpy(batch[k])
            out[k] = (t.pin_memory() if cuda else t).to(device,
                                                        non_blocking=cuda)
    out["gt_labels"] = out["gt_labels"].long()
    return out


def save_checkpoint(args, trainer, it, meta, host=None):
    """Write the pair; `host`: its (params, state) when already gathered
    from every rank (`utils.checkpoint.gather_train_state`)."""
    ckpt.write_train_state(args.checkpoint_path,
                           *(host or ckpt.gather_train_state(trainer)), it,
                           meta)
    print(f"saved checkpoint to {args.checkpoint_path}.npz")


def write_history(args, it, loss_history, results_history):
    prefix = args.checkpoint_path
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    with open(prefix + ".json", "w") as f:
        json.dump({"opt": vars(args), "iter": it,
                   "loss_history": loss_history,
                   "results_history": results_history}, f)


def data_axis(args):
    """The data axis N / M of --num_processes N and --model_parallel M,
    after the checks that the rules hold; SystemExit names the rule a
    flag breaks."""
    nproc, m = max(args.num_processes, 1), args.model_parallel
    if m < 1:
        raise SystemExit(f"--model_parallel must be >= 1, got {m}")
    if m > 1 and nproc == 1:
        raise SystemExit(
            f"--model_parallel {m} needs --num_processes: each rank of a "
            "model group is a process (one per GPU)")
    if nproc % m:
        raise SystemExit(f"--model_parallel {m} must divide --num_processes "
                         f"{nproc}")
    data = nproc // m
    if args.batch_size % data:
        if m == 1:
            raise SystemExit(f"--batch_size {args.batch_size} must divide "
                             f"evenly across {nproc} processes")
        raise SystemExit(f"--batch_size {args.batch_size} must be a multiple "
                         f"of the data axis {data} (--num_processes {nproc} "
                         f"/ --model_parallel {m})")
    return data


def main(argv=None):
    args = build_argparser().parse_args(argv)
    nproc = max(args.num_processes, 1)
    local_batch_size = args.batch_size // data_axis(args)
    rank = args.process_id if nproc > 1 else 0
    device = distributed.rank_device(resolve_device(args.device), rank)
    with contextlib.ExitStack() as stack:
        distributed.initialize(
            coordinator_address=args.coordinator_address or None,
            num_processes=nproc if nproc > 1 else None, process_id=rank,
            device=device, model_parallel=args.model_parallel)
        stack.callback(distributed.shutdown)
        _train(args, device, nproc, local_batch_size, stack)


def _train(args, device, nproc, local_batch_size, stack):
    is_main = distributed.is_main_process()
    tp = distributed.model_size() > 1

    def open_loader(**kw):
        loader = DenseCapLoader(args.data_h5, args.data_json,
                                max_gt_boxes=args.max_gt_boxes, **kw)
        stack.callback(loader.close)
        return loader

    loader = open_loader()
    # evaluation (rank 0) reads its own handle, apart from the prefetch
    # thread's
    val_loader = open_loader() if is_main else None
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
    if is_main:
        print(f"vocab_size={cfg.vocab_size} seq_length={cfg.seq_length} "
              f"device={device} processes={nproc} "
              f"model_parallel={distributed.model_size()}")
    lr = args.learning_rate
    if args.cosine_decay_steps > 0:
        lr = cosine_decay_schedule(args.learning_rate,
                                   args.cosine_decay_steps, alpha=0.02)
    it, state = 0, None
    if args.checkpoint_start_from:
        model, state = ckpt.load_train_state(args.checkpoint_start_from, cfg,
                                             device)
        it = int(state["iter"])
    else:
        model = ckpt.to_torch(ckpt.init_params(cfg, seed=args.seed), cfg,
                              device, train=True)
    trainer = Trainer(model, learning_rate=lr, beta1=args.optim_beta1,
                      beta2=args.optim_beta2, eps=args.optim_epsilon)
    if state is not None:
        trainer.load_state_dict(state)
        if is_main:
            print(f"resumed from {args.checkpoint_start_from} at iteration "
                  f"{it}")
    meta = json.dumps({
        "vocab_size": cfg.vocab_size,
        "seq_length": cfg.seq_length,
        "idx_to_token": loader.info["idx_to_token"],
        # the static freeze is a training-time choice, not the model's
        "config": cfg.replace(static_freeze_cnn=False).to_json(),
    })
    # keyed on the data index: the ranks of a model group must draw the
    # same sample and dropout masks
    data_rank, data_size = distributed.data_rank(), distributed.data_size()
    generator = torch.Generator(device=device).manual_seed(
        args.seed + 1 + data_rank)
    shard = (data_rank, data_size) if data_size > 1 else None
    if args.canvas_buckets:
        buckets = [tuple(int(v) for v in b.split("x"))
                   for b in args.canvas_buckets.split(",") if b]
        # under several processes every rank runs the same schedule over
        # the unsharded split and loads its slice of the global batch
        bucketed = BucketedLoader(
            loader, buckets, args.batch_size if shard else local_batch_size,
            split=0, shard=shard)
        prefetch = PrefetchingLoader(source=lambda: bucketed.next_batch()[1])
    else:
        train_loader = open_loader(shard=shard) if shard else loader
        prefetch = PrefetchingLoader(train_loader, local_batch_size, split=0)
    stack.callback(prefetch.close)
    tracing = contextlib.ExitStack()
    stack.callback(tracing.close)

    loss_history, results_history = {}, {}
    best_val_score = -1.0
    loss0 = None
    timer = StageTimer(enabled=bool(args.timing))
    # The step's losses wait here and are read FETCH_LAG steps late, one
    # scalar each (total_loss; the dict only on log steps), so the host
    # does not stall the card after every step. drain(True) runs before
    # every evaluation and at the end, so the history and the watchdog
    # see every step once.
    pending = deque()

    def drain(force=False):
        nonlocal loss0
        while pending and (force or len(pending) > FETCH_LAG):
            it_o, ls = pending.popleft()
            total = float(ls["total_loss"])
            if it_o % args.losses_log_every == 0:
                vals = {k: float(v) for k, v in ls.items()}
                loss_history[it_o] = vals
                if is_main:
                    print(f"iter {it_o}: {json.dumps(vals)}")
                    if args.timing:
                        print(timer.report())
            # loss explosion watchdog (train.lua:203-208) + NaN guard; the
            # losses are all-reduced, so every rank stops at the same step
            if loss0 is None:
                loss0 = total
            if total != total:
                raise SystemExit(f"loss is NaN at iter {it_o}; aborting")
            if total > 100 * loss0:
                raise SystemExit(
                    f"loss exploded ({total} > 100 x {loss0}); aborting")

    traced = False
    with timer.stage("data"):
        next_batch = _to_device(prefetch.next(), device)
    while args.max_iters < 0 or it < args.max_iters:
        batch = next_batch
        if (args.finetune_cnn_after >= 0 and it >= args.finetune_cnn_after
                and not trainer.finetune_cnn):
            trainer.set_finetune(True)
            if is_main:
                print("enabling CNN finetuning (trunk2 joins the backward)")
        if args.profile_dir and it == 2:  # trace steps 3-5
            tracing.enter_context(device_trace(
                args.profile_dir, cuda=device.type == "cuda"))
            traced = True
        with timer.stage("step"):
            losses = trainer.step(batch, generator=generator)
            if args.timing and device.type == "cuda":
                torch.cuda.synchronize(device)
        it += 1
        # the next batch's copy to the card runs beside this step
        with timer.stage("data"):
            next_batch = _to_device(prefetch.next(), device)
        if traced and it == 5:  # the profiler synchronizes the card
            tracing.close()
            traced = False
            if is_main:
                print(f"wrote a trace of steps 3-5 to {args.profile_dir}")
        pending.append((it, losses))
        drain()
        if (it % args.save_checkpoint_every == 0
                or (args.eval_first_iteration and it == 1)
                or 0 < args.max_iters == it):
            drain(force=True)
            # under tensor parallelism every rank takes part in gathering
            # the full parameters and Adam state (JAX evaluates host params)
            host = ckpt.gather_train_state(trainer) if tp else None
            if is_main:
                model = (ckpt.to_torch(host[0], cfg, device) if tp
                         else trainer.model)
                results = eval_split(model, val_loader, split=1,
                                     max_images=args.val_images_use,
                                     verbose=False)
                del model
                map_score = results["ap_results"]["map"]
                results_history[it] = {
                    "loss_results": results["loss_results"],
                    "map": map_score}
                print(f"iter {it}: val mAP {100 * map_score:.4f}")
                write_history(args, it, loss_history, results_history)
                if map_score > best_val_score:
                    best_val_score = map_score
                    # without TP, the call save_checkpoint has always
                    # had (hooks that wrap it take these four arguments)
                    if host is None:
                        save_checkpoint(args, trainer, it, meta)
                    else:
                        save_checkpoint(args, trainer, it, meta, host=host)
            distributed.barrier(device)
    drain(force=True)


if __name__ == "__main__":
    main()
