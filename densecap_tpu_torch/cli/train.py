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
that made it). `--timing 1` switches the program's spans on and prints,
on log steps, the mean device ms of the `data` stage (the
`train.data_wait` span: the loader's next batch and its copy to the
card), of the `step` stage (`train.step`) and of the step's phases
(`train.forward`, `train.backward`, `train.grad_reduce`,
`train.optimizer`), in the JAX twin's report format; a rank other than
0 prints its own, after `rank <r>: `. Nothing synchronizes the card for
it but the report, which waits for the steps in flight.
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

One call uses all local devices, as the JAX CLI does ("train
(data-parallel over all local devices)"): with `--device cuda` (no
index) it lays its ranks over the G visible GPUs, one process per GPU
(`parallel/launch.py`); `--device cpu` and `--device cuda:k` are one
device, G = 1. `CUDA_VISIBLE_DEVICES` picks the GPUs.

One host (no `--num_processes`): the mesh is `data x model` by the JAX
CLI's single-host rule (`local_layout`): the model axis is
`--model_parallel M`, the data axis D the largest divisor of
`--batch_size` that is at most G // M (a partial mesh is fine); it
prints `mesh: data=D model=M`. When D x M > 1 it starts D x M ranks on
cuda:0 .. D x M - 1, which meet over NCCL, and exits with their status;
otherwise it trains in this process. M > G is an error.

    python -m densecap_tpu_torch.cli.train ... --batch_size 8 \
        --model_parallel 2          # 8 GPUs: mesh: data=4 model=2

Several hosts: `--num_processes N`, `--process_id h` and
`--coordinator_address host:port` mean what the JAX CLI's mean. The job
is N calls, one per host, each with the same flags and its own
`--process_id`; host 0's call serves a TCP store at the coordinator,
where the calls meet (every host must lay out the same G, and a host
whose peers do not all arrive within `launch.RENDEZVOUS_S`, 300 s, exits
non-zero). Host h starts its G ranks as global ranks h x G + r of
N x G; rank 0, on host 0, alone prints beyond the `mesh:` line that
every host call prints, evaluates and writes. The mesh follows the JAX
CLI's multi-host rule (`host_layout`): it spans all N x G devices, no
partial mesh; M must divide G (so a model group of M consecutive ranks
never spans hosts), and `--batch_size` must be a multiple of the data
axis N x G / M. When a rank fails on one host, the other hosts' calls
end their ranks and exit within seconds (`parallel/launch.py`).

    # on each of two hosts of 8 GPUs, h = 0, 1: mesh: data=16 model=1
    python -m densecap_tpu_torch.cli.train ... --batch_size 32 \
        --num_processes 2 --process_id $h --coordinator_address host0:29500

Every host reads `--data_h5`, `--data_json` and
`--checkpoint_start_from`, and rank 0 writes under `--checkpoint_path`
(as every JAX host reads the orbax state and process 0 writes): the
hosts need the same paths, meaning a shared filesystem.

A call that sees one device (G = 1) is one rank: `--device cuda:$r
--num_processes N --process_id $r` is rank r of N, the explicit
one-process-per-GPU run. With a TCP coordinator it is a host call like
any other: it meets the job, prints no `mesh:` line and starts its one
rank under the launcher's watch, so a failure on any host ends it too.
With a file:// URL as `--coordinator_address` it trains in its own
process, with no store served and no watch. Its model groups may span
calls: the ranks of one group each load the same slot of the batch, so
it keeps the rank rule (M divides N, `--batch_size` a multiple of N / M)
where the JAX rule, whose processes each feed a whole slice of the data
axis, would refuse M > 1 over one-device hosts.

    for r in 0 1 2 3; do python -m densecap_tpu_torch.cli.train ... \
        --device cuda:$r --batch_size 32 --num_processes 4 \
        --process_id $r --coordinator_address localhost:29500 & done

Under a cluster's launcher the call finds its job as the JAX CLI does
(`distributed.resolve_job`): with --num_processes > 1 or
JAX_COORDINATOR_ADDRESS set, what the flags leave unset comes from
JAX_COORDINATOR_ADDRESS, JAX_COORDINATOR_PORT, JAX_LOCAL_DEVICE_IDS and
an Open MPI or SLURM job's variables: the coordinator (mpirun's host, or
the step's first node, at a port derived from the job id), N, and the
call's GPUs, its local rank's alone, as each JAX process then sees one.
--process_id is never detected, since the JAX CLI always passes it
(default 0): give each call its own, or the job ends naming it.

    srun --nodes 2 --ntasks-per-node 8 --gpus-per-node 8 bash -c \
        'python -m densecap_tpu_torch.cli.train ... --batch_size 32 \
         --num_processes $SLURM_NTASKS --process_id $SLURM_PROCID'
    mpirun -np 16 -npernode 8 bash -c \
        'python -m densecap_tpu_torch.cli.train ... --batch_size 32 \
         --num_processes $OMPI_COMM_WORLD_SIZE \
         --process_id $OMPI_COMM_WORLD_RANK'

`--batch_size` is the global batch, fed as JAX feeds it: host h of N
reads its round-robin shard (h, N) of the split (the whole split when
N = 1) at B / N, and hands its G / M data slots contiguous slices of
that batch, so data slot d = h x G / M + j gets rows j x B / D .. of
host h's batch; a one-device call is a host of its own. With buckets
host h's batch is its slice of each batch of the schedule that every
rank runs over the whole split. Each rank reads only its rows
(`train_source`). Each rank samples with a generator seeded
`--seed` + 1 + its data index (below), and the gradients are all-reduced
(`parallel.train_step.Trainer`). Rank 0 alone evaluates, prints and
writes; the others wait for it. The history's `opt` records the ranks:
`num_processes` the world and `process_id` the rank, as the explicit run
writes them.

`--model_parallel M` adds tensor parallelism: the world's W ranks form
W / M data slots of M consecutive ranks, and each slot shards fc6, fc7
and the vocab projection over its ranks (`parallel/tensor_parallel.py`).
The batch rows and the sampler's seed (`--seed` + 1 + data index)
follow the data index, so the ranks of one slot load, sample and drop
out alike. At each evaluation every rank gathers the full parameters
and Adam state; rank 0 evaluates an unsharded model of them and writes
them, so a checkpoint resumes at any M.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
from collections import deque

import torch

from ..config import DenseCapConfig
from ..data.loader import (BATCH_KEYS, BucketedLoader, DenseCapLoader,
                           PrefetchingLoader)
from ..eval.eval_split import eval_split
from ..parallel import distributed, launch
from ..parallel.train_step import Trainer, cosine_decay_schedule
from ..utils import checkpoint as ckpt
from ..utils.profiling import StageTimer, device_trace, set_recording, span
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
                   help="print the data and step stages' and the step's "
                        "phases' mean device ms on log steps")
    p.add_argument("--profile_dir", default="",
                   help="write a torch.profiler trace of steps 3-5 here")
    # multi-host runs (as the JAX CLI's): one call per host with the same
    # coordinator address and a unique --process_id; each call starts a
    # rank per local device (parallel/launch.py)
    p.add_argument("--coordinator_address", default="",
                   help="host:port of process 0 (multi-host runs; a "
                        "one-device call may give a tcp:// or file:// URL)")
    p.add_argument("--num_processes", type=int, default=1,
                   help="hosts of the job, one call each")
    p.add_argument("--process_id", type=int, default=0,
                   help="this call's host, 0 .. --num_processes - 1")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="ranks per model group: fc6, fc7 and the vocab "
                        "projection are sharded over them; the call lays "
                        "a data x model mesh over the job's devices")
    return p


# `--timing`: the spans reported, by the stage each is reported as
TIMING_SPANS = {"train.data_wait": "data", "train.step": "step",
                "train.forward": "train.forward",
                "train.backward": "train.backward",
                "train.grad_reduce": "train.grad_reduce",
                "train.optimizer": "train.optimizer"}


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


def local_layout(n_devices, model_parallel, batch_size):
    """(data, model) of one call over `n_devices` local devices, the JAX
    CLI's single-host rule (`densecap_tpu/cli/train.py`): model =
    --model_parallel, data = the largest divisor of --batch_size that is
    at most n_devices // model. SystemExit names the rule a flag breaks."""
    m = model_parallel
    if m < 1:
        raise SystemExit(f"--model_parallel must be >= 1, got {m}")
    avail = n_devices // m
    if avail < 1:
        raise SystemExit(
            f"--model_parallel {m} needs --num_processes or {m} visible "
            f"GPUs, {n_devices} device(s) here: the data axis is the "
            f"largest divisor of --batch_size at most devices // "
            f"model_parallel = {n_devices} // {m} = 0")
    return max(d for d in range(1, avail + 1) if batch_size % d == 0), m


def host_layout(n_hosts, local_devices, model_parallel, batch_size):
    """(data, model) of a job of `n_hosts` calls of `local_devices` (G)
    devices each, the JAX CLI's multi-host rule (`densecap_tpu/cli/
    train.py`: the batch check after `initialize`, and the `if nproc > 1`
    branch of the mesh): the mesh spans all N x G devices, so data = N x G
    // M with no partial mesh; M must divide N x G, the data axis must
    divide evenly across the N hosts and `--batch_size` must divide
    across the hosts and be a multiple of the data axis. SystemExit names
    the rule a flag breaks.

    data % N == 0 is M dividing G: each host holds G / M whole model
    groups, so the port's model groups of M consecutive global ranks
    (`parallel/distributed.py:_build_groups`), h x G + r for r < G, never
    span hosts."""
    n, g, m = n_hosts, local_devices, model_parallel
    if m < 1:
        raise SystemExit(f"--model_parallel must be >= 1, got {m}")
    if batch_size % n:
        raise SystemExit(f"--batch_size {batch_size} must divide evenly "
                         f"across {n} processes")
    data = n * g // m
    if data < 1 or (n * g) % m:
        raise SystemExit(f"--model_parallel {m} does not divide the {n * g} "
                         f"devices of {n} hosts x {g}")
    if data % n:
        raise SystemExit(f"data axis {data} must divide evenly across {n} "
                         f"processes: --model_parallel {m} must divide each "
                         f"host's {g} devices")
    if batch_size % data:
        raise SystemExit(f"multi-host runs use ALL devices: --batch_size "
                         f"{batch_size} must be a multiple of the data axis "
                         f"{data}")
    return data, m


def data_axis(world, model_parallel, batch_size):
    """The data axis W / M of a world of W ranks (one process each) and
    --model_parallel M, after the checks that the rank rule holds;
    SystemExit names the rule a flag breaks."""
    m = model_parallel
    if m < 1:
        raise SystemExit(f"--model_parallel must be >= 1, got {m}")
    if world % m:
        raise SystemExit(f"--model_parallel {m} must divide --num_processes "
                         f"{world}")
    data = world // m
    if batch_size % data:
        if m == 1:
            raise SystemExit(f"--batch_size {batch_size} must divide evenly "
                             f"across {world} processes")
        raise SystemExit(f"--batch_size {batch_size} must be a multiple of "
                         f"the data axis {data} (--num_processes {world} / "
                         f"--model_parallel {m})")
    return data


def local_devices(device, ids=None):
    """The devices one call may lay its mesh over: for a CUDA device that
    names no index every visible GPU, or those of `ids` (ordinals among
    the visible GPUs: JAX_LOCAL_DEVICE_IDS or the cluster's local rank,
    `distributed.resolve_job`); else `device` alone."""
    if device.type != "cuda" or device.index is not None:
        return [device]
    count = torch.cuda.device_count()
    if ids is None:
        return [torch.device("cuda", i) for i in range(count)]
    if not all(0 <= i < count for i in ids):
        raise SystemExit(f"local device ids {ids} (JAX_LOCAL_DEVICE_IDS, "
                         f"or the cluster's local rank) name a GPU this "
                         f"host does not have: {count} visible")
    return [torch.device("cuda", i) for i in ids]


def main(argv=None, devices=None, backend=None, command=None):
    """The CLI. A process that `parallel.launch` started trains as the
    rank it was given. Otherwise the call finds its job as the JAX CLI
    would (`distributed.resolve_job`: its flags, the JAX_* variables, a
    SLURM or Open MPI job's), lays its mesh over `devices` (default
    `local_devices`, over the job's local device ids when it has them),
    alone on its host (`local_layout`) or as host h of N (`host_layout`),
    and either trains here (one device, alone or at a file:// store) or
    starts its ranks (`parallel.launch.launch` with `backend` and
    `command`: the tests start CPU ranks over gloo with a body of their
    own, chip_smoke.py gloo ranks on cuda:0)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_argparser().parse_args(argv)
    rank = distributed.launched()
    if rank is not None:
        (device, args.process_id, args.num_processes,
         args.coordinator_address, local) = rank
        _run(args, device, store=launch.rank_store(args.coordinator_address),
             local=local)
        return
    found = distributed.resolve_job(args.coordinator_address,
                                    args.num_processes, args.process_id)
    ids = None
    if found is not None:
        (args.coordinator_address, args.num_processes, args.process_id,
         ids) = found
    device = resolve_device(args.device)
    devices = (local_devices(device, ids) if devices is None
               else list(devices))
    hosts = max(args.num_processes, 1)
    if hosts == 1:
        data, model = local_layout(len(devices), args.model_parallel,
                                   args.batch_size)
        print(f"mesh: data={data} model={model}", flush=True)
        if data * model == 1:
            _run(args, torch.device(devices[0]))
            return
        code = launch.launch(argv, devices[:data * model], backend=backend,
                             command=command)
    else:
        if len(devices) == 1 and not launch.tcp_address(
                args.coordinator_address):  # one rank at a file:// store
            _run(args, torch.device(devices[0]))
            return
        job = launch.HostJob(args.coordinator_address, args.process_id,
                             hosts)
        job.meet(len(devices))
        if len(devices) > 1:
            data, model = host_layout(hosts, len(devices),
                                      args.model_parallel, args.batch_size)
            print(f"mesh: data={data} model={model}", flush=True)
        code = launch.launch(argv, devices, backend=backend, command=command,
                             job=job)
    if code:
        raise SystemExit(code)


def _run(args, device, store=None, local=1):
    """Train in this process: a single-process run, or rank --process_id
    of --num_processes (meeting in `store`, when given, else at
    --coordinator_address). local: G, the ranks of this rank's host
    call (1 for a one-device call, a host of its own)."""
    nproc = max(args.num_processes, 1)
    local_batch_size = args.batch_size // data_axis(
        nproc, args.model_parallel, args.batch_size)
    rank = args.process_id if nproc > 1 else 0
    with contextlib.ExitStack() as stack:
        distributed.initialize(
            coordinator_address=args.coordinator_address or None,
            num_processes=nproc if nproc > 1 else None, process_id=rank,
            device=device, model_parallel=args.model_parallel, store=store)
        stack.callback(distributed.shutdown)
        _train(args, device, nproc, local_batch_size, stack,
               host_slots=max(local // distributed.model_size(), 1))


def train_source(args, loader, open_loader, data_rank, data_size,
                 local_batch_size, host_slots=1):
    """The zero-argument callable that yields this rank's training
    batches, JAX's feed (`densecap_tpu/cli/train.py`): data slot
    `data_rank` of `data_size` is slot j of the `host_slots` data slots
    of feed host h (d = h x host_slots + j), and gets rows j x b ..
    (j + 1) x b - 1, b = `local_batch_size`, of host h's batch, as
    `make_array_from_process_local_data` hands a host's batch to its
    devices. Feed host h of H = data_size / host_slots reads its
    round-robin shard (h, H) of the split (opened by
    `open_loader(shard=...)`), or the unsharded `loader` when H = 1, at
    B / H. With --canvas_buckets every rank runs the bucket schedule
    over the unsharded `loader`, and host h's batch is its slice of each
    global batch (`BucketedLoader`'s shard). The rank reads only its rows
    and passes over the others unread, so its loader's generator draws
    as the host's would (`rows`).

    host_slots: G / M for a rank that its host's call launched over G
    devices, 1 for a one-device call (a host of its own)."""
    hosts = data_size // host_slots
    j = data_rank % host_slots
    shard = (data_rank // host_slots, hosts) if hosts > 1 else None
    rows = (j * local_batch_size, (j + 1) * local_batch_size)
    if args.canvas_buckets:
        buckets = [tuple(int(v) for v in b.split("x"))
                   for b in args.canvas_buckets.split(",") if b]
        bucketed = BucketedLoader(loader, buckets, args.batch_size, split=0,
                                  shard=shard, rows=rows)
        return lambda: bucketed.next_batch()[1]
    train_loader = open_loader(shard=shard) if shard else loader
    return lambda: train_loader.get_batch(args.batch_size // hosts, 0,
                                          rows=rows)


def _train(args, device, nproc, local_batch_size, stack, host_slots=1):
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
    prefetch = PrefetchingLoader(source=train_source(
        args, loader, open_loader, data_rank, data_size, local_batch_size,
        host_slots))
    stack.callback(prefetch.close)
    tracing = contextlib.ExitStack()
    stack.callback(tracing.close)

    loss_history, results_history = {}, {}
    best_val_score = -1.0
    loss0 = None
    timer = StageTimer(enabled=bool(args.timing), spans=TIMING_SPANS)
    if args.timing:
        stack.callback(set_recording, set_recording(True))
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
                elif args.timing:
                    print(f"rank {distributed.rank()}: {timer.report()}")
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
    with span("train.data_wait", device):
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
        losses = trainer.step(batch, generator=generator)
        it += 1
        # the next batch's copy to the card runs beside this step
        with span("train.data_wait", device):
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
                    save_checkpoint(args, trainer, it, meta, host=host)
            distributed.barrier(device)
    drain(force=True)


if __name__ == "__main__":
    main()
