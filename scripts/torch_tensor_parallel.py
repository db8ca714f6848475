"""Tensor-parallel training of the port across GPUs (`--model_parallel`):
ms/step, images/s and peak memory per rank at (data, model) layouts, and
each layout's steps held to one GPU's from the same state.

    python scripts/torch_tensor_parallel.py [--layouts 1x1,1x2,1x4,2x2]
        [--steps 6]

The flagship train step at full width (`chip_smoke.FLAGSHIP`: VGG-16, fc
4096, vocab 10 000, LSTM 512; bf16, K3 on), weights from seed 0, one
process per GPU over NCCL (a layout D x M runs D * M processes on
cuda:0 .. D*M-1; 1x1 is one process without a group). Every layout trains
on the same global batches of 8 540x720 frames (a data slot loads 8 / D
of them) with dropout off, the trunk frozen and the sampler pinned by
debug ordinals.

Parity: 1x1 runs first and writes its pair (`save_train_state`) and the
mask of its large gradients (|g| above 1e-3 of its parameter's largest)
after each of its first PARITY steps. Every other layout takes step 1
from the seed-0 weights and step k > 1 from 1x1's pair after step k - 1,
so each step is held to 1x1's from the same state: the losses, the
gathered parameters, and those where 1x1's |g| is large, within
`chip_smoke.within_reference`'s bounds (where |g| is large, the bf16
bound of chip_smoke's [tensor parallel]). The parity steps run without
cuDNN, whose conv algorithm depends on the batch's size (a data slot
convolves 8 / D frames), so the trunk's features do not depend on D;
they are not timed.

Timing: then WARMUP + --steps steps with cuDNN, each timed with CUDA
events on every rank (the step's collectives included); the median of
the last --steps. Prints the cards (name and power limit) and one JSON
line; exits non-zero if a layout leaves a bound. Needs as many GPUs as
the largest layout.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (B, FLAGSHIP, TP_LARGE_G, cpu_params,  # noqa: E402
                        describe, make_train_batch, to_dev, within_reference)
from densecap_tpu_torch.ops.cuda import build  # noqa: E402
from densecap_tpu_torch.parallel import distributed  # noqa: E402
from densecap_tpu_torch.parallel.train_step import Trainer  # noqa: E402
from densecap_tpu_torch.utils.checkpoint import (  # noqa: E402
    from_torch, init_params, load_train_state, save_params, save_train_state,
    to_torch)

PARITY = 2
WARMUP = 2
LR = 1e-5


def large_g(model):
    """{name: where |g| is above 1e-3 of the parameter's largest |g|} on
    the CPU, for the parameters that took a gradient."""
    out = {}
    for n, p in model.named_parameters():
        if p.grad is not None:
            g = p.grad.detach().abs()
            out[n] = (g > 1e-3 * g.max()).cpu()
    return out


def run_rank(rank, data, model, steps, tmp):
    """One rank of a layout: its parity steps, then WARMUP + steps timed
    ones on its data slot's share of the global batches -> a JSON file."""
    world = data * model
    tag = f"{data}x{model}"
    dev = torch.device("cuda", rank)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if world > 1:
        distributed.initialize(init_method=f"file://{tmp}/{tag}",
                               num_processes=world, process_id=rank,
                               device=dev, model_parallel=model)
    try:
        cfg = FLAGSHIP.replace(fuse_conv_pool=True, drop_prob=0.0)
        rng = np.random.default_rng(23)
        share = B // data
        d = distributed.data_rank()
        batches = [{k: v[d * share:(d + 1) * share] for k, v in
                    make_train_batch(rng, cfg, B, (540, 720), 30).items()}
                   for _ in range(PARITY + WARMUP + steps)]
        half = cfg.sampler_batch_size // 2
        drng = np.random.default_rng(5)
        dbg = {"pos": torch.from_numpy(drng.permutation(half)).to(dev),
               "neg": torch.from_numpy(
                   drng.permutation(cfg.sampler_batch_size)).to(dev)}
        trainer = Trainer(to_torch(init_params(cfg, seed=0), cfg, dev,
                                   train=True), learning_rate=LR)
        losses = []
        with torch.backends.cudnn.flags(enabled=False):
            for k in range(PARITY):
                if k and world > 1:
                    del trainer
                    net, state = load_train_state(f"{tmp}/ref{k}", cfg, dev)
                    trainer = Trainer(net, learning_rate=LR)
                    trainer.load_state_dict(state)
                out = trainer.step(to_dev(batches[k], dev), debug_sampler=dbg)
                losses.append({k_: float(v) for k_, v in out.items()})
                if world == 1:
                    save_train_state(f"{tmp}/ref{k + 1}", trainer, k + 1,
                                     "{}")
                    torch.save(large_g(trainer.model),
                               f"{tmp}/ref{k + 1}.big")
                else:
                    tree = from_torch(trainer.model)
                    if rank == 0:
                        save_params(f"{tmp}/{tag}{k + 1}.npz", tree)
                    del tree
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        build.reset_launches()
        ms = []
        for batch in batches[PARITY:]:
            batch = to_dev(batch, dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            trainer.step(batch, debug_sampler=dbg)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        result = {"rank": rank, "ms": ms, "losses": losses,
                  "peak_bytes": torch.cuda.max_memory_allocated(dev),
                  "launches": dict(build.launches),
                  "device": torch.cuda.get_device_name(dev)}
        Path(f"{tmp}/{tag}.{rank}.json").write_text(json.dumps(result))
    finally:
        distributed.shutdown()


def run_layout(data, model, steps, tmp):
    """Start the layout's ranks, wait for them -> their results."""
    world = data * model
    tag = f"{data}x{model}"
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--rank", str(r), "--data", str(data),
         "--model", str(model), "--steps", str(steps), "--tmp", tmp],
        cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise SystemExit(f"layout {tag}: a rank failed:\n{out[-4000:]}")
    return [json.loads(Path(f"{tmp}/{tag}.{r}.json").read_text())
            for r in range(world)]


def parity(tag, losses, base, tmp, cfg):
    """Each parity step of a layout against 1x1's from the same state ->
    [(loss rel err, params max diff, that where 1x1's |g| is large)].
    Removes the layout's parameter files."""
    errs = []
    for k, (mine, ref) in enumerate(zip(losses, base)):
        loss_err = max(abs(mine[n] - ref[n]) / max(abs(ref[n]), 1e-6)
                       for n in ref)
        got = cpu_params(f"{tmp}/{tag}{k + 1}.npz", cfg)
        want = cpu_params(f"{tmp}/ref{k + 1}.npz", cfg)
        big = torch.load(f"{tmp}/ref{k + 1}.big", weights_only=True)
        worst_all = worst_big = 0.0
        for n, mask in big.items():
            diff = (got[n] - want[n]).abs()
            worst_all = max(worst_all, float(diff.max()))
            if mask.any():
                worst_big = max(worst_big, float(diff[mask].max()))
        errs.append((loss_err, worst_all, worst_big))
        Path(f"{tmp}/{tag}{k + 1}.npz").unlink()
    return errs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layouts", default="1x1,1x2,1x4,2x2",
                    help="comma list of DATAxMODEL")
    ap.add_argument("--steps", type=int, default=6)
    # one rank of a layout (the launcher's subprocesses)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--data", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--model", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--tmp", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        run_rank(args.rank, args.data, args.model, args.steps, args.tmp)
        return
    if not torch.cuda.is_available():
        raise SystemExit("torch_tensor_parallel: no CUDA device")
    layouts = [tuple(int(v) for v in t.split("x"))
               for t in args.layouts.split(",") if t]
    need = max(d * m for d, m in layouts)
    have = torch.cuda.device_count()
    if need > have:
        raise SystemExit(f"layout of {need} GPUs; {have} visible")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(f"[cards] {smi.replace(chr(10), ' | ')}")
    cfg = FLAGSHIP.replace(fuse_conv_pool=True, drop_prob=0.0)
    bound = TP_LARGE_G["bfloat16"]
    # 1x1 first: every layout is held to it
    layouts = [(1, 1)] + [lay for lay in layouts if lay != (1, 1)]
    report, base, ok = {}, None, True
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for data, model in layouts:
            ranks = run_layout(data, model, args.steps, tmp)
            tag = f"{data}x{model}"
            losses = ranks[0]["losses"]
            if base is None:
                base, errs = losses, []
            else:
                errs = parity(tag, losses, base, tmp, cfg)
            within = all(within_reference(e, LR, bound) for e in errs)
            ok &= within
            med = [statistics.median(r["ms"][WARMUP:]) for r in ranks]
            report[tag] = {
                "ms_per_step": med,
                "images_per_s": B * 1000 / max(med),
                "peak_gib": [r["peak_bytes"] / 2**30 for r in ranks],
                "parity_vs_1x1": errs, "parity_within": within,
                "total_loss": [s["total_loss"] for s in losses],
                "launches": ranks[0]["launches"]}
            print(f"[{tag}] ms/step per rank (median of {args.steps}) "
                  f"{', '.join(f'{t:.2f}' for t in med)}; "
                  f"{report[tag]['images_per_s']:.2f} images/s; peak "
                  f"{', '.join(f'{g:.2f}' for g in report[tag]['peak_gib'])}"
                  f" GiB")
            for k, e in enumerate(errs):
                print(f"[{tag}] step {k + 1} from 1x1's state against 1x1's: "
                      f"{describe(e, LR, bound)}")
    print(json.dumps({"cards": smi, "global_batch": B, "lr": LR,
                      "large_g_bound": bound, "layouts": report}))
    if not ok:
        raise SystemExit("a layout's step left 1x1's bounds")


if __name__ == "__main__":
    main()
