"""The train CLI over every local GPU: one unchanged command per layout.

Makes a synthetic VG with `scripts/torch_make_synth_vg.py` (the port's
preprocess and HDF5 writer), then runs

    python -m densecap_tpu_torch.cli.train --data_h5 ... --data_json ... \\
        --device cuda --batch_size 8 --max_iters 35 --timing 1 ...

at flagship width (VGG-16, fc 4096, LSTM 512, bf16 as the CLI sets it,
the h5's vocabulary) in these layouts, on a host of four GPUs:

    dp4      no --model_parallel          mesh: data=4 model=1
    dp2xtp2  --model_parallel 2           mesh: data=2 model=2
    tp4      --model_parallel 4           mesh: data=1 model=4
    one      CUDA_VISIBLE_DEVICES=0       mesh: data=1 model=1

Each layout trains WARMUP warm-up and STEPS timed steps; rank 0
evaluates the whole val split at the last one and writes the pair.
Reported per layout: the mesh the CLI printed; ms/step (the CLI's
`--timing` means of its `data` and `step` stages, over the timed steps
only) and images/s; per rank, its device, its peak of
`torch.cuda.max_memory_allocated` and its launches of K1, K2 and K2b;
the val mAP. The per-rank readings come
from a `sitecustomize` this script puts on the ranks' PYTHONPATH: at
exit each process that ran the CLI on a card writes them to a file, so
the command itself stays the user's.

Parity: the layouts draw different samples (the sampler's seed follows
the data index), so their losses are not compared. The pair the first
of `--layouts` wrote at iteration N is resumed at each `--resume_at`
layout with `--checkpoint_start_from` and `--max_iters` N+1. The CLI
evaluates after a step, so the resumed runs step with `--learning_rate
0`, which leaves the parameters as loaded (Adam's update is scaled by
the rate): rank 0's val mAP at N+1 must equal the writer's at N to 1e-6,
the first loss must be finite, and the history must go on at N+1.

    python scripts/torch_train_cli_multigpu.py                  # 4 GPUs
    python scripts/torch_train_cli_multigpu.py --layouts one \\
        --resume_at one                                        # 1 GPU
    python scripts/torch_train_cli_multigpu.py --batch_size 32 \\
        --layouts dp4,one --resume_at ""             # B=32, no resume

Needs a card (exit 1 without one). Logs and `summary.json` go under
`--out_dir`; one JSON line last, with `"ok"`; exit 1 when a check fails.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import torch  # noqa: E402

from densecap_tpu_torch.cli.train import FETCH_LAG, local_layout  # noqa: E402

LAYOUTS = {"dp4": ([], None), "dp2xtp2": (["--model_parallel", "2"], None),
           "tp4": (["--model_parallel", "4"], None), "one": ([], "0")}
KERNELS = ("nms", "roi_align", "roi_align_bwd", "roi_align_bwd_feats")
MAP_TOL = 1e-6
WARMUP, STEPS = 5, 30  # untimed, then timed steps of each layout
IMAGES = (60, 16, 4)  # synthetic VG sources: portrait, landscape, square
TIMEOUT_S = 900  # per CLI command

# Written into a directory on the ranks' PYTHONPATH: at exit, a process
# that ran the CLI (`python -m densecap_tpu_torch.cli.train`) writes
# the global rank its launcher gave it, whether it touched CUDA, its
# device, peak memory and kernel launches.
PROBE = '''import atexit, json, os, sys


def _dump():
    torch = sys.modules.get("torch")
    build = sys.modules.get("densecap_tpu_torch.ops.cuda.build")
    spec = getattr(sys.modules.get("__main__"), "__spec__", None)
    if torch is None or getattr(spec, "name", "") != (
            "densecap_tpu_torch.cli.train"):
        return  # not a `python -m densecap_tpu_torch.cli.train` process
    rec = {"pid": os.getpid(), "argv": sys.argv[1:],
           "rank": os.environ.get("DENSECAP_TORCH_RANK"),
           "cuda_initialized": torch.cuda.is_initialized()}
    if rec["cuda_initialized"]:
        dev = torch.cuda.current_device()
        rec.update(device=f"cuda:{dev}",
                   visible=os.environ.get("CUDA_VISIBLE_DEVICES"),
                   peak_allocated_bytes=torch.cuda.max_memory_allocated(dev),
                   launches=dict(build.launches) if build else {})
    with open(os.path.join(os.environ["DENSECAP_PROBE_DIR"],
                           f"proc_{os.getpid()}.json"), "w") as f:
        json.dump(rec, f)


atexit.register(_dump)
'''


def smi():
    """nvidia-smi's `name, power.limit` line of each visible GPU."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout
    except (OSError, subprocess.TimeoutExpired) as e:
        return [f"nvidia-smi failed: {e}"]
    return [line.strip() for line in out.splitlines() if line.strip()]


def stage_means(stdout, max_iters):
    """[(steps timed so far, data ms, step ms)] of each `--timing`
    report. The CLI prints iteration i's losses and the report FETCH_LAG
    steps late, at step min(i + FETCH_LAG, max_iters) (the last ones at
    the end)."""
    out, it = [], None
    for line in stdout.splitlines():
        m = re.match(r"iter (\d+): \{", line)
        if m:
            it = int(m.group(1))
            continue
        m = re.match(r"timing\[(.*)\]", line)
        if m and it is not None:
            means = dict(re.findall(r"(\w+): ([\d.]+)ms", m.group(1)))
            out.append((min(it + FETCH_LAG, max_iters),
                        float(means["data"]), float(means["step"])))
            it = None
    return out


def timed_ms(reports, warmup, max_iters):
    """Mean data and step ms over the steps after `warmup` from the
    CLI's cumulative means: the report at the first count past the
    warm-up and the one at the end. The data stage runs once more than
    the step (the first batch)."""
    start = next(r for r in reports if r[0] > warmup)
    end = next(r for r in reports if r[0] == max_iters)
    n = end[0] - start[0]
    data = ((end[0] + 1) * end[1] - (start[0] + 1) * start[1]) / n
    step = (end[0] * end[2] - start[0] * start[2]) / n
    return {"steps": n, "from_step": start[0] + 1, "data_ms": data,
            "step_ms": step, "ms_per_step": data + step}


def probe_env(probe_dir, records):
    """The variables that make each train CLI process started with them
    write its probe record (PROBE, the sitecustomize in `probe_dir`) into
    the new directory `records`."""
    records.mkdir(parents=True)
    return {"DENSECAP_PROBE_DIR": str(records),
            "PYTHONPATH": os.pathsep.join(
                [str(probe_dir)]
                + [p for p in os.environ.get("PYTHONPATH", "").split(
                    os.pathsep) if p])}


def read_records(records):
    """The probe records written into the directory `records`."""
    return [json.loads(f.read_text()) for f in sorted(records.iterdir())]


def rank_of(rec):
    """The global rank a train CLI process ran as, from its probe record:
    the one its launcher gave it, or the last --process_id of a one-device
    call that trained on a card (an explicit rank). None for a process
    with neither: one that trained alone as rank 0, or a call that
    launched ranks (it touches no card)."""
    if rec.get("rank") is not None:
        return int(rec["rank"])
    argv = rec["argv"]
    if not rec["cuda_initialized"] or "--process_id" not in argv:
        return None
    return int(argv[len(argv) - argv[::-1].index("--process_id")])


def run_cli(tag, flags, visible, out_dir, probe_dir):
    """One CLI command in a subprocess -> (rc, stdout, per-process
    probe records, wall s)."""
    records = probe_dir / tag
    env = dict(os.environ, **probe_env(probe_dir, records))
    if visible is not None:
        env["CUDA_VISIBLE_DEVICES"] = visible
    cmd = [sys.executable, "-m", "densecap_tpu_torch.cli.train"] + flags
    t0 = time.perf_counter()
    p = subprocess.run(cmd, env=env, cwd=str(ROOT), capture_output=True,
                       text=True, timeout=TIMEOUT_S)
    wall = time.perf_counter() - t0
    (out_dir / f"{tag}.out").write_text(p.stdout)
    (out_dir / f"{tag}.err").write_text(p.stderr)
    (out_dir / f"{tag}.cmd").write_text(" ".join(cmd) + (
        f"\nCUDA_VISIBLE_DEVICES={visible}" if visible else "") + "\n")
    return p.returncode, p.stdout, read_records(records), wall


def per_rank(procs):
    """The probe records -> ({rank: device, visible, peak GiB, launches},
    whether a launching call touched CUDA). A process without a rank
    (`rank_of`) trained alone as rank 0, or was a call that launched
    ranks."""
    ranks, parents = {}, []
    for rec in procs:
        r = rank_of(rec)
        if r is None:
            parents.append(rec)
            r = 0
        if rec["cuda_initialized"]:
            ranks[r] = {"device": rec["device"], "visible": rec["visible"],
                        "peak_gib": rec["peak_allocated_bytes"] / 2 ** 30,
                        "launches": {k: rec["launches"].get(k, 0)
                                     for k in KERNELS}}
    launched = len(parents) < len(procs)
    return (dict(sorted(ranks.items())),
            launched and any(p["cuda_initialized"] for p in parents))


def history(prefix):
    with open(f"{prefix}.json") as f:
        return json.load(f)


def mesh_line(stdout):
    return next((ln for ln in stdout.splitlines()
                 if ln.startswith("mesh:")), None)


def physical(rank):
    """A rank's GPU on the machine: its device index, mapped through the
    CUDA_VISIBLE_DEVICES its process saw."""
    index = int(rank["device"].split(":")[1])
    return int(rank["visible"].split(",")[index]) if rank["visible"] else (
        index)


def check_run(tag, rec, procs, stdout, prefix, batch_size, n_iters, world,
              failures):
    """A timed run that exited 0: fill `rec` with its readings (per rank
    from the probe records `procs`; ms/step and images/s from global rank
    0's `stdout`; the val and losses from its history at `prefix`), and
    add to `failures` what it breaks: ranks 0 .. world - 1, rank r on
    physical GPU r; no launching call on a GPU; K2 and K2b on every rank,
    K1 on rank 0; the pair written; finite losses and mAP."""
    rec["ranks"], rec["parent_touched_cuda"] = per_rank(procs)
    timing = timed_ms(stage_means(stdout, n_iters), WARMUP, n_iters)
    hist = history(prefix)
    losses = {int(k): v["total_loss"] for k, v in hist["loss_history"].items()}
    rec.update(timing, images_per_s=batch_size * 1e3 / timing["ms_per_step"],
               val=hist["results_history"][str(n_iters)], total_loss=losses,
               pair=os.path.exists(f"{prefix}.npz"))
    ranks = rec["ranks"]
    if (sorted(ranks) != list(range(world))
            or [physical(ranks[r]) for r in sorted(ranks)]
            != list(range(world))):
        failures.append(f"{tag}: ranks on {ranks}")
    if rec["parent_touched_cuda"]:
        failures.append(f"{tag}: a launching call touched a GPU")
    for r, rr in ranks.items():
        if not (rr["launches"]["roi_align"]
                and rr["launches"]["roi_align_bwd"]):
            failures.append(f"{tag}: rank {r} never ran K2 / K2b")
    if not (ranks.get(0, {}).get("launches", {}).get("nms") and rec["pair"]
            and all(map(math.isfinite, losses.values()))
            and math.isfinite(rec["val"]["map"])):
        failures.append(f"{tag}: no K1 in rank 0's eval, no pair, or a "
                        "non-finite loss or mAP")
    print(f"[{tag}] {rec['mesh']}: {timing['ms_per_step']:.3f} ms/step "
          f"(data {timing['data_ms']:.3f} + step {timing['step_ms']:.3f}, "
          f"steps {timing['from_step']}-{n_iters}) = "
          f"{rec['images_per_s']:.2f} images/s; val mAP {rec['val']['map']}"
          f"; ranks {json.dumps(ranks)}; {rec['wall_s']:.1f} s", flush=True)


def resume_flags(prefix, writer, n_iters):
    """Resume the pair at `writer`, written at iteration n_iters, for one
    step at rate 0 into `prefix`."""
    return ["--max_iters", str(n_iters + 1), "--checkpoint_path",
            str(prefix), "--checkpoint_start_from", str(writer),
            "--learning_rate", "0", "--losses_log_every", "1"]


def check_resume(tag, rec, procs, stdout, prefix, writer, want, n_iters,
                 failures):
    """A resume run (`resume_flags`) that exited 0: fill `rec`, and add
    it to `failures` unless rank 0's val mAP equals the writer's `want`
    to MAP_TOL, the history goes on at n_iters + 1 with a finite loss,
    and the CLI said it resumed."""
    hist = history(prefix)
    got = hist["results_history"][str(n_iters + 1)]["map"]
    first = hist["loss_history"].get(str(n_iters + 1), {})
    rec.update(mesh=mesh_line(stdout), map=got, writer_map=want,
               map_err=abs(got - want),
               iterations=sorted(map(int, hist["loss_history"])),
               first_total_loss=first.get("total_loss"),
               ranks=per_rank(procs)[0])
    ok = (rec["map_err"] <= MAP_TOL and rec["iterations"] == [n_iters + 1]
          and math.isfinite(first.get("total_loss", math.nan))
          and f"resumed from {writer} at iteration {n_iters}" in stdout)
    if not ok:
        failures.append(f"{tag}: {rec}")
    print(f"[{tag}] {rec['mesh']}: val mAP {got} against the writer's "
          f"{want} (|diff| {rec['map_err']:.3e}, tol {MAP_TOL}); first "
          f"loss at {n_iters + 1}: {rec['first_total_loss']}; ok={ok}",
          flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layouts", default="dp4,dp2xtp2,tp4,one",
                    help="comma list; the first writes the pair resumed")
    ap.add_argument("--resume_at", default="dp2xtp2,tp4,one",
                    help="comma list of layouts; empty: no resume")
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--work_dir", default=str(ROOT / "build" / "cli_multigpu"))
    ap.add_argument("--out_dir",
                    default=str(ROOT / "build" / "train_cli_multigpu_logs"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: this measurement runs on GPUs only")
        sys.exit(1)
    import torch_make_synth_vg as synth

    n_gpus = torch.cuda.device_count()
    cards = smi()
    print(f"nvidia-smi: {cards}; visible GPUs {n_gpus}", flush=True)
    work, out_dir = Path(args.work_dir), Path(args.out_dir)
    shutil.rmtree(work, ignore_errors=True)
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    probe_dir = work / "probe"
    probe_dir.mkdir(parents=True)
    (probe_dir / "sitecustomize.py").write_text(PROBE)
    t0 = time.perf_counter()
    h5_path, json_path, splits = synth.make_synth_vg(
        str(work / "vg"), *IMAGES,
        image_size=720, num_workers=8)
    print(f"synthetic VG: train {len(splits['train'])}, val "
          f"{len(splits['val'])}, test {len(splits['test'])} images in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    n_iters = WARMUP + STEPS
    base = ["--data_h5", h5_path, "--data_json", json_path, "--device",
            "cuda", "--batch_size", str(args.batch_size),
            "--save_checkpoint_every", "100000", "--losses_log_every",
            str(WARMUP), "--val_images_use", "-1", "--timing", "1"]
    failures, layouts, resumed = [], {}, {}

    def expect_mesh(name):
        flags, visible = LAYOUTS[name]
        m = int(flags[1]) if flags else 1
        data, model = local_layout(1 if visible else n_gpus, m,
                                   args.batch_size)
        return f"mesh: data={data} model={model}"

    for name in args.layouts.split(","):
        flags, visible = LAYOUTS[name]
        prefix = work / name / "densecap"
        rc, stdout, procs, wall = run_cli(
            name, base + flags + ["--max_iters", str(n_iters),
                                  "--checkpoint_path", str(prefix)],
            visible, out_dir, probe_dir)
        rec = {"rc": rc, "wall_s": wall, "mesh": mesh_line(stdout),
               "expected_mesh": expect_mesh(name)}
        layouts[name] = rec
        if rc != 0:
            failures.append(f"{name}: exit {rc}")
            print(f"[{name}] exit {rc}", flush=True)
            continue
        if rec["mesh"] != rec["expected_mesh"]:
            failures.append(f"{name}: printed {rec['mesh']}")
        d, m = (int(v) for v in re.findall(r"\d+", rec["expected_mesh"]))
        check_run(name, rec, procs, stdout, prefix, args.batch_size,
                  n_iters, d * m, failures)

    writer_name = args.layouts.split(",")[0]
    writer = work / writer_name / "densecap"
    want = (history(writer)["results_history"][str(n_iters)]["map"]
            if layouts.get(writer_name, {}).get("rc") == 0 else None)
    resume_at = [n for n in args.resume_at.split(",") if n]
    for name in (resume_at if want is not None else []):
        flags, visible = LAYOUTS[name]
        tag = f"resume_{name}"
        prefix = work / tag / "densecap"
        rc, stdout, procs, wall = run_cli(
            tag, base + flags + resume_flags(prefix, writer, n_iters),
            visible, out_dir, probe_dir)
        rec = {"rc": rc, "wall_s": wall}
        resumed[name] = rec
        if rc != 0:
            failures.append(f"{tag}: exit {rc}")
            print(f"[{tag}] exit {rc}", flush=True)
            continue
        check_resume(tag, rec, procs, stdout, prefix, writer, want, n_iters,
                     failures)
    if want is None and resume_at:
        failures.append(f"the writer {writer_name} wrote no pair")

    summary = {"device": {"nvidia_smi": cards, "count": n_gpus},
               "batch_size": args.batch_size, "warmup": WARMUP,
               "timed_steps": STEPS, "layouts": layouts,
               "resumed": resumed, "failures": failures,
               "ok": not failures}
    (out_dir / "summary.json").write_text(json.dumps(summary, indent=1))
    shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(summary))
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
