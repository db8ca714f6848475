"""The train CLI as a job of two host calls, against one call over four GPUs.

Makes a synthetic VG with `scripts/torch_make_synth_vg.py`, then runs the
unchanged command

    python -m densecap_tpu_torch.cli.train --data_h5 ... --data_json ... \\
        --device cuda --batch_size B --max_iters 35 --timing 1 ...

at flagship width (VGG-16, fc 4096, LSTM 512, bf16 as the CLI sets it,
the h5's vocabulary) on a machine of four GPUs, in these runs, each at
B = 8 and B = 32:

    2x2        two host calls, --num_processes 2    mesh: data=4 model=1
    2x2_tp2    the same with --model_parallel 2     mesh: data=2 model=2
    1x4        one call, all four GPUs visible      mesh: data=4 model=1

A host call h sees CUDA_VISIBLE_DEVICES=0,1 (h = 0) or 2,3 (h = 1), gets
`--process_id h --coordinator_address 127.0.0.1:<port>`, and starts its
two ranks as global ranks 2h, 2h + 1 of 4 over NCCL. Both calls run on
this one machine: the store and NCCL cross 127.0.0.1 and NVLink, not a
network between hosts.

Each run trains WARMUP warm-up and STEPS timed steps; rank 0 evaluates
the whole val split at the last one and writes the pair. Reported per
run: the mesh each call printed; ms/step (the CLI's `--timing` means of
its `data` and `step` stages over the timed steps, from global rank 0)
and images/s; per rank, its device (the GPU its host call's
CUDA_VISIBLE_DEVICES maps it to), its peak `torch.cuda.max_memory_allocated`
and its launches of K1, K2 and K2b (the probe of
`scripts/torch_train_cli_multigpu.py`, a `sitecustomize` on the ranks'
PYTHONPATH); the val mAP.

Resume: the pair that the first run (`2x2`, B = 8) wrote at iteration N
is resumed by one call on one GPU (`CUDA_VISIBLE_DEVICES=0`) with
`--checkpoint_start_from`, `--max_iters` N+1 and `--learning_rate 0`,
which leaves the parameters as loaded: its val mAP must equal the
writer's to 1e-6. The checks of each run and of the resume are
`check_run` and `check_resume` of `scripts/torch_train_cli_multigpu.py`.

    python scripts/torch_train_cli_multihost.py --out_dir build/mh_logs

Needs four GPUs (exit 1 with fewer). Logs and `summary.json` go under
`--out_dir`; one JSON line last, with `"ok"`; exit 1 when a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import torch  # noqa: E402

import torch_train_cli_multigpu as multi  # noqa: E402
from densecap_tpu_torch.cli.train import host_layout, local_layout  # noqa: E402

# run -> (hosts, extra flags), in the order they run; the first, at the
# first batch size, writes the pair resumed on one GPU
RUNS = {"2x2": (2, []), "2x2_tp2": (2, ["--model_parallel", "2"]),
        "1x4": (1, [])}
BATCH_SIZES = (8, 32)
VISIBLE = {1: ["0,1,2,3"], 2: ["0,1", "2,3"]}
TIMEOUT_S = 900  # per run


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def expected_mesh(name, batch_size):
    hosts, extra = RUNS[name]
    m = int(extra[1]) if extra else 1
    data, model = (local_layout(4, m, batch_size) if hosts == 1
                   else host_layout(hosts, 2, m, batch_size))
    return f"mesh: data={data} model={model}"


def run_calls(tag, flags, visible, out_dir, probe_dir):
    """One host call per entry of `visible` (its CUDA_VISIBLE_DEVICES),
    all at once, each in a subprocess; with several they form one job ->
    ([(rc, stdout)] per call, probe records, wall s)."""
    hosts = len(visible)
    records = probe_dir / tag
    env = dict(os.environ, **multi.probe_env(probe_dir, records))
    port = free_port()
    cmd = [sys.executable, "-m", "densecap_tpu_torch.cli.train"] + flags
    calls = []
    t0 = time.perf_counter()
    for h, gpus in enumerate(visible):
        argv = cmd + (["--num_processes", str(hosts), "--process_id", str(h),
                       "--coordinator_address", f"127.0.0.1:{port}"]
                      if hosts > 1 else [])
        calls.append((argv, gpus, subprocess.Popen(
            argv, env=dict(env, CUDA_VISIBLE_DEVICES=gpus),
            cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)))
    outs = []
    try:
        for _, _, p in calls:
            outs.append(p.communicate(timeout=TIMEOUT_S))
    finally:
        for _, _, p in calls:
            p.kill()
    wall = time.perf_counter() - t0
    for h, ((argv, gpus, p), (out, err)) in enumerate(zip(calls, outs)):
        (out_dir / f"{tag}.host{h}.out").write_text(out)
        (out_dir / f"{tag}.host{h}.err").write_text(err)
        (out_dir / f"{tag}.host{h}.cmd").write_text(
            " ".join(argv) + f"\nCUDA_VISIBLE_DEVICES={gpus}\n")
    return ([(p.returncode, out) for (_, _, p), (out, _) in zip(calls, outs)],
            multi.read_records(records), wall)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work_dir",
                    default=str(ROOT / "build" / "cli_multihost"))
    ap.add_argument("--out_dir",
                    default=str(ROOT / "build" / "train_cli_multihost_logs"))
    args = ap.parse_args(argv)
    if torch.cuda.device_count() < 4:
        print(f"{torch.cuda.device_count()} CUDA devices: this measurement "
              "runs on four GPUs only")
        sys.exit(1)
    import torch_make_synth_vg as synth

    cards = multi.smi()
    print(f"nvidia-smi: {cards}", flush=True)
    work, out_dir = Path(args.work_dir), Path(args.out_dir)
    shutil.rmtree(work, ignore_errors=True)
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    probe_dir = work / "probe"
    probe_dir.mkdir(parents=True)
    (probe_dir / "sitecustomize.py").write_text(multi.PROBE)
    t0 = time.perf_counter()
    h5_path, json_path, splits = synth.make_synth_vg(
        str(work / "vg"), *multi.IMAGES, image_size=720, num_workers=8)
    print(f"synthetic VG: train {len(splits['train'])}, val "
          f"{len(splits['val'])} images in {time.perf_counter() - t0:.1f} s",
          flush=True)
    n_iters = multi.WARMUP + multi.STEPS
    failures, results, resumed = [], {}, {}

    def base(batch_size):
        return ["--data_h5", h5_path, "--data_json", json_path, "--device",
                "cuda", "--batch_size", str(batch_size),
                "--save_checkpoint_every", "100000", "--losses_log_every",
                str(multi.WARMUP), "--val_images_use", "-1", "--timing", "1"]

    for batch_size in BATCH_SIZES:
        for name in RUNS:
            tag = f"{name}_b{batch_size}"
            hosts, extra = RUNS[name]
            prefix = work / tag / "densecap"
            calls, procs, wall = run_calls(
                tag, base(batch_size) + extra + [
                    "--max_iters", str(n_iters), "--checkpoint_path",
                    str(prefix)], VISIBLE[hosts], out_dir, probe_dir)
            want_mesh = expected_mesh(name, batch_size)
            rec = {"batch_size": batch_size, "hosts": hosts,
                   "rc": [c for c, _ in calls], "wall_s": wall,
                   "mesh": [multi.mesh_line(out) for _, out in calls],
                   "expected_mesh": want_mesh}
            results[tag] = rec
            if any(rec["rc"]):
                failures.append(f"{tag}: exit {rec['rc']}")
                print(f"[{tag}] exit {rec['rc']}", flush=True)
                continue
            if rec["mesh"] != [want_mesh] * hosts:
                failures.append(f"{tag}: printed {rec['mesh']}")
            if hosts > 1 and calls[1][1] != want_mesh + "\n":
                failures.append(f"{tag}: host 1 printed {calls[1][1]!r}")
            multi.check_run(tag, rec, procs, calls[0][1], prefix, batch_size,
                            n_iters, 4, failures)

    writer_tag = f"{next(iter(RUNS))}_b{BATCH_SIZES[0]}"
    writer = work / writer_tag / "densecap"
    if results[writer_tag].get("pair"):
        want = multi.history(writer)["results_history"][str(n_iters)]["map"]
        tag = "resume_one"
        prefix = work / tag / "densecap"
        calls, procs, wall = run_calls(
            tag, base(BATCH_SIZES[0]) + multi.resume_flags(prefix, writer,
                                                           n_iters),
            ["0"], out_dir, probe_dir)
        (code, stdout), = calls
        rec = {"rc": code, "wall_s": wall}
        resumed[tag] = rec
        if code:
            failures.append(f"{tag}: exit {code}")
        else:
            multi.check_resume(tag, rec, procs, stdout, prefix, writer, want,
                               n_iters, failures)
    else:
        failures.append(f"the writer {writer_tag} wrote no pair")

    summary = {"device": {"nvidia_smi": cards,
                          "count": torch.cuda.device_count()},
               "warmup": multi.WARMUP, "timed_steps": multi.STEPS,
               "runs": results, "resumed": resumed, "failures": failures,
               "ok": not failures}
    (out_dir / "summary.json").write_text(json.dumps(summary, indent=1))
    shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(summary))
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
