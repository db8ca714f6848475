"""One train CLI call over all local devices (`cli.train.main` with no
--num_processes; `parallel/launch.py`), on the CPU with gloo.

  * `local_layout` against the JAX CLI's own rule, the statements of
    `densecap_tpu/cli/train.py:main` that lay out a single-host mesh,
    run on a stand-in `jax.devices()` of G devices: equal (data, model)
    wherever they form a mesh, and an error wherever they cannot.
  * The launcher's two CPU ranks over gloo, with and without
    `--model_parallel 2`, against the explicit `--num_processes 2` run of
    the same flags, both on the tiny h5 at fc 64: the same loss history
    and checkpoint pair, bit for bit; only rank 0 prints.
  * A rank that fails ends the call with its code and leaves no process
    (its other rank and that rank's child included); SIGINT, SIGTERM or
    SIGHUP to the call ends every rank, and so does a SIGKILL, which the
    call cannot forward.

Each rank runs a body that narrows fc6 / fc7 before it calls
`train.main` (`RANK_BODY`): fresh interpreters lose a patch made in the
test's process, so the launcher takes the command its ranks run. Every
subprocess has its own timeout.
"""

import ast
import functools
import json
import os
import signal
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from densecap_tpu_torch.cli import train
from densecap_tpu_torch.parallel import distributed, launch
from test_torch_train_cli import _args, dataset  # noqa: F401

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
TIMEOUT = 120
RANK_BODY = ("import functools, sys, torch\n"
             "from densecap_tpu_torch.cli import train\n"
             "from densecap_tpu_torch.config import DenseCapConfig\n"
             "torch.set_num_threads(1)\n"
             "train.DenseCapConfig = functools.partial(DenseCapConfig, "
             "fc_dim=64)\n"
             "train.main(sys.argv[1:])\n")


def jax_rule():
    """The JAX CLI's single-host layout as it stands in its source: the
    `avail = ...` statement and the `else` branch of the `if nproc > 1`
    that follows it in `main`, compiled as they are."""
    path = os.path.join(ROOT, "densecap_tpu", "cli", "train.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    body = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                and n.name == "main").body
    i = next(i for i, n in enumerate(body) if isinstance(n, ast.Assign)
             and ast.unparse(n.targets[0]) == "avail")
    branch = body[i + 1]
    assert ast.unparse(branch.test) == "nproc > 1"
    return compile(ast.Module(body=[body[i]] + branch.orelse,
                              type_ignores=[]), path, "exec")


def jax_layout(code, n_devices, model_parallel, batch_size):
    """(data, model) by the JAX rule, or None where it raises."""
    scope = {"jax": types.SimpleNamespace(
                 devices=lambda: [object()] * n_devices),
             "args": types.SimpleNamespace(model_parallel=model_parallel,
                                           batch_size=batch_size)}
    try:
        exec(code, scope)
    except ValueError:  # max() of no divisor: G // M is 0
        return None
    return scope["data_par"], model_parallel


@pytest.mark.parametrize("batch_size", [1, 2, 3, 6, 8, 16])
@pytest.mark.parametrize("model_parallel", [1, 2, 4])
@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
def test_local_layout_is_the_jax_rule(n_devices, model_parallel, batch_size):
    want = jax_layout(jax_rule(), n_devices, model_parallel, batch_size)
    if want is None:
        assert n_devices < model_parallel
        with pytest.raises(SystemExit, match="data axis is the largest "
                                             "divisor of --batch_size"):
            train.local_layout(n_devices, model_parallel, batch_size)
        return
    got = train.local_layout(n_devices, model_parallel, batch_size)
    assert got == want
    data, model = got
    assert batch_size % data == 0 and data * model <= n_devices


def explicit_flags(world, rank, init_method):
    """The flags that make a one-device call rank `rank` of `world`."""
    return ["--num_processes", str(world), "--process_id", str(rank),
            "--coordinator_address", init_method]


def _explicit(argv, tmp_path):
    """The explicit two-rank run of `argv`: the rank body with
    --num_processes 2, one process per rank, meeting at a file store."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_BODY] + argv + explicit_flags(
            2, r, f"file://{tmp_path}/store"),
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    return procs


def _by_hand(argv, tmp_path):
    """The launcher's two ranks of `argv` started by hand: the rank body
    with the environment the launcher gives them (`launch.rank_env`: cpu,
    gloo, rank r of 2, a file store, G = 2)."""
    store = f"file://{tmp_path}/store"
    return [subprocess.Popen(
        [sys.executable, "-c", RANK_BODY] + argv, cwd=str(tmp_path),
        env=dict(launch.rank_env("cpu", "gloo", r, 2, store, 2),
                 PYTHONPATH=ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]


def _finish(procs):
    try:
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    return [o for o, _ in outs]


def _written(prefix):
    """What a run wrote: its loss and results history, the .npz's arrays
    and the .optim.pt's tensors (the files' bytes hold zip timestamps)."""
    with open(prefix + ".json") as f:
        hist = json.load(f)
    with np.load(prefix + ".npz") as z:
        arrays = {k: z[k] for k in z.files}
    state = torch.load(prefix + ".optim.pt", weights_only=True)
    return hist, arrays, state


def _same_tree(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, f"{path}/{i}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


@pytest.mark.parametrize("flags,mesh", [
    ([], "mesh: data=2 model=1"),
    (["--model_parallel", "2"], "mesh: data=1 model=2"),
])
def test_launched_ranks_match_the_explicit_run(dataset, tmp_path,  # noqa: F811
                                               capfd, flags, mesh):
    """Global batch 2, two iterations, evaluated and saved at 2: the
    launcher's ranks and the explicit ones, at the same time. At data 2
    JAX's one-process feed hands the ranks halves of one batch of the
    whole split, where two one-device calls read a shard each; there the
    counterpart is the launcher's ranks started by hand (`_by_hand`)."""
    runs = {k: str(tmp_path / k / "ck" / "densecap")
            for k in ("launched", "explicit")}
    (tmp_path / "explicit").mkdir()
    explicit = (_explicit if flags else _by_hand)(
        _args(dataset, runs["explicit"], 2) + flags, tmp_path / "explicit")
    try:
        train.main(_args(dataset, runs["launched"], 2) + flags,
                   devices=["cpu", "cpu"], backend="gloo",
                   command=[sys.executable, "-c", RANK_BODY])
    finally:
        outs = _finish(explicit)
    printed = capfd.readouterr().out
    assert printed.startswith(mesh + "\n"), printed
    assert "iter 2: val mAP" in printed and "saved checkpoint" in printed
    assert printed.count("saved checkpoint") == 1, printed
    assert "iter 2: val mAP" in outs[0] and outs[1].strip() == ""
    assert not distributed.is_initialized()

    (hist, arrays, state), (ref_hist, ref_arrays, ref_state) = (
        _written(runs[k]) for k in ("launched", "explicit"))
    assert hist["loss_history"] == ref_hist["loss_history"]
    assert sorted(map(int, hist["loss_history"])) == [1, 2]
    assert hist["results_history"] == ref_hist["results_history"]
    assert hist["opt"]["num_processes"] == 2
    assert hist["opt"]["model_parallel"] == ref_hist["opt"]["model_parallel"]
    assert arrays.keys() == ref_arrays.keys()
    for k, v in arrays.items():
        assert v.dtype == ref_arrays[k].dtype, k
        assert v.tobytes() == ref_arrays[k].tobytes(), k
    _same_tree(state, ref_state)
    assert state["iter"] == 2 and state["count"] == 2


# A rank body that fails: rank 0 starts a child and sleeps, rank 1 waits
# until both pids are written and exits 3. argv[1] is the pid directory;
# the launcher gives the rank in the environment.
FAILING_BODY = ("import os, subprocess, sys, time\n"
                f"r = os.environ[{distributed.RANK_ENV!r}]\n"
                "d = sys.argv[1]\n"
                "def note(name, pid):\n"
                "    with open(f'{d}/{name}.tmp', 'w') as f:\n"
                "        f.write(str(pid))\n"
                "    os.replace(f'{d}/{name}.tmp', f'{d}/{name}')\n"
                "if r == '0':\n"
                "    child = subprocess.Popen(['sleep', '600'])\n"
                "    note('child', child.pid)\n"
                "note('rank' + r, os.getpid())\n"
                "if r == '1':\n"
                "    while not os.path.exists(f'{d}/child'):\n"
                "        time.sleep(0.05)\n"
                "    sys.exit(3)\n"
                "time.sleep(600)\n")


def _pids(folder):
    return {n: int((folder / n).read_text())
            for n in ("rank0", "rank1", "child")}


def _gone(pid):
    """No process `pid` runs: none exists, or it is a zombie (an orphan
    whose reaper has not reaped it)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            state = f.read().rsplit(")", 1)[1].split()[0]
    except FileNotFoundError:
        return True
    return state in ("Z", "X")


def _ended(pids):
    """The ranks, which the launcher reaps, are gone; rank 0's child, which
    it signals but cannot wait for, is gone within launch.GRACE_S (a
    signal to another process is delivered when that process next runs,
    which under load may be after the call returns)."""
    assert _gone(pids["rank0"]) and _gone(pids["rank1"]), pids
    deadline = time.monotonic() + launch.GRACE_S
    while not _gone(pids["child"]):
        assert time.monotonic() < deadline, pids
        time.sleep(0.05)


def test_a_failing_rank_ends_the_call(tmp_path):
    t0 = time.monotonic()
    code = launch.launch([str(tmp_path)], ["cpu", "cpu"], backend="gloo",
                         command=[sys.executable, "-c", FAILING_BODY])
    assert code == 3
    assert time.monotonic() - t0 < TIMEOUT
    _ended(_pids(tmp_path))


def _start_call(tmp_path):
    """The call (train.main, in a subprocess of its own) over two CPU
    ranks whose body sleeps; returned once both ranks and rank 0's child
    run."""
    body = FAILING_BODY.replace("sys.exit(3)", "time.sleep(600)")
    call = ("import sys\n"
            "from densecap_tpu_torch.cli import train\n"
            f"train.main(sys.argv[1:], devices=['cpu', 'cpu'], "
            f"command=[sys.executable, '-c', {body!r}, {str(tmp_path)!r}])\n")
    proc = subprocess.Popen(
        [sys.executable, "-c", call, "--device", "cpu", "--batch_size", "2"],
        env=dict(os.environ, PYTHONPATH=ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    deadline = time.monotonic() + TIMEOUT
    while not all((tmp_path / n).exists()
                  for n in ("rank0", "rank1", "child")):
        if proc.poll() is not None or time.monotonic() > deadline:
            proc.kill()
            pytest.fail(f"the ranks did not start: {proc.communicate()}")
        time.sleep(0.05)
    return proc


@pytest.mark.parametrize("sig", [signal.SIGINT, signal.SIGTERM,
                                 signal.SIGHUP])
def test_a_signal_to_the_call_ends_every_rank(tmp_path, sig):
    """The call gets `sig` once both ranks run; it exits 128 + sig and no
    rank is left."""
    proc = _start_call(tmp_path)
    try:
        proc.send_signal(sig)
        out, err = proc.communicate(timeout=TIMEOUT)
    finally:
        proc.kill()
    assert proc.returncode == 128 + sig, err[-4000:]
    assert out.startswith("mesh: data=2 model=1\n"), out
    _ended(_pids(tmp_path))


def test_a_killed_call_leaves_no_rank(tmp_path):
    """The call gets SIGKILL, so it can forward nothing: each rank still
    ends (its parent-death signal). Rank 0's own child outlives it, as a
    child of any killed process does, and the test ends it."""
    proc = _start_call(tmp_path)
    pids = _pids(tmp_path)
    try:
        proc.kill()
        proc.wait(timeout=TIMEOUT)  # rank 0's child holds its pipes
        deadline = time.monotonic() + TIMEOUT
        while not (_gone(pids["rank0"]) and _gone(pids["rank1"])):
            assert time.monotonic() < deadline, pids
            time.sleep(0.05)
    finally:
        for p in pids.values():
            try:
                os.kill(p, signal.SIGKILL)
            except ProcessLookupError:
                pass
        proc.communicate(timeout=TIMEOUT)


def test_one_device_trains_in_this_process(dataset, tmp_path,  # noqa: F811
                                           capsys, monkeypatch):
    """--device cpu (one device): mesh 1 x 1 and no rank started."""
    monkeypatch.setattr(launch, "launch", lambda *a, **k: pytest.fail(
        "a one-device call started ranks"))
    monkeypatch.setattr(train, "DenseCapConfig",
                        functools.partial(train.DenseCapConfig, fc_dim=64))
    prefix = str(tmp_path / "ck" / "densecap")
    train.main(_args(dataset, prefix, 1))
    out = capsys.readouterr().out
    assert out.startswith("mesh: data=1 model=1\n"), out
    assert "saved checkpoint" in out


@pytest.mark.parametrize("flags,want", [
    (["--batch_size", "8"], ("mesh: data=4 model=1", 4)),
    (["--batch_size", "8", "--model_parallel", "2"],
     ("mesh: data=2 model=2", 4)),
    (["--batch_size", "6", "--model_parallel", "2"],
     ("mesh: data=2 model=2", 4)),
    (["--batch_size", "3"], ("mesh: data=3 model=1", 3)),
    (["--batch_size", "1", "--model_parallel", "4"],
     ("mesh: data=1 model=4", 4)),
    (["--batch_size", "8", "--device", "cuda:2"], ("mesh: data=1 model=1",
                                                   1)),
    (["--batch_size", "8", "--model_parallel", "8"], None),
])
def test_cuda_call_lays_out_the_visible_gpus(monkeypatch, capsys, flags,
                                             want):
    """`--device cuda` on a stand-in host of 4 GPUs: the mesh printed, the
    ranks started on cuda:0 .. D x M - 1 over the launcher's default
    backend (NCCL), and each rank's flags; one device trains in this
    process; M > G is an error. Nothing touches CUDA."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    started, trained = [], []
    monkeypatch.setattr(launch, "launch", lambda argv, devices, **kw: (
        started.append((argv, [str(d) for d in devices], kw)), 0)[1])
    monkeypatch.setattr(train, "_run", lambda args, device: trained.append(
        str(device)))
    argv = ["--device", "cuda"] + flags
    if want is None:
        with pytest.raises(SystemExit, match="--model_parallel 8 needs "
                                             "--num_processes or 8 visible "
                                             "GPUs, 4 device"):
            train.main(argv)
        assert not started and not trained
        return
    train.main(argv)
    mesh, n = want
    assert capsys.readouterr().out == mesh + "\n"
    if n == 1:
        assert trained == [flags[-1]] and not started
        return
    assert not trained
    assert started == [(argv, [f"cuda:{i}" for i in range(n)],
                        {"backend": None, "command": None})]
