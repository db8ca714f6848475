"""The train CLI's cluster-detected start, on the CPU: the twin of what the
JAX CLI gets from `jax.distributed.initialize` under SLURM or Open MPI.

  * `distributed.resolve_job` against JAX's own reading of the same flags
    and environment: the JAX CLI's `dist.initialize(...)` statement and
    `densecap_tpu.parallel.distributed.initialize` as they stand, then
    the statements of the installed jax's `State.initialize` up to its
    checks (`jax/_src/distributed.py`: JAX_COORDINATOR_ADDRESS,
    JAX_LOCAL_DEVICE_IDS, `ClusterEnv.auto_detect_unset_distributed_params`
    and the ValueErrors), compiled as they are. Coordinator, N, h and the
    local device ids equal, or an error on both sides naming the same
    missing value, over the JAX CLI's flag sets and stand-in SLURM and
    Open MPI environments.
  * The call's devices under a detected job (stand-in GPUs, no process
    started): its local rank's GPU alone, or JAX_LOCAL_DEVICE_IDS'.
  * Two CPU host calls under a stand-in SLURM job (`--num_processes 2
    --process_id h`, no coordinator: the step's node and the port derived
    from the job id) against two explicit one-device calls with a TCP
    coordinator and no cluster variables: the same loss and val
    histories and pair, bit for bit.
  * A job whose calls both claim id 0 (no --process_id, as an srun line
    that passes none): both calls exit non-zero at the meeting, naming
    --process_id, and no rank starts.

Every "host" is a process on this machine, so the store and gloo cross
the loopback interface, never a network.
"""

import ast
import functools
import os
import socket
import subprocess
import sys
import time

import jax
import pytest
import torch

from densecap_tpu.cli import train as jax_train
from densecap_tpu.parallel import distributed as jax_dist
from densecap_tpu_torch.cli import train
from densecap_tpu_torch.parallel import distributed, launch
from test_torch_multihost import (RANK_BODY, SLACK_S, SLEEP_BODY, _env,
                                  _records, finish, flags, vg)  # noqa: F401
from test_torch_train_launch import _same_tree, _written

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)

# every variable either side reads
VARIABLES = (
    "JAX_COORDINATOR_ADDRESS", "JAX_COORDINATOR_PORT", "JAX_LOCAL_DEVICE_IDS",
    "SLURM_JOB_ID", "SLURM_STEP_NODELIST", "SLURM_NTASKS", "SLURM_PROCID",
    "SLURM_LOCALID", "OMPI_MCA_orte_hnp_uri", "OMPI_COMM_WORLD_SIZE",
    "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_LOCAL_RANK",
    "KUBERNETES_SERVICE_HOST", "TPU_WORKER_HOSTNAMES",
    "TPU_PROCESS_ADDRESSES", distributed.RANK_ENV)


# ---------------------------------------------------------------------------
# the resolution against JAX's own reading


@functools.cache
def jax_cli_initialize():
    """The JAX CLI's `dist.initialize(...)` statement in `main`, compiled
    as it stands."""
    path = os.path.join(ROOT, "densecap_tpu", "cli", "train.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    body = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                and n.name == "main").body
    call = next(n for n in body if isinstance(n, ast.Expr)
                and ast.unparse(n.value.func) == "dist.initialize")
    return compile(ast.Module(body=[call], type_ignores=[]), path, "exec")


@functools.cache
def jax_state_reading():
    """The statements of the installed jax's `State.initialize` before it
    stores anything on `self`: where it reads the coordinator and the
    local device ids from the environment, runs the cluster detection and
    checks what it got, compiled as they are."""
    from jax._src import distributed as jd

    path = jd.__file__
    with open(path) as f:
        tree = ast.parse(f.read())
    state = next(n for n in tree.body if isinstance(n, ast.ClassDef)
                 and n.name == "State")
    fn = next(n for n in state.body if isinstance(n, ast.FunctionDef)
              and n.name == "initialize")
    end = next(i for i, n in enumerate(fn.body) if isinstance(n, ast.Assign)
               and ast.unparse(n.targets[0]).startswith("self."))
    return compile(ast.Module(body=fn.body[:end], type_ignores=[]), path,
                   "exec")


def jax_reading(argv, monkeypatch):
    """(coordinator, N, h, local ids) as the JAX CLI would start the job of
    `argv` in this environment, None where it starts none, or the message
    of the ValueError it raises."""
    from jax._src import clusters

    args = jax_train.build_argparser().parse_args(argv)
    passed = []
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: passed.append(kw))
    exec(jax_cli_initialize(), {"dist": jax_dist, "args": args})
    if not passed:
        return None
    scope = {"os": os, "clusters": clusters, "coordinator_address": None,
             "num_processes": None, "process_id": None,
             "local_device_ids": None, "cluster_detection_method": None,
             "initialization_timeout": 300, **passed[0]}
    try:
        exec(jax_state_reading(), scope)
    except ValueError as e:
        return str(e)
    return (scope["coordinator_address"], scope["num_processes"],
            scope["process_id"], scope["local_device_ids"])


# the base of the port both detectors derive from the job id
SLURM_PORT_BASE = 65535 - 2 ** 12 + 1
SLURM = {"SLURM_JOB_ID": "123457", "SLURM_STEP_NODELIST": "node001",
         "SLURM_NTASKS": "2", "SLURM_PROCID": "1", "SLURM_LOCALID": "1"}
OMPI = {"OMPI_MCA_orte_hnp_uri":
        "1531576320.0;tcp://10.96.0.1,10.148.0.1,10.108.0.1:34911",
        "OMPI_COMM_WORLD_SIZE": "4", "OMPI_COMM_WORLD_RANK": "3",
        "OMPI_COMM_WORLD_LOCAL_RANK": "1"}
ENVIRONMENTS = {
    "none": {},
    "jax_coordinator": {"JAX_COORDINATOR_ADDRESS": "coord:5555"},
    "jax_coordinator_and_ids": {"JAX_COORDINATOR_ADDRESS": "coord:5555",
                                "JAX_LOCAL_DEVICE_IDS": "0,2"},
    "slurm": SLURM,
    "slurm_list": dict(SLURM, SLURM_STEP_NODELIST="node001,host2"),
    "slurm_range": dict(SLURM, SLURM_STEP_NODELIST="node[001-015],host2"),
    "slurm_ranges": dict(SLURM,
                         SLURM_STEP_NODELIST="node[001,007-015],host2"),
    "slurm_one_task": dict(SLURM, SLURM_NTASKS="1", SLURM_PROCID="0",
                           SLURM_LOCALID="0"),
    "slurm_one_task_jax_coordinator": dict(
        SLURM, SLURM_NTASKS="1", SLURM_PROCID="0", SLURM_LOCALID="0",
        JAX_COORDINATOR_ADDRESS="coord:5555"),
    "slurm_port": dict(SLURM, JAX_COORDINATOR_PORT="23456"),
    "slurm_ids": dict(SLURM, JAX_LOCAL_DEVICE_IDS="0,2"),
    "slurm_jax_coordinator": dict(SLURM, JAX_COORDINATOR_ADDRESS="coord:5555"),
    "slurm_incomplete": {k: v for k, v in SLURM.items()
                         if k != "SLURM_LOCALID"},
    "ompi": OMPI,
    "ompi_tcp6": dict(OMPI, OMPI_MCA_orte_hnp_uri=(
        "1314521088.0;tcp6://[fe80::b9b:ac5d:9cf0:b858,"
        "2620:10d:c083:150e::3000:2]:43370")),
    "ompi_port": dict(OMPI, JAX_COORDINATOR_PORT="23456"),
    "ompi_and_slurm": dict(SLURM, **OMPI),
    "ompi_and_slurm_jax_coordinator": dict(
        SLURM, JAX_COORDINATOR_ADDRESS="coord:5555", **OMPI),
}
# the JAX CLI's flag sets: --num_processes, --coordinator_address,
# --process_id
FLAGS = [(n, c, h) for n in (1, 2) for c in ("", "host0:1234")
         for h in (0, 1)]
# a JAX error's words -> the port's words for the same missing value
ERRORS = {"coordinator_address should be defined": "needs a coordinator",
          "Number of processes must be defined": "number of processes",
          "process_id and num_processes must be": "--process_id"}


def _environment(monkeypatch, env):
    for k in VARIABLES:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("n,coordinator,h", FLAGS)
@pytest.mark.parametrize("name", sorted(ENVIRONMENTS))
def test_resolution_is_jax_s_reading(monkeypatch, name, n, coordinator, h):
    _environment(monkeypatch, ENVIRONMENTS[name])
    argv = ["--num_processes", str(n), "--process_id", str(h),
            "--coordinator_address", coordinator]
    want = jax_reading(argv, monkeypatch)
    args = train.build_argparser().parse_args(argv)
    if isinstance(want, str):
        words = next(w for k, w in ERRORS.items() if k in want)
        with pytest.raises(SystemExit, match=words):
            distributed.resolve_job(args.coordinator_address,
                                    args.num_processes, args.process_id)
        return
    got = distributed.resolve_job(args.coordinator_address,
                                  args.num_processes, args.process_id)
    assert got == want


def test_the_table_reaches_every_branch(monkeypatch):
    """The table above holds each outcome: no job, a job from each
    cluster and from the flags alone, and each of JAX's errors."""
    seen = set()
    for name, env in ENVIRONMENTS.items():
        _environment(monkeypatch, env)
        for n, coordinator, h in FLAGS:
            got = jax_reading(["--num_processes", str(n), "--process_id",
                               str(h), "--coordinator_address", coordinator],
                              monkeypatch)
            if got is None or not isinstance(got, str):
                seen.add("none" if got is None else
                         ("ids" if got[3] else "no ids", got[1]))
            else:
                seen.add(next(k for k in ERRORS if k in got))
    assert seen >= {"none", ("ids", 1), ("ids", 2), ("ids", 4),
                    ("no ids", 2), *ERRORS}, seen
    _environment(monkeypatch, ENVIRONMENTS["ompi_and_slurm"])
    assert distributed.resolve_job("", 1, 0) is None  # the gate
    port = (1531576320 // 2 ** 12) % 2 ** 12 + SLURM_PORT_BASE
    assert distributed.resolve_job("", 2, 0) == (
        f"10.96.0.1:{port}", 2, 0, [1])  # Open MPI first


# ---------------------------------------------------------------------------
# the call's devices under a detected job


class _Job:
    """A stand-in `launch.HostJob` that records what the call met with."""

    def __init__(self, met, coordinator, host, hosts):
        self.host, self.hosts, self.met = host, hosts, met
        met.append((coordinator, host, hosts))

    def meet(self, n_devices):
        self.met.append(n_devices)
        return self.hosts * n_devices


@pytest.mark.parametrize("env,argv,want_met,want_devices", [
    # srun --ntasks-per-node 8 on 2 nodes, task 11: its local rank's GPU
    (dict(SLURM, SLURM_NTASKS="16", SLURM_PROCID="11", SLURM_LOCALID="3"),
     ["--num_processes", "16", "--process_id", "11"],
     [(f"node001:{123457 % 2 ** 12 + SLURM_PORT_BASE}", 11, 16), 1],
     ["cuda:3"]),
    # the explicit multi-host flags under mpirun: the local rank's GPU too
    (OMPI, ["--num_processes", "2", "--process_id", "1",
            "--coordinator_address", "host0:29500"],
     [("host0:29500", 1, 2), 1], ["cuda:1"]),
    # JAX_LOCAL_DEVICE_IDS names the call's GPUs
    (dict(SLURM, JAX_LOCAL_DEVICE_IDS="4,5"),
     ["--num_processes", "2", "--process_id", "1"],
     [(f"node001:{123457 % 2 ** 12 + SLURM_PORT_BASE}", 1, 2), 2],
     ["cuda:4", "cuda:5"]),
])
def test_a_detected_call_lays_out_its_local_gpus(monkeypatch, env, argv,
                                                 want_met, want_devices):
    """On a stand-in host of 8 GPUs: the call meets its job with the
    devices JAX would make visible, and starts its ranks on them. Nothing
    touches CUDA or a socket."""
    _environment(monkeypatch, env)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    met, started = [], []
    monkeypatch.setattr(launch, "HostJob",
                        functools.partial(_Job, met))
    monkeypatch.setattr(launch, "launch", lambda argv, devices, **kw: (
        started.append([str(d) for d in devices]), 0)[1])
    monkeypatch.setattr(train, "_run", lambda *a, **k: pytest.fail(
        "a host call of a detected job trained in its own process"))
    train.main(["--device", "cuda", "--batch_size", "32"] + argv)
    assert met == want_met
    assert started == [want_devices]


def test_a_one_task_job_trains_on_its_local_gpu(monkeypatch):
    """JAX_COORDINATOR_ADDRESS opens the gate and SLURM gives N = 1: the
    single-host path over the local rank's GPU alone, as JAX's one
    process sees one device."""
    _environment(monkeypatch, dict(ENVIRONMENTS["slurm_one_task"],
                                   SLURM_LOCALID="2",
                                   JAX_COORDINATOR_ADDRESS="coord:5555"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    ran = []
    monkeypatch.setattr(train, "_run", lambda args, device, **kw: ran.append(
        (str(device), args.num_processes)))
    train.main(["--device", "cuda", "--batch_size", "8"])
    assert ran == [("cuda:2", 1)]


def test_local_ids_off_the_host_are_refused(monkeypatch):
    _environment(monkeypatch, dict(SLURM, SLURM_LOCALID="9"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    with pytest.raises(SystemExit, match=r"local device ids \[9\]"):
        train.main(["--device", "cuda", "--num_processes", "2"])


# ---------------------------------------------------------------------------
# host calls under a stand-in SLURM job

# one host call: train.main with devices left to the detection, its
# ranks running the body in argv[1]
CLUSTER_CALL = ("import sys\n"
                "from densecap_tpu_torch.cli import train\n"
                "train.main(sys.argv[2:], backend='gloo', "
                "command=[sys.executable, '-c', sys.argv[1]])\n")


def slurm_job_id():
    """A SLURM job id whose derived coordinator port (job id % 4096 +
    61440) is free on 127.0.0.1."""
    for port in range(SLURM_PORT_BASE, 65536):
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        return 7 * 2 ** 12 + port - SLURM_PORT_BASE
    raise RuntimeError("no free port in SLURM's derived range")


def start_cluster_calls(argv_of, tmp_path, records, body):
    """Task h of a stand-in two-task SLURM job on 127.0.0.1, each a host
    call with the flags argv_of(h), for h = 0, 1."""
    job_id = slurm_job_id()
    env = _env(records)
    return [subprocess.Popen(
        [sys.executable, "-c", CLUSTER_CALL, body] + argv_of(h),
        cwd=str(tmp_path), env=dict(
            env, SLURM_JOB_ID=str(job_id), SLURM_STEP_NODELIST="127.0.0.1",
            SLURM_NTASKS="2", SLURM_PROCID=str(h), SLURM_LOCALID="0"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for h in (0, 1)]


def test_a_slurm_job_matches_two_explicit_host_calls(vg, tmp_path):  # noqa: F811
    """Global batch 4, 2 steps, evaluated and saved at 2. Under SLURM
    each call gets `--num_processes 2 --process_id h` and no coordinator:
    it meets at 127.0.0.1 on the job's derived port, lays out its one
    device, and runs its rank (global rank h of 2) under the launcher;
    the explicit calls get `--coordinator_address 127.0.0.1:<port>` and
    no cluster variables. Both are N = 2 x G = 1, so they feed alike."""
    runs = {k: tmp_path / k for k in ("slurm", "explicit")}
    for d in runs.values():
        d.mkdir()
    cluster = start_cluster_calls(
        lambda h: flags(vg, runs["slurm"] / "ck" / "densecap", 2)
        + ["--num_processes", "2", "--process_id", str(h)], runs["slurm"],
        runs["slurm"] / "records", RANK_BODY)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = _env(runs["explicit"] / "records")
    explicit = [subprocess.Popen(
        [sys.executable, "-c", CLUSTER_CALL, RANK_BODY]
        + flags(vg, runs["explicit"] / "ck" / "densecap", 2)
        + ["--num_processes", "2", "--process_id", str(h),
           "--coordinator_address", f"127.0.0.1:{port}"],
        cwd=str(runs["explicit"]), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for h in (0, 1)]
    results = finish(cluster + explicit)
    for code, out, err in results:
        assert code == 0, err[-4000:]
    (_, out0, _), (_, out1, _) = results[:2]
    assert "iter 2: val mAP" in out0 and out1 == ""  # no mesh line: G = 1
    for k in runs:
        recs = _records(runs[k] / "records")
        assert sorted((r["host"], r["rank"], r["world"], r["device"])
                      for r in recs) == [(0, "0", "2", "cpu"),
                                         (1, "1", "2", "cpu")]
    (hist, arrays, state), (ref_hist, ref_arrays, ref_state) = (
        _written(str(runs[k] / "ck" / "densecap")) for k in runs)
    assert hist["loss_history"] == ref_hist["loss_history"]
    assert sorted(map(int, hist["loss_history"])) == [1, 2]
    assert hist["results_history"] == ref_hist["results_history"]
    assert arrays.keys() == ref_arrays.keys()
    for k, v in arrays.items():
        assert v.tobytes() == ref_arrays[k].tobytes(), k
    _same_tree(state, ref_state)


def test_a_job_whose_calls_claim_one_id_ends_every_call(vg, tmp_path):  # noqa: F811
    """An srun line with `--num_processes 2` and no --process_id: both
    calls are host 0 (the JAX CLI's default, never detected). One serves
    the store, the other finds the port taken and reaches it as a client;
    the second claim of id 0 ends both calls at the meeting, well within
    RENDEZVOUS_S, naming --process_id, and no rank starts."""
    t0 = time.monotonic()
    results = finish(start_cluster_calls(
        lambda h: flags(vg, tmp_path / "ck", 1) + ["--num_processes", "2"],
        tmp_path, tmp_path / "pids", SLEEP_BODY))
    assert time.monotonic() - t0 < SLACK_S < launch.RENDEZVOUS_S
    for code, out, err in results:
        assert code != 0
        assert "claim --process_id 0" in err, err[-2000:]
        assert out == ""
    assert not any((tmp_path / "pids").iterdir())
