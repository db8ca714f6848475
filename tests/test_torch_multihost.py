"""Multi-host training as the JAX CLI runs it, on the CPU with gloo: the
twin of tests/test_multihost.py. `cli.train.main` with `--num_processes
N --process_id h --coordinator_address host:port` is one call per host;
each starts its G ranks as global ranks h x G + r (`parallel/launch.py`),
and the N x G ranks meet at the TCP store that host 0's call serves.
Every "host" here is a process on this machine, so the store and gloo
cross the loopback interface, never a network.

  * `host_layout` against the JAX CLI's multi-host rule, the statements
    of `densecap_tpu/cli/train.py:main` (the batch check after
    `initialize`, and the `if nproc > 1` branch of the mesh) run on a
    stand-in `jax.devices()` of N x G devices with `nproc = N`: equal
    (data, model) wherever a mesh forms, an error wherever JAX raises.
  * The global batch of each step, the union of what every rank's feed
    (`cli.train.train_source`) loads, against the JAX multi-host feed
    (the JAX loader's `shard=(h, N)` at local batch B / N, or its
    `BucketedLoader` slice per host).
  * Two host calls of two gloo ranks each, at data 4 x model 1, at data
    2 x model 2 and with canvas buckets across an epoch wrap, against the
    explicit run of four one-device calls with the same flags: the same
    loss and val histories and checkpoint pair, bit for bit; rank
    h x 2 + r on host h; only global rank 0 prints beyond the mesh line.
  * Failures, each within its stated bound: hosts that lay out unequal
    G, a peer that never arrives, a rank that fails on host 1, a host
    call killed outright.

The ranks run `RANK_BODY`, which narrows fc6 / fc7 to 64 before it calls
`train.main`; every subprocess has its own timeout.
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

from densecap_tpu.data import loader as jl
from densecap_tpu_torch.cli import train
from densecap_tpu_torch.data import loader as pl
from densecap_tpu_torch.parallel import distributed, launch
from test_multihost import _free_port
from test_torch_train_cli import _args
from test_torch_train_launch import _gone, _same_tree, _written

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
TIMEOUT = 120
B = 4
TRAIN_IMAGES = 10
# the ranks: fc 64, one thread; each writes its record (its host flag,
# the rank, world and device its launcher gave it, and the bucket of
# every batch its feed made) into $MULTIHOST_RECORDS when it is done
RANK_BODY = """
import functools, json, os, sys, torch
from densecap_tpu_torch.cli import train
from densecap_tpu_torch.config import DenseCapConfig
from densecap_tpu_torch.data import loader
torch.set_num_threads(1)
train.DenseCapConfig = functools.partial(DenseCapConfig, fc_dim=64)
buckets, next_batch = [], loader.BucketedLoader.next_batch
def logged(self):
    bucket, batch = next_batch(self)
    buckets.append(list(bucket))
    return bucket, batch
loader.BucketedLoader.next_batch = logged
argv = sys.argv[1:]
train.main(argv)
rec = {"host": int(argv[argv.index("--process_id") + 1]),
       "rank": os.environ.get("DENSECAP_TORCH_RANK"),
       "world": os.environ.get("DENSECAP_TORCH_WORLD"),
       "device": os.environ.get("DENSECAP_TORCH_RANK_DEVICE"),
       "buckets": buckets}
with open(os.path.join(os.environ["MULTIHOST_RECORDS"],
                       f"{os.getpid()}.json"), "w") as f:
    json.dump(rec, f)
"""


def host_call(setup=""):
    """One host's call: `train.main` over the devices in argv[1] (comma
    list) with gloo, its ranks running the body in argv[2]; `setup` runs
    first (a test shortens the launcher's bounds there)."""
    return ("import sys\n"
            "from densecap_tpu_torch.cli import train\n"
            "from densecap_tpu_torch.parallel import launch\n"
            f"{setup}\n"
            "train.main(sys.argv[3:], devices=sys.argv[1].split(','), "
            "backend='gloo', command=[sys.executable, '-c', sys.argv[2]])\n")


def host_flags(hosts, host, port):
    return ["--num_processes", str(hosts), "--process_id", str(host),
            "--coordinator_address", f"127.0.0.1:{port}"]


def _env(records=None):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    if records is not None:
        records.mkdir(parents=True)
        env["MULTIHOST_RECORDS"] = str(records)
    return env


def start_hosts(argv, tmp_path, devices, body=RANK_BODY, setup="",
                records=None, port=None):
    """Host call h over devices[h] for each h, at once, meeting at a free
    port of 127.0.0.1."""
    port = port or _free_port()
    env = _env(records)
    return [subprocess.Popen(
        [sys.executable, "-c", host_call(setup), ",".join(devs), body]
        + argv + host_flags(len(devices), h, port), cwd=str(tmp_path),
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for h, devs in enumerate(devices)]


def finish(procs, timeout=TIMEOUT):
    """Wait for every process -> [(exit code, stdout, stderr)]."""
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
    return [(p.returncode, o, e) for p, (o, e) in zip(procs, outs)]


# ---------------------------------------------------------------------------
# host_layout against the JAX CLI's own statements


@functools.cache
def jax_multihost_rule():
    """The JAX CLI's multi-host layout as it stands in its source: the
    `if args.batch_size % nproc` check, the `avail = ...` statement and the
    body of the `if nproc > 1` branch after it, compiled as they are."""
    path = os.path.join(ROOT, "densecap_tpu", "cli", "train.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    body = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                and n.name == "main").body
    check = next(n for n in body if isinstance(n, ast.If) and
                 ast.unparse(n.test) == "args.batch_size % nproc")
    i = next(i for i, n in enumerate(body) if isinstance(n, ast.Assign)
             and ast.unparse(n.targets[0]) == "avail")
    branch = body[i + 1]
    assert ast.unparse(branch.test) == "nproc > 1"
    return compile(ast.Module(body=[check, body[i]] + branch.body,
                              type_ignores=[]), path, "exec")


def jax_layout(hosts, local, model_parallel, batch_size):
    """(data, model) by the JAX rule on hosts x local devices, or the
    message of the SystemExit it raises."""
    scope = {"jax": types.SimpleNamespace(
                 devices=lambda: [object()] * (hosts * local)),
             "nproc": hosts,
             "args": types.SimpleNamespace(model_parallel=model_parallel,
                                           batch_size=batch_size)}
    try:
        exec(jax_multihost_rule(), scope)
    except SystemExit as e:
        return str(e)
    return scope["data_par"], model_parallel


@pytest.mark.parametrize("batch_size", [1, 2, 3, 6, 8, 16])
@pytest.mark.parametrize("model_parallel", [1, 2, 4])
@pytest.mark.parametrize("local", [1, 2, 4, 8])
@pytest.mark.parametrize("hosts", [2, 3, 4])
def test_host_layout_is_the_jax_multihost_rule(hosts, local, model_parallel,
                                               batch_size):
    want = jax_layout(hosts, local, model_parallel, batch_size)
    if isinstance(want, str):
        with pytest.raises(SystemExit) as e:
            train.host_layout(hosts, local, model_parallel, batch_size)
        # the port names the same rule, in the JAX words where it can
        for words in ("divide evenly across", "does not divide",
                      "multiple of the data axis"):
            if words in want:
                assert words in str(e.value), (want, str(e.value))
        return
    got = train.host_layout(hosts, local, model_parallel, batch_size)
    assert got == want
    data, model = got
    assert data * model == hosts * local and data % hosts == 0
    assert local % model == 0  # a model group never spans hosts
    assert batch_size % data == 0


# ---------------------------------------------------------------------------
# the data: 10 train images, landscape and portrait in turns, 2 val


@pytest.fixture(scope="module")
def vg(tmp_path_factory):
    from PIL import Image

    from densecap_tpu.data import preprocess as pp

    root = tmp_path_factory.mktemp("torch_multihost_vg")
    img_dir = root / "images"
    img_dir.mkdir()
    rng = np.random.RandomState(0)
    data = []
    for i in range(TRAIN_IMAGES + 2):
        hw = (72, 96) if i % 2 == 0 else (96, 72)
        Image.fromarray(rng.randint(0, 255, hw + (3,), dtype=np.uint8)
                        ).save(img_dir / f"{i + 1}.jpg")
        data.append({"id": i + 1, "regions": [
            {"phrase": "a red cat", "x": 8, "y": 8, "width": 30,
             "height": 24},
            {"phrase": "a blue dog", "x": 30, "y": 30, "width": 24,
             "height": 30},
        ]})
    with open(root / "regions.json", "w") as f:
        json.dump(data, f)
    ids = list(range(1, TRAIN_IMAGES + 3))
    with open(root / "splits.json", "w") as f:
        json.dump({"train": ids[:TRAIN_IMAGES], "val": ids[TRAIN_IMAGES:],
                   "test": []}, f)
    pp.main(["--region_data", str(root / "regions.json"),
             "--image_dir", str(img_dir),
             "--split_json", str(root / "splits.json"),
             "--h5_output", str(root / "d.h5"),
             "--json_output", str(root / "d.json"),
             "--image_size", "64", "--max_token_length", "5",
             "--min_token_instances", "1", "--num_workers", "1"])
    return root


def flags(vg, prefix, steps, extra=()):
    return _args(vg, str(prefix), steps) + ["--batch_size", str(B),
                                            *extra]


# ---------------------------------------------------------------------------
# the global batch against the JAX multi-host feed


def _recording(loader, log):
    """`loader` with each example it reads appended to `log`."""
    read = loader.get_example_at

    def get_example_at(split, ri):
        ex = read(split, ri)
        log.append(int(ex["ix"]))
        return ex
    loader.get_example_at = get_example_at
    return loader


def _steps(feeds, steps):
    """What each feed [(next_batch, log)] read at each step, in order."""
    out = []
    for _ in range(steps):
        row = []
        for next_batch, log in feeds:
            del log[:]
            next_batch()
            row.append(list(log))
        out.append(row)
    return out


STEPS = 8  # three epochs of 10 images at B = 4


@pytest.mark.parametrize("buckets", ["", "48x64"])
@pytest.mark.parametrize("hosts,local,model", [
    (1, 2, 1), (1, 2, 2), (1, 4, 1), (1, 4, 2),
    (2, 1, 1), (2, 2, 1), (2, 2, 2), (2, 4, 2), (2, 4, 4)])
def test_global_batch_is_the_jax_multihost_feed(vg, tmp_path, hosts, local,
                                                model, buckets):
    """Every rank's feed as the CLI builds it (slot d of D, d = h x G / M
    + j on host h of N) against JAX's feed over STEPS steps, across the
    shard wraps: host h's batch (its loader's `shard=(h, N)` at B / N, or
    its `BucketedLoader` slice; with N = 1 the unsharded split at B, the
    one-process feed), handed to the host's G / M data slots in
    contiguous slices, as `make_array_from_process_local_data` hands it
    to the host's devices. Each slot reads the same examples in the same
    order at every step. On one host the call launches D x M of its G
    devices (`local_layout`), and its ranks' G is that."""
    if hosts == 1:
        data, _ = train.local_layout(local, model, B)
        launched = data * model
    else:
        data, _ = train.host_layout(hosts, local, model, B)
        launched = local
    slots = max(launched // model, 1)
    args = train.build_argparser().parse_args(
        flags(vg, tmp_path / "x", 1, ["--canvas_buckets", buckets]))
    h5, js = str(vg / "d.h5"), str(vg / "d.json")
    opened = []

    def open_port(**kw):
        opened.append(pl.DenseCapLoader(h5, js, max_gt_boxes=4, **kw))
        return opened[-1]

    try:
        port = []
        for d in range(data):
            log = []
            loader = _recording(open_port(), log)
            source = train.train_source(
                args, loader, lambda **kw: _recording(open_port(**kw), log),
                d, data, B // data, slots)
            port.append((source, log))
        jax = []
        shard = (lambda h: (h, hosts)) if hosts > 1 else (lambda h: None)
        for h in range(hosts):
            log = []
            if buckets:
                bl = jl.BucketedLoader(
                    _recording(jl.DenseCapLoader(h5, js, max_gt_boxes=4),
                               log), [(48, 64)], B, split=0,
                    shard=shard(h))
                jax.append((bl.next_batch, log))
            else:
                jloader = _recording(jl.DenseCapLoader(
                    h5, js, max_gt_boxes=4, shard=shard(h)), log)
                jax.append((functools.partial(jloader.get_batch, B // hosts,
                                              0), log))
        got, want = _steps(port, STEPS), _steps(jax, STEPS)
    finally:
        for loader in opened:
            loader.close()
    b = B // data
    want = [[host[j * b:(j + 1) * b] for host in step for j in range(slots)]
            for step in want]
    assert all(len(slot) == b for step in got for slot in step)
    assert got == want
    assert len({ix for step in got for slot in step for ix in slot}) == (
        TRAIN_IMAGES)


@pytest.mark.parametrize("buckets", [False, True])
@pytest.mark.parametrize("hosts,slots", [(1, 2), (1, 4), (2, 2)])
def test_a_rank_draws_for_the_rows_it_passes_over(vg, hosts, slots,
                                                  buckets):
    """At max_gt_boxes 1 every image of two regions draws its ground-truth
    subsample from the loader's generator. A rank that reads only its
    rows of its host's batch (`get_batch(..., rows=...)`, or
    `BucketedLoader(..., rows=...)` on the host's slice of the bucket
    schedule) still draws for the other rows, unread, so its examples
    equal those rows of the JAX host loader's whole batch, ground truth
    and weights included, across the shard wraps and the epoch's tail;
    and it reads no image of the other rows."""
    h5, js = str(vg / "d.h5"), str(vg / "d.json")
    host_batch = B // hosts
    b = host_batch // slots
    for h in range(hosts):
        shard = (h, hosts) if hosts > 1 else None
        ref_log = []
        if buckets:
            ref = _recording(jl.DenseCapLoader(
                h5, js, max_gt_boxes=1, raw_images=True), ref_log)
            host = jl.BucketedLoader(ref, [(48, 64)], B, split=0,
                                     shard=shard)
            whole_batch = lambda: host.next_batch()[1]  # noqa: E731
        else:
            ref = _recording(jl.DenseCapLoader(
                h5, js, max_gt_boxes=1, shard=shard, raw_images=True),
                ref_log)
            whole_batch = functools.partial(ref.get_batch, host_batch, 0)
        ranks = []
        for j in range(slots):
            log, rows = [], (j * b, (j + 1) * b)
            loader = _recording(pl.DenseCapLoader(
                h5, js, max_gt_boxes=1, shard=None if buckets else shard),
                log)
            if buckets:
                bl = pl.BucketedLoader(loader, [(48, 64)], B, split=0,
                                       shard=shard, rows=rows)
                read = lambda bl=bl: bl.next_batch()[1]  # noqa: E731
            else:
                read = functools.partial(loader.get_batch, host_batch, 0,
                                         rows=rows)
            ranks.append((loader, read, log))
        try:
            for _ in range(STEPS):
                del ref_log[:]
                whole = whole_batch()
                for j, (_, read, log) in enumerate(ranks):
                    del log[:]
                    got = read()
                    rows = slice(j * b, (j + 1) * b)
                    assert log == ref_log[rows]
                    for k in pl.BATCH_KEYS + (("weight",) if buckets
                                              else ()):
                        np.testing.assert_array_equal(
                            got[k], whole[k][rows], err_msg=k)
                    assert got["gt_valid"].sum() == b  # one box of two
        finally:
            ref.h5.close()
            for loader, _, _ in ranks:
                loader.close()


# ---------------------------------------------------------------------------
# two host calls of two ranks against four one-device calls


def _explicit(argv, tmp_path, records, world=4):
    """The explicit run: `world` one-device calls of RANK_BODY, rank r
    with --process_id r, meeting at a file store."""
    env = _env(records)
    return [subprocess.Popen(
        [sys.executable, "-c", RANK_BODY] + argv + [
            "--num_processes", str(world), "--process_id", str(r),
            "--coordinator_address", f"file://{tmp_path}/store"],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]


def _by_hand(argv, tmp_path, records, world=4, local=2):
    """The ranks of world / local host calls of `local` devices each,
    started by hand with what the launcher gives them: its environment
    (`launch.rank_env`: cpu, gloo, global rank r, the world, a file
    store, G = local) and the flags of host r // local's call."""
    env = _env(records)
    store = f"file://{tmp_path}/store"
    return [subprocess.Popen(
        [sys.executable, "-c", RANK_BODY] + argv + [
            "--num_processes", str(world // local), "--process_id",
            str(r // local)], cwd=str(tmp_path),
        env={**launch.rank_env("cpu", "gloo", r, world, store, local),
             **env}, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]


def _records(folder):
    return [json.loads(p.read_text()) for p in sorted(folder.iterdir())]


@pytest.mark.parametrize("extra,mesh,steps", [
    ([], "mesh: data=4 model=1", 2),
    (["--model_parallel", "2"], "mesh: data=2 model=2", 2),
    (["--canvas_buckets", "48x64"], "mesh: data=4 model=1", 4),
])
def test_two_hosts_match_four_one_device_calls(vg, tmp_path, extra, mesh,
                                               steps):
    """Global batch 4, evaluated and saved at the last step. With buckets,
    4 steps run the 48x64 bucket, the square, the epoch's tail through
    the square, and the 48x64 bucket of the next epoch.

    The four one-device calls are four hosts of one data slot each; JAX's
    feed gives them the batches of two hosts of two slots only where a
    host's slots are whole model groups (model 2) or share one schedule
    (buckets; a host's loader would draw the ground-truth subsample for
    its whole slice, but no image here has more than max_gt_boxes). At
    data 4 without buckets the counterpart is the two hosts' four ranks
    started by hand with the launcher's environment (`_by_hand`)."""
    by_hand = not extra
    runs = {k: tmp_path / k for k in ("hosts", "explicit")}
    for d in runs.values():
        d.mkdir()
    hosts = start_hosts(flags(vg, runs["hosts"] / "ck" / "densecap", steps,
                              extra), runs["hosts"], [("cpu", "cpu")] * 2,
                        records=runs["hosts"] / "records")
    explicit = (_by_hand if by_hand else _explicit)(
        flags(vg, runs["explicit"] / "ck" / "densecap", steps, extra),
        runs["explicit"], runs["explicit"] / "records")
    results = finish(hosts + explicit)
    for code, out, err in results:
        assert code == 0, err[-4000:]
    (_, out0, _), (_, out1, _) = results[:2]
    assert out0.startswith(mesh + "\n"), out0
    assert f"iter {steps}: val mAP" in out0
    assert out0.count("saved checkpoint") == 1, out0
    assert out1 == mesh + "\n"  # host 1 prints nothing of its ranks'

    launched = _records(runs["hosts"] / "records")
    assert sorted((r["host"], int(r["rank"])) for r in launched) == [
        (0, 0), (0, 1), (1, 2), (1, 3)]
    assert {(r["world"], r["device"]) for r in launched} == {("4", "cpu")}
    explicit_recs = _records(runs["explicit"] / "records")
    if by_hand:
        assert sorted((r["host"], int(r["rank"])) for r in explicit_recs
                      ) == [(0, 0), (0, 1), (1, 2), (1, 3)]
    else:
        assert sorted(r["host"] for r in explicit_recs) == [0, 1, 2, 3]
    if "--canvas_buckets" in extra:
        seqs = [r["buckets"][:steps] for r in launched + explicit_recs]
        assert all(s == seqs[0] for s in seqs), seqs
        assert seqs[0] == [[48, 64], [64, 64], [64, 64], [48, 64]]

    (hist, arrays, state), (ref_hist, ref_arrays, ref_state) = (
        _written(str(runs[k] / "ck" / "densecap")) for k in runs)
    assert hist["loss_history"] == ref_hist["loss_history"]
    assert sorted(map(int, hist["loss_history"])) == list(
        range(1, steps + 1))
    assert hist["results_history"] == ref_hist["results_history"]
    assert hist["opt"]["num_processes"] == 4  # the world, as explicit
    assert arrays.keys() == ref_arrays.keys()
    for k, v in arrays.items():
        assert v.dtype == ref_arrays[k].dtype, k
        assert v.tobytes() == ref_arrays[k].tobytes(), k
    _same_tree(state, ref_state)
    assert state["iter"] == steps and state["count"] == steps


# ---------------------------------------------------------------------------
# failures, each within its bound

# A rank body that writes its pid and sleeps; the last global rank (on
# host 1) exits 3 once every rank of the world has written its pid.
# $MULTIHOST_RECORDS is the pid directory.
PID_BODY = """
import os, sys, time
d, r = os.environ["MULTIHOST_RECORDS"], os.environ["DENSECAP_TORCH_RANK"]
world = int(os.environ["DENSECAP_TORCH_WORLD"])
with open(f"{d}/rank{r}.tmp", "w") as f:
    f.write(str(os.getpid()))
os.replace(f"{d}/rank{r}.tmp", f"{d}/rank{r}")
if int(r) == world - 1:
    while not all(os.path.exists(f"{d}/rank{i}") for i in range(world)):
        time.sleep(0.05)
    sys.exit(3)
time.sleep(600)
"""
SLEEP_BODY = PID_BODY.replace("sys.exit(3)", "time.sleep(600)")
# how long a call may take to start and to end its ranks, on a loaded
# machine, beyond the bound under test
SLACK_S = 30.0


@pytest.mark.parametrize("devices", [
    [("cpu", "cpu"), ("cpu",)], [("cpu", "cpu"), ("cpu", "cpu", "cpu")]])
def test_unequal_hosts_end_both_calls(vg, tmp_path, devices):
    """Host 1 lays out another G than host 0 (one device, or three):
    both calls exit non-zero, naming the rule, as soon as both have met;
    no rank starts."""
    t0 = time.monotonic()
    results = finish(start_hosts(
        flags(vg, tmp_path / "ck", 1, ["--batch_size", "12"]), tmp_path,
        devices, body=SLEEP_BODY, records=tmp_path / "pids"))
    assert time.monotonic() - t0 < SLACK_S
    for code, out, err in results:
        assert code != 0
        assert "must lay out the same number of devices" in err, err[-2000:]
        assert "mesh:" not in out
    assert not any((tmp_path / "pids").iterdir())


@pytest.mark.parametrize("host", [0, 1])
def test_a_peer_that_never_arrives(vg, tmp_path, host):
    """Host `host` of 2 alone, with a 3 s rendezvous: host 0, which
    serves the store, waits for host 1 and exits non-zero; host 1 finds no
    store and exits non-zero; each within the timeout (and the client's
    one retry), no rank started."""
    rendezvous = 3.0
    port = _free_port()
    env = _env(tmp_path / "pids")
    t0 = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "-c",
         host_call(f"launch.RENDEZVOUS_S = {rendezvous}"), "cpu,cpu",
         SLEEP_BODY] + flags(vg, tmp_path / "ck", 1)
        + host_flags(2, host, port), cwd=str(tmp_path), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    [(code, out, err)] = finish([proc])
    assert code != 0
    assert ("did not all meet" if host == 0 else "no store at") in err, (
        err[-2000:])
    assert time.monotonic() - t0 < 2 * rendezvous + SLACK_S
    assert not any((tmp_path / "pids").iterdir())


def _pids(folder, n=4):
    deadline = time.monotonic() + TIMEOUT
    while not all((folder / f"rank{i}").exists() for i in range(n)):
        assert time.monotonic() < deadline, "the ranks did not start"
        time.sleep(0.05)
    return [int((folder / f"rank{i}").read_text()) for i in range(n)]


@pytest.mark.parametrize("devices", [[("cpu", "cpu")] * 2, [("cpu",)] * 2])
def test_a_failing_rank_on_host_1_ends_host_0(vg, tmp_path, devices):
    """The last global rank, on host 1, exits 3: host 1's call exits 3
    and leaves word in the store; host 0's call ends its ranks and exits
    1, within JOB_POLL_S + 2 x GRACE_S of the failure; no rank is left.
    So too for two one-device hosts, whose ranks run under the launcher
    as well."""
    procs = start_hosts(flags(vg, tmp_path / "ck", 1), tmp_path,
                        devices, body=PID_BODY, records=tmp_path / "pids")
    pids = _pids(tmp_path / "pids", n=sum(map(len, devices)))
    t0 = time.monotonic()
    (code0, _, err0), (code1, _, _) = finish(procs)
    assert (code0, code1) == (1, 3), err0[-2000:]
    assert "host 1: a rank exited 3" in err0
    assert (time.monotonic() - t0
            < launch.JOB_POLL_S + 2 * launch.GRACE_S + SLACK_S)
    assert all(_gone(p) for p in pids)


def test_a_killed_host_call_ends_the_other(vg, tmp_path):
    """Host 1's call gets SIGKILL, so it leaves no word: its ranks die
    with it (their parent-death signal), and host 0's call sees its beat
    stop (HEARTBEAT_S, 3 s here), ends its ranks and exits 1."""
    heartbeat = 3.0
    procs = start_hosts(flags(vg, tmp_path / "ck", 1), tmp_path,
                        [("cpu", "cpu")] * 2, body=SLEEP_BODY,
                        setup=f"launch.HEARTBEAT_S = {heartbeat}",
                        records=tmp_path / "pids")
    pids = _pids(tmp_path / "pids")
    t0 = time.monotonic()
    procs[1].send_signal(signal.SIGKILL)
    (code0, _, err0), _ = finish(procs)
    assert code0 == 1, err0[-2000:]
    assert "host 1 stopped beating" in err0
    assert (time.monotonic() - t0 < heartbeat + launch.JOB_POLL_S
            + 2 * launch.GRACE_S + SLACK_S)
    deadline = time.monotonic() + launch.GRACE_S
    while not all(_gone(p) for p in pids):
        assert time.monotonic() < deadline, pids
        time.sleep(0.05)


def test_one_device_host_calls_are_the_explicit_ranks(monkeypatch):
    """`--device cpu --num_processes N --process_id r` (G = 1, a file://
    coordinator) trains in this process as rank r of N: no store is
    served, no rank started, and the rank rule holds (M may span calls)."""
    ran = []
    monkeypatch.setattr(launch, "launch", lambda *a, **k: pytest.fail(
        "a one-device call started ranks"))
    monkeypatch.setattr(launch, "HostJob", lambda *a, **k: pytest.fail(
        "a file:// one-device call served a store"))
    monkeypatch.setattr(train, "_run", lambda args, device, store=None:
                        ran.append((args.process_id, args.num_processes,
                                    str(device), store)))
    train.main(["--device", "cpu", "--num_processes", "4", "--process_id",
                "2", "--model_parallel", "2", "--batch_size", "4",
                "--coordinator_address", "file:///nowhere/store"])
    assert ran == [(2, 4, "cpu", None)]
    assert not distributed.is_initialized()


def test_a_one_device_tcp_host_call_runs_its_rank_under_the_launcher(
        monkeypatch, capsys):
    """`--device cpu --num_processes 2 --process_id 1` with a TCP
    coordinator meets its job with G = 1 and starts its one rank (global
    rank 1 of 2) under the launcher's watch, not in its own process; it
    prints no mesh line, as the explicit run prints none."""
    met, started = [], []

    class Job:
        def __init__(self, coordinator, host, hosts):
            self.host, self.hosts = host, hosts
            met.append((coordinator, host, hosts))

        def meet(self, n_devices):
            met.append(n_devices)
            return self.hosts * n_devices

    monkeypatch.setattr(launch, "HostJob", Job)
    monkeypatch.setattr(launch, "launch", lambda argv, devices, **kw: (
        started.append(([str(d) for d in devices], kw["job"].host)), 0)[1])
    monkeypatch.setattr(train, "_run", lambda *a, **k: pytest.fail(
        "a one-device host call of a TCP job trained in its own process"))
    train.main(["--device", "cpu", "--num_processes", "2", "--process_id",
                "1", "--coordinator_address", "127.0.0.1:29500",
                "--model_parallel", "2", "--batch_size", "4"])
    assert capsys.readouterr().out == ""
    assert met == [("127.0.0.1:29500", 1, 2), 1]
    assert started == [(["cpu"], 1)]


@pytest.mark.parametrize("flags,mesh", [
    (["--batch_size", "32"], "mesh: data=16 model=1"),
    (["--batch_size", "32", "--model_parallel", "4"], "mesh: data=4 model=4"),
])
def test_a_cuda_host_call_lays_out_all_its_gpus(monkeypatch, capsys, flags,
                                                mesh):
    """`--device cuda --num_processes 2 --process_id 1` on a stand-in host
    of 8 GPUs: the call meets its job with G = 8 and starts 8 ranks on
    cuda:0 .. 7 (global ranks 8 .. 15 of 16), not one. Nothing touches
    CUDA or a socket."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    met, started = [], []

    class Job:
        def __init__(self, coordinator, host, hosts):
            self.host, self.hosts = host, hosts
            met.append((coordinator, host, hosts))

        def meet(self, n_devices):
            met.append(n_devices)
            return self.hosts * n_devices

    monkeypatch.setattr(launch, "HostJob", Job)
    monkeypatch.setattr(launch, "launch", lambda argv, devices, **kw: (
        started.append(([str(d) for d in devices], kw["job"].host)), 0)[1])
    monkeypatch.setattr(train, "_run", lambda *a, **k: pytest.fail(
        "a host call of 8 GPUs trained in its own process"))
    train.main(["--device", "cuda", "--num_processes", "2", "--process_id",
                "1", "--coordinator_address", "host0:29500"] + flags)
    assert capsys.readouterr().out == mesh + "\n"
    assert met == [("host0:29500", 1, 2), 8]
    assert started == [([f"cuda:{i}" for i in range(8)], 1)]
