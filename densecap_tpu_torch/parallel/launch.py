"""Start the ranks of one train call on this host, alone or as one host of
a job of several.

The JAX train CLI meshes all its local devices in one process, one
process per host; the port runs one process per device
(`parallel/distributed.py`). So a `cli.train` call that lays out more
than one device, or any host call of a job that meets over TCP, starts
its ranks here: `launch(argv, devices)` runs
len(devices) = G fresh interpreters (`subprocess`, never `fork`: CUDA
does not survive a fork), each as

    <command> <argv>

with its device, the backend, its global rank, the world size, the
store the ranks meet at and G in its environment
(`distributed.DEVICE_ENV`, `BACKEND_ENV`, `RANK_ENV`, `WORLD_ENV`,
`STORE_ENV`, `LOCAL_ENV`; `cli.train` reads them through
`distributed.launched` before its flags; G tells a rank its host's share
of the batch). The caller touches
no GPU, so each rank has its device to itself.

Alone on its host (`job=None`), the call's ranks are ranks 0..G-1 of G
and meet at a `file://` store in a temporary directory that is removed
when they have ended, so no TCP port is picked and raced for.

One host of N (`job`, a `HostJob`): the job's N calls meet first at the
coordinator's TCP store, which host 0's call serves, as JAX's process 0
serves its coordinator; every call, host 0's too, reaches it as a client
at the coordinator's address and claims its --process_id there. Two
calls that claim one id end every call of the job, naming
--process_id; every call must lay out the same G (a mismatch ends every
call, naming the rule, as soon as all have met), and a call whose peers
do not all arrive within RENDEZVOUS_S exits non-zero. Host
h's ranks are then global ranks h x G + r of N x G and connect to that
store as clients. While they run, each call beats in the store every
JOB_POLL_S and reads it: when a rank fails on one host (or its call gets
a signal), its call leaves word there and the calls of the other hosts
end their ranks and exit 1 within JOB_POLL_S plus the time `_end` takes
(at most 2 x GRACE_S); so do they when a host's beat stops for
HEARTBEAT_S (its call was killed outright) or when the store is gone
(host 0's call ended). A call whose ranks all exit 0 says so; host 0's
call, which serves the store, returns only once every host has.

Global rank 0's stdout is the caller's; the other ranks' goes nowhere
(they print nothing on the explicit path either). Every rank's stderr is
the caller's. The first rank to exit non-zero ends the others, and its
code is the call's. SIGINT, SIGTERM and SIGHUP sent to the caller go to
every rank; the call then ends them all and returns 128 + the signal's
number. Each rank runs in a session of its own, so a terminal's Ctrl-C
reaches it once, through the caller, and ending a rank ends its process
group (a compiler it started, say) with it. On Linux each rank also gets
SIGKILL when the caller dies, so a caller killed outright, by SIGKILL or
with its process group, leaves no rank holding its device: a rank starts
as a small bootstrap (`ARM`) that sets its parent-death signal (`prctl`)
and then execs the rank's command, which keeps the signal armed. No
Python runs between the fork and an exec, so a caller with threads
(CUDA's, say) cannot deadlock its child.
"""

from __future__ import annotations

import datetime
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import torch.distributed as dist

from .distributed import (BACKEND_ENV, DEVICE_ENV, LOCAL_ENV, RANK_ENV,
                          STORE_ENV, WORLD_ENV)

# How long the ranks have to exit on a forwarded signal, and then on
# SIGTERM, before SIGKILL.
GRACE_S = 10.0
POLL_S = 0.1
# How long a host call waits for every host of its job at the coordinator
# (jax.distributed.initialize's default initialization_timeout), also the
# timeout of each request to the job's store.
RENDEZVOUS_S = 300.0
# How often a host call beats and reads the job's store, and how long a
# peer's beat may stand still before that host counts as lost.
JOB_POLL_S = 1.0
HEARTBEAT_S = 60.0
# The ranks of a job meet under this prefix of its store.
RANKS_PREFIX = "ranks"
SIGNALS = (signal.SIGINT, signal.SIGTERM, signal.SIGHUP)
# argv: the caller's pid, then the rank's command. prctl option 1 is
# PR_SET_PDEATHSIG; a caller that died before it was set is checked after.
ARM = ("import ctypes, os, signal, sys\n"
       "ctypes.CDLL(None).prctl(1, signal.SIGKILL)\n"
       "if os.getppid() != int(sys.argv[1]):\n"
       "    os.kill(os.getpid(), signal.SIGKILL)\n"
       "os.execvp(sys.argv[2], sys.argv[2:])\n")

# the directory that holds the package, for the ranks' PYTHONPATH
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def default_command():
    """What each rank runs before its flags: the train CLI."""
    return [sys.executable, "-m", "densecap_tpu_torch.cli.train"]


def tcp_address(coordinator):
    """"host:port" or "tcp://host:port" -> (host, port); None for
    anything else (a file:// URL, or nothing)."""
    addr = coordinator[len("tcp://"):] if coordinator.startswith(
        "tcp://") else coordinator
    name, sep, port = addr.rpartition(":")
    if "://" in addr or not sep or not port.isdigit():
        return None
    return name, int(port)


def _timeout():
    return datetime.timedelta(seconds=RENDEZVOUS_S)


def rank_store(url):
    """The store a launched rank meets its group at: None for a file://
    URL (`distributed.initialize` opens it), else a client of the job's
    TCP store, under the ranks' prefix."""
    address = tcp_address(url)
    if address is None:
        return None
    return dist.PrefixStore(RANKS_PREFIX, dist.TCPStore(
        *address, is_master=False, timeout=_timeout()))


class HostJob:
    """This call's place in a job of `hosts` host calls: the job's TCP
    store at the coordinator (host 0's call serves it; every call is its
    client at the coordinator's address, so a call that claims host 0
    off the coordinator's machine still meets the job there), where the
    calls claim their ids, meet, beat, and leave word of a failure or of
    their end."""

    def __init__(self, coordinator, host, hosts):
        address = tcp_address(coordinator)
        if address is None:
            raise SystemExit(
                f"--coordinator_address {coordinator!r}: a job of several "
                "hosts meets at a TCP store, host:port of process 0")
        if not 0 <= host < hosts:
            raise SystemExit(f"--process_id {host} is not a host of "
                             f"--num_processes {hosts}")
        self.host, self.hosts = host, hosts
        self.url = "tcp://%s:%d" % address
        self.server = None
        if host == 0:
            try:
                self.server = dist.TCPStore(*address, is_master=True,
                                            timeout=_timeout(),
                                            wait_for_workers=False)
            except dist.DistNetworkError:
                pass  # the port is taken: by a call that claims host 0
                #       too, which `meet` tells, or by no store at all
        try:
            self.store = dist.TCPStore(*address, is_master=False,
                                       timeout=_timeout())
        except dist.DistError as e:
            raise SystemExit(f"host {host}: no store at {self.url} within "
                             f"{RENDEZVOUS_S:g} s: {e}") from None
        self._beats = {}  # host -> (its beat, when it last moved)

    def meet(self, n_devices):
        """Claim this call's id, wait up to RENDEZVOUS_S for every host,
        and check that all lay out `n_devices`; SystemExit on a second
        claim of one id (in every call of the job), on a host missing or
        on unequal counts. -> the world, N x G."""
        keys = [f"devices/{h}" for h in range(self.hosts)]
        missing = (f"host {self.host}: the job's {self.hosts} hosts did not "
                   f"all meet at {self.url} within {RENDEZVOUS_S:g} s (does "
                   "every call give its own --process_id?)")
        try:
            if self.store.add(f"claim/{self.host}", 1) > 1:
                # an srun or mpirun line that passes no --process_id: the
                # JAX CLI's default is 0 too
                why = (f"two calls of the job claim --process_id "
                       f"{self.host}: give each call its own (srun: "
                       "--process_id $SLURM_PROCID; mpirun: --process_id "
                       "$OMPI_COMM_WORLD_RANK)")
                self.fail(why)
                if self.server is not None:  # let the others read the word
                    time.sleep(2 * JOB_POLL_S)
                raise SystemExit(f"host {self.host}: {why}")
            self.store.set(keys[self.host], str(n_devices))
            deadline = time.monotonic() + RENDEZVOUS_S
            while not self.store.check(keys):
                if self.store.check(["failed"]):
                    raise SystemExit(f"host {self.host}: "
                                     + self.store.get("failed").decode())
                if time.monotonic() > deadline:
                    raise SystemExit(missing)
                time.sleep(POLL_S)
            counts = [int(self.store.get(k)) for k in keys]
            self.store.set(f"met/{self.host}", "1")
            if self.host == 0:  # the others read before the store can close
                self.store.wait([f"met/{h}" for h in range(self.hosts)])
        except dist.DistError as e:
            raise SystemExit(f"{missing}: {e}") from None
        if len(set(counts)) > 1:
            raise SystemExit(
                "every host of a job must lay out the same number of "
                "devices (the mesh spans all of them, each host holding an "
                f"equal slice): hosts 0..{self.hosts - 1} lay out {counts}")
        return self.hosts * n_devices

    def fail(self, why):
        """Leave word for the other hosts that this one failed (the first
        word stays)."""
        try:
            self.store.compare_set("failed", "", why)
        except dist.DistError:  # the store is gone: the others see that
            pass

    def done(self):
        """Say that this host's ranks all exited 0."""
        try:
            self.store.set(f"done/{self.host}", "1")
        except dist.DistError:  # host 0 ended: nothing waits for the word
            pass

    def all_done(self):
        return self.store.check([f"done/{h}" for h in range(self.hosts)])

    def watch(self):
        """Beat, and -> why the job failed elsewhere, or None while it
        runs: a host left word, a host that is not done stopped beating
        for HEARTBEAT_S, or the store is gone."""
        try:
            self.store.add(f"beat/{self.host}", 1)
            if self.store.check(["failed"]):
                return self.store.get("failed").decode()
            now = time.monotonic()
            for h in range(self.hosts):
                if h == self.host or self.store.check([f"done/{h}"]):
                    continue
                beat = self.store.add(f"beat/{h}", 0)
                last = self._beats.get(h)
                if last is None or last[0] != beat:
                    self._beats[h] = (beat, now)
                elif now - last[1] > HEARTBEAT_S:
                    return f"host {h} stopped beating for {HEARTBEAT_S:g} s"
        except dist.DistError as e:
            return f"lost the job's store at {self.url}: {e}"
        return None


def rank_env(device, backend, rank, world, store, local):
    """The environment of a rank (`local`: G, the ranks its host's call
    starts)."""
    env = dict(os.environ)
    env.update({DEVICE_ENV: str(device), BACKEND_ENV: backend,
                RANK_ENV: str(rank), WORLD_ENV: str(world), STORE_ENV: store,
                LOCAL_ENV: str(local)})
    env["PYTHONPATH"] = os.pathsep.join(
        [_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                   if p])
    return env


def _armed(command):
    """`command`, run so that it gets SIGKILL when the caller dies (through
    `ARM` on Linux; elsewhere as it is)."""
    if not sys.platform.startswith("linux"):
        return command
    return [sys.executable, "-S", "-c", ARM, str(os.getpid())] + command


def _signal_group(proc, sig):
    try:
        os.killpg(proc.pid, sig)
    except ProcessLookupError:  # the rank and its group are gone
        pass


def _end(procs, patient):
    """End every rank still running and reap them all: after a signal
    the call forwarded (`patient`), first GRACE_S for them to exit on it;
    then SIGTERM, and SIGKILL GRACE_S later."""
    for sig in ((None,) if patient else ()) + (signal.SIGTERM,
                                               signal.SIGKILL):
        if sig is not None:
            for p in procs:
                if p.poll() is None:
                    _signal_group(p, sig)
        deadline = time.monotonic() + GRACE_S
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0))
            except subprocess.TimeoutExpired:
                pass
    for p in procs:  # what a rank left in its group
        _signal_group(p, signal.SIGKILL)
        p.wait()


def launch(argv, devices, backend=None, command=None, job=None):
    """Run one rank per entry of `devices` (torch device names; one may
    repeat, as two gloo ranks share cuda:0) with the flags `argv`, and
    wait for them. backend: the group's, by default NCCL when every
    device is a GPU and gloo otherwise. command: what each rank runs
    before its flags (default: `python -m densecap_tpu_torch.cli.train`;
    a test passes its own body). job: this call's `HostJob`, after `meet`,
    in a job of several hosts; None alone. -> 0 when every rank exits 0
    (and, on host 0, every host's did), else the first non-zero exit code
    (128 + n for a rank ended by signal n, or for the call when it got
    one), or 1 when another host failed."""
    devices = [str(d) for d in devices]
    if backend is None:
        backend = ("nccl" if all(d.startswith("cuda") for d in devices)
                   else "gloo")
    command = list(command or default_command())
    host, hosts = (job.host, job.hosts) if job else (0, 1)
    procs, received = [], []

    def forward(signum, frame):
        received.append(signum)
        for p in procs:
            if p.poll() is None:
                _signal_group(p, signum)

    handlers = {}
    if threading.current_thread() is threading.main_thread():
        handlers = {s: signal.signal(s, forward) for s in SIGNALS}
    tmp = None if job else tempfile.mkdtemp(prefix="densecap_launch_")
    try:
        store = job.url if job else f"file://{tmp}/store"
        first = host * len(devices)
        for r, device in enumerate(devices):
            if received:
                break
            procs.append(subprocess.Popen(
                _armed(command + list(argv)),
                env=rank_env(device, backend, first + r,
                             hosts * len(devices), store, len(devices)),
                stdout=None if first + r == 0 else subprocess.DEVNULL,
                start_new_session=True))
        code, why, ended, watch_at = 0, None, False, 0.0
        while not received:
            codes = [p.poll() for p in procs]
            code = next((c for c in codes if c), 0)
            if code:
                break
            if not ended and all(c is not None for c in codes):
                ended = True
                if job is None:
                    break
                job.done()
                if host:
                    break
            if ended and job.all_done():
                break
            if job and time.monotonic() >= watch_at:
                why = job.watch()
                if why:
                    break
                watch_at = time.monotonic() + JOB_POLL_S
            time.sleep(POLL_S)
        if received:
            code = -received[0]
        code = 128 - code if code < 0 else code
        if job and code:
            job.fail(f"host {host}: " + (
                f"got signal {received[0]}" if received else
                f"a rank exited {code}"))
        elif why and not code:
            print(f"host {host}: ending its ranks: {why}", file=sys.stderr,
                  flush=True)
            code = 1
        return code
    finally:
        _end(procs, patient=bool(received))
        for s, h in handlers.items():
            signal.signal(s, h)
        if tmp:
            shutil.rmtree(tmp, ignore_errors=True)
