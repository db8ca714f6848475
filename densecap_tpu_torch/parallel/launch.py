"""Start the ranks of one train call on this host.

The JAX train CLI meshes all its local devices in one process; the port
runs one process per device (`parallel/distributed.py`). So a single
`cli.train` call that lays out more than one device starts its ranks
here: `launch(argv, devices)` runs len(devices) fresh interpreters
(`subprocess`, never `fork`: CUDA does not survive a fork), rank r as

    <command> <argv> --num_processes N --process_id r \\
        --coordinator_address file://<tmp>/store

with `devices[r]` and the backend in its environment
(`distributed.DEVICE_ENV`, `distributed.BACKEND_ENV`). Each rank is then
exactly the explicit multi-process path of the same flags. The ranks
meet at a `file://` store in a temporary directory that is removed when
they have ended, so no TCP port is picked and raced for. The caller
touches no GPU, so rank 0 has its device to itself.

Rank 0's stdout is the caller's; the other ranks' goes nowhere (they
print nothing on the explicit path either). Every rank's stderr is the
caller's. The first rank to exit non-zero ends the others, and its code
is the call's. SIGINT, SIGTERM and SIGHUP sent to the caller go to every
rank; the call then ends them all and returns 128 + the signal's number.
Each rank runs in a session of its own, so a terminal's Ctrl-C reaches it
once, through the caller, and ending a rank ends its process group (a
compiler it started, say) with it. On Linux each rank also gets SIGKILL
when the caller dies, so a caller killed outright, by SIGKILL or with
its process group, leaves no rank holding its device: a rank starts as
a small bootstrap (`ARM`) that sets its parent-death signal (`prctl`)
and then execs the rank's command, which keeps the signal armed. No
Python runs between the fork and an exec, so a caller with threads
(CUDA's, say) cannot deadlock its child.
"""

from __future__ import annotations

import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

from .distributed import BACKEND_ENV, DEVICE_ENV

# How long the ranks have to exit on a forwarded signal, and then on
# SIGTERM, before SIGKILL.
GRACE_S = 10.0
POLL_S = 0.1
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


def rank_args(argv, world, rank, init_method):
    """The flags of rank `rank`: the call's, then the explicit
    multi-process path's (the later flag wins under argparse)."""
    return list(argv) + ["--num_processes", str(world), "--process_id",
                         str(rank), "--coordinator_address", init_method]


def rank_env(device, backend):
    env = dict(os.environ)
    env[DEVICE_ENV], env[BACKEND_ENV] = str(device), backend
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


def launch(argv, devices, backend=None, command=None):
    """Run one rank per entry of `devices` (torch device names; one may
    repeat, as two gloo ranks share cuda:0) with the flags `argv`, and
    wait for them. backend: the group's, by default NCCL when every
    device is a GPU and gloo otherwise. command: what each rank runs
    before its flags (default: `python -m densecap_tpu_torch.cli.train`;
    a test passes its own body). -> 0 when every rank exits 0, else the
    first non-zero exit code (128 + n for a rank ended by signal n, or
    for the call when it got one)."""
    devices = [str(d) for d in devices]
    if backend is None:
        backend = ("nccl" if all(d.startswith("cuda") for d in devices)
                   else "gloo")
    command = list(command or default_command())
    procs, received = [], []

    def forward(signum, frame):
        received.append(signum)
        for p in procs:
            if p.poll() is None:
                _signal_group(p, signum)

    handlers = {}
    if threading.current_thread() is threading.main_thread():
        handlers = {s: signal.signal(s, forward) for s in SIGNALS}
    tmp = tempfile.mkdtemp(prefix="densecap_launch_")
    try:
        init_method = f"file://{tmp}/store"
        for r, device in enumerate(devices):
            if received:
                break
            procs.append(subprocess.Popen(
                _armed(command + rank_args(argv, len(devices), r,
                                           init_method)),
                env=rank_env(device, backend),
                stdout=None if r == 0 else subprocess.DEVNULL,
                start_new_session=True))
        code = 0
        while not received and not code:
            codes = [p.poll() for p in procs]
            code = next((c for c in codes if c), 0)
            if all(c is not None for c in codes):
                break
            time.sleep(POLL_S)
        if received:
            code = -received[0]
        return 128 - code if code < 0 else code
    finally:
        _end(procs, patient=bool(received))
        for s, h in handlers.items():
            signal.signal(s, h)
        shutil.rmtree(tmp, ignore_errors=True)
