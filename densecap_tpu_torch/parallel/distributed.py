"""Multi-process runtime (twin of densecap_tpu/parallel/distributed.py).

One departure from the JAX package: JAX runs one process per host, over
all of that host's devices through its mesh; the port runs one process
per GPU, the torch idiom. A job of N host calls of G devices each
(`cli/train.py`) is N x G processes: host h's call starts its G ranks
(`parallel/launch.py`) as global ranks h x G + r. Each process is a rank
of the default `torch.distributed` group (NCCL between GPUs, gloo on the
CPU), loads its rows of its host's batch, as JAX hands a host's batch
to its devices (`cli/train.py:train_source`), and builds its `Trainer`
after `initialize`: a Trainer built while the group is up all-reduces
the gradients. The JAX `global_batch_from_local` has no counterpart:
each rank keeps its local slice.

Tensor parallelism (`--model_parallel M`, the JAX mesh's `'model'` axis)
splits the world into model groups of M consecutive ranks: rank r sits
at data index r // M and model index r % M, as device i sits in the JAX
`make_mesh` (the model axis is the minor one). A model group shards fc6,
fc7 and the vocab projection (`parallel/tensor_parallel.py`) and sees
one slice of the batch; the ranks of one model index form a data group,
over which the gradients, the loss denominator and the reported losses
are summed. With M = 1 no subgroup is made: the data group is the whole
world.

Single-process runs form no group: `initialize` returns False and the
helpers below answer as rank 0 of 1, model rank 0 of 1 and data rank 0
of 1.

A rank started by `parallel.launch` finds its device, backend, global
rank, world size, store and its host's rank count in its environment
(the `*_ENV` names below, which only the launcher sets; `launched` reads
them); `initialize` takes the backend over its own default.

A call that no launcher started finds its job as the JAX CLI's
`jax.distributed.initialize` would (`resolve_job`): from its flags, from
`JAX_COORDINATOR_ADDRESS`, `JAX_COORDINATOR_PORT` and
`JAX_LOCAL_DEVICE_IDS`, and from the variables of an Open MPI or SLURM
job (`OmpiCluster`, `SlurmCluster`: twins of jax 0.9.0's detectors of
`jax/_src/clusters/`, tried in its order). JAX's other detectors are not
ported: `Mpi4pyCluster` is opt-in only (`cluster_detection_method`,
which the JAX CLI never passes), the GKE and GCE TPU detectors need a
Cloud TPU VM, and `K8sCluster` needs the `kubernetes` package (without
it JAX's own detector reports no cluster, as the port does).
"""

from __future__ import annotations

import datetime
import os
import re

import torch
import torch.distributed as dist

# Rank 0 evaluates and writes the checkpoint while the other ranks wait in
# a barrier; the group's timeout has to outlast that.
TIMEOUT = datetime.timedelta(minutes=60)

# The subgroups of a tensor-parallel run (`initialize(model_parallel=M)`
# with M > 1): this rank's model group and data group, and M. Empty
# otherwise; `shutdown` empties it.
_groups = {}

# What `parallel.launch` tells each rank it starts: its device (e.g.
# "cuda:1", "cpu"), the group's backend ("nccl", "gloo"), its global
# rank, the world size and where the group meets (a file:// or tcp://
# URL; a tcp:// store is served by host 0's call, and the ranks connect
# to it as clients).
DEVICE_ENV = "DENSECAP_TORCH_RANK_DEVICE"
BACKEND_ENV = "DENSECAP_TORCH_RANK_BACKEND"
RANK_ENV = "DENSECAP_TORCH_RANK"
WORLD_ENV = "DENSECAP_TORCH_WORLD"
STORE_ENV = "DENSECAP_TORCH_STORE"
# ... and G, the ranks its host's call starts (global ranks h x G + r):
# a rank's share of its host's batch follows from it (`cli.train`)
LOCAL_ENV = "DENSECAP_TORCH_LOCAL_WORLD"


def launched():
    """(device, global rank, world size, store URL, G) that
    `parallel.launch` gave this process, or None for a process it did not
    start."""
    if not os.environ.get(RANK_ENV):
        return None
    return (torch.device(os.environ[DEVICE_ENV]), int(os.environ[RANK_ENV]),
            int(os.environ[WORLD_ENV]), os.environ[STORE_ENV],
            int(os.environ[LOCAL_ENV]))


class OmpiCluster:
    """A process that Open MPI's mpirun or mpiexec started
    (jax/_src/clusters/ompi_cluster.py)."""

    name = "ompi"

    @staticmethod
    def is_env_present(env):
        return "OMPI_MCA_orte_hnp_uri" in env

    @staticmethod
    def coordinator_address(env, port=None):
        """The launcher's IP in the URI (e.g. "1531576320.0;tcp://10.96.0.1,
        10.148.0.1:34911" or "...;tcp6://[fe80::1,2620::2]:43370"), at
        `port`, else at (job id // 4096) % 4096 + 61440."""
        uri = env["OMPI_MCA_orte_hnp_uri"]
        if not port:
            job = int(uri.split(".", maxsplit=1)[0]) // 2 ** 12
            port = str(job % 2 ** 12 + (65535 - 2 ** 12 + 1))
        match = re.search(r"tcp://(.+?)[,:]|tcp6://\[(.+?)[,\]]", uri)
        if match is None:
            raise SystemExit("could not parse the coordinator's IP address "
                             "from Open MPI's OMPI_MCA_orte_hnp_uri "
                             f"{uri!r}")
        ip = next(g for g in match.groups() if g is not None)
        return f"{ip}:{port}"

    @staticmethod
    def process_count(env):
        return int(env["OMPI_COMM_WORLD_SIZE"])

    @staticmethod
    def process_id(env):
        return int(env["OMPI_COMM_WORLD_RANK"])

    @staticmethod
    def local_process_id(env):
        return int(env["OMPI_COMM_WORLD_LOCAL_RANK"])


class SlurmCluster:
    """A process of a SLURM job step (jax/_src/clusters/slurm_cluster.py)."""

    name = "slurm"

    @staticmethod
    def is_env_present(env):
        return all(k in env for k in (
            "SLURM_JOB_ID", "SLURM_STEP_NODELIST", "SLURM_NTASKS",
            "SLURM_PROCID", "SLURM_LOCALID"))

    @staticmethod
    def coordinator_address(env, port=None):
        """The step's first node ('node001' of 'node001', 'node001,host2',
        'node[001-015],host2' or 'node[001,007-015],host2'), at `port`,
        else at job id % 4096 + 61440."""
        if not port:
            port = str(int(env["SLURM_JOB_ID"]) % 2 ** 12
                       + (65535 - 2 ** 12 + 1))
        nodes = env["SLURM_STEP_NODELIST"]
        i = next((i for i, ch in enumerate(nodes) if ch in ",["),
                 len(nodes))
        if i == len(nodes) or nodes[i] == ",":
            return f"{nodes[:i]}:{port}"
        prefix, suffix = nodes[:i], nodes[i + 1:]
        j = next((j for j, ch in enumerate(suffix) if ch in ",-"), None)
        return f"{prefix}{suffix[:j]}:{port}"

    @staticmethod
    def process_count(env):
        return int(env["SLURM_NTASKS"])

    @staticmethod
    def process_id(env):
        return int(env["SLURM_PROCID"])

    @staticmethod
    def local_process_id(env):
        return int(env["SLURM_LOCALID"])


# in jax's order: the first whose variables are present is the job's
CLUSTERS = (OmpiCluster, SlurmCluster)


def resolve_job(coordinator_address, num_processes, process_id, env=None):
    """The job of a train call with the JAX CLI's --coordinator_address,
    --num_processes and --process_id, as the JAX CLI would start it
    (`densecap_tpu/cli/train.py` -> `densecap_tpu/parallel/distributed.py`
    -> `jax.distributed.initialize`): (coordinator "host:port", N, h,
    local device ids or None), or None for a run of one host that meets
    no one. env: the environment (default os.environ).

    The gate: --num_processes <= 1 and no JAX_COORDINATOR_ADDRESS is a
    single-host run. Otherwise the coordinator is --coordinator_address,
    then JAX_COORDINATOR_ADDRESS; N is --num_processes when > 1; h is
    --process_id, always given (its default 0, as the JAX CLI passes
    it); the local device ids come from JAX_LOCAL_DEVICE_IDS (a comma
    list). Whatever is still unset the cluster's variables fill
    (`CLUSTERS`): the coordinator (its port JAX_COORDINATOR_PORT when
    set), N, and the local ids as [the local rank], on the explicit
    multi-host path too. The ids are ordinals among the visible GPUs,
    as jax_cuda_visible_devices takes them. SystemExit names what is
    missing after that, as JAX's ValueErrors do."""
    env = os.environ if env is None else env
    if num_processes <= 1 and "JAX_COORDINATOR_ADDRESS" not in env:
        return None
    coordinator = coordinator_address or env.get("JAX_COORDINATOR_ADDRESS")
    n = num_processes if num_processes > 1 else None
    h = process_id
    ids = None
    if env.get("JAX_LOCAL_DEVICE_IDS"):
        ids = [int(i) for i in env["JAX_LOCAL_DEVICE_IDS"].split(",")]
    if None in (coordinator, n, ids):
        cluster = next((c for c in CLUSTERS if c.is_env_present(env)), None)
        if cluster is not None:
            if coordinator is None:
                coordinator = cluster.coordinator_address(
                    env, env.get("JAX_COORDINATOR_PORT"))
            if n is None:
                n = cluster.process_count(env)
            if ids is None:
                ids = [cluster.local_process_id(env)]
    if coordinator is None:
        raise SystemExit("a multi-host run needs a coordinator: pass "
                         "--coordinator_address or set "
                         "JAX_COORDINATOR_ADDRESS (no SLURM or Open MPI "
                         "job found to take it from)")
    if n is None:
        raise SystemExit("a multi-host run needs its number of processes: "
                         "pass --num_processes (no SLURM or Open MPI job "
                         "found to take it from)")
    if not 0 <= h < n:
        raise SystemExit(f"--process_id {h} is not a process of the job's "
                         f"{n}")
    return coordinator, n, h, ids


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               init_method=None, device="cpu", backend=None,
               model_parallel=1, store=None):
    """Join this process to the job as rank `process_id` of
    `num_processes`. Returns True when a group was formed, False for a
    single-process run (num_processes None).

    model_parallel: M, the size of each model group; it must divide
    `num_processes`. M > 1 builds the model and data groups.

    The group meets at `init_method` (a `tcp://` or `file://` URL), or at
    `coordinator_address`: "host:port" of rank 0 becomes tcp://host:port,
    and a URL is taken as it is; or in `store`, a `torch.distributed`
    store the caller has joined already. backend: the launcher's
    (`BACKEND_ENV`), else NCCL for a CUDA `device` and gloo for the CPU,
    unless given.
    """
    if num_processes is None:
        return False
    device = torch.device(device)
    if store is None and init_method is None:
        if not coordinator_address:
            raise ValueError("a multi-process run needs a coordinator "
                             "address or an init method")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    if backend is None:
        backend = os.environ.get(BACKEND_ENV) or (
            "nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    meet = {"store": store} if store is not None else {
        "init_method": init_method}
    dist.init_process_group(backend, **meet, world_size=int(num_processes),
                            rank=int(process_id or 0), timeout=TIMEOUT)
    if model_parallel > 1:
        _build_groups(int(model_parallel))
    return True


def _build_groups(m):
    """Every rank makes every subgroup, in one order (`dist.new_group`
    is a collective): the model groups of consecutive ranks, then the
    data groups of ranks with one model index."""
    world, me = dist.get_world_size(), dist.get_rank()
    if world % m:
        raise ValueError(f"model_parallel {m} does not divide the "
                         f"{world} processes")
    for d in range(world // m):
        g = dist.new_group(list(range(d * m, d * m + m)))
        if me // m == d:
            _groups["model"] = g
    for i in range(m):
        g = dist.new_group(list(range(i, world, m)))
        if me % m == i:
            _groups["data"] = g
    _groups["m"] = m


def is_initialized():
    return dist.is_available() and dist.is_initialized()


def rank():
    return dist.get_rank() if is_initialized() else 0


def world_size():
    return dist.get_world_size() if is_initialized() else 1


def is_main_process():
    return rank() == 0


def model_size():
    """M: the ranks of one model group (1 without tensor parallelism)."""
    return _groups.get("m", 1)


def model_rank():
    """This rank's index in its model group, rank % M."""
    return rank() % model_size()


def data_size():
    """The model groups, world // M: the data axis."""
    return world_size() // model_size()


def data_rank():
    """This rank's model group, rank // M: its slice of the batch."""
    return rank() // model_size()


def model_group():
    """The process group of this rank's model group (None without tensor
    parallelism)."""
    return _groups.get("model")


def data_group():
    """The process group of the ranks that share this rank's model index;
    None (the whole world, for the collectives) without tensor
    parallelism."""
    return _groups.get("data")


def barrier(device=None):
    """Wait for every rank (no-op without a group). device: this rank's
    CUDA device, which an NCCL barrier runs on."""
    if not is_initialized():
        return
    if dist.get_backend() == "nccl" and device is not None:
        dist.barrier(device_ids=[torch.device(device).index])
    else:
        dist.barrier()


def shutdown():
    _groups.clear()
    if is_initialized():
        dist.destroy_process_group()
