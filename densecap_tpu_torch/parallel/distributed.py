"""Multi-process runtime (twin of densecap_tpu/parallel/distributed.py).

One departure from the JAX package: JAX runs one process per host, over
all of that host's devices through its mesh; the port runs one process
per GPU, the torch idiom. Each process is a rank of the default
`torch.distributed` group (NCCL between GPUs, gloo on the CPU), loads its
own slice of the global batch (the loader's round-robin `shard`, or the
bucketed loader's shard mode) and builds its `Trainer` after `initialize`:
a Trainer built while the group is up all-reduces the gradients. The JAX `global_batch_from_local` has no
counterpart: each rank keeps its local slice.

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
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

# Rank 0 evaluates and writes the checkpoint while the other ranks wait in
# a barrier; the group's timeout has to outlast that.
TIMEOUT = datetime.timedelta(minutes=60)

# The subgroups of a tensor-parallel run (`initialize(model_parallel=M)`
# with M > 1): this rank's model group and data group, and M. Empty
# otherwise; `shutdown` empties it.
_groups = {}


def rank_device(device, process_id=0):
    """The device of rank `process_id`: cuda:{process_id % device count}
    for a CUDA device that names no index, else `device` as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda",
                            process_id % max(torch.cuda.device_count(), 1))
    return device


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               init_method=None, device="cpu", backend=None,
               model_parallel=1):
    """Join this process to the job as rank `process_id` of
    `num_processes`. Returns True when a group was formed, False for a
    single-process run (num_processes None).

    model_parallel: M, the size of each model group; it must divide
    `num_processes`. M > 1 builds the model and data groups.

    The group meets at `init_method` (a `tcp://` or `file://` URL), or at
    `coordinator_address`: "host:port" of rank 0 becomes tcp://host:port,
    and a URL is taken as it is. backend: NCCL for a CUDA `device`, gloo
    for the CPU, unless given.
    """
    if num_processes is None:
        return False
    device = torch.device(device)
    if init_method is None:
        if not coordinator_address:
            raise ValueError("a multi-process run needs a coordinator "
                             "address or an init method")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(num_processes),
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
