"""Multi-process runtime (twin of densecap_tpu/parallel/distributed.py).

One departure from the JAX package: JAX runs one process per host, over
all of that host's devices through its mesh; the port runs one process
per GPU, the torch idiom. Each process is a rank of the default
`torch.distributed` group (NCCL between GPUs, gloo on the CPU), loads its
own slice of the global batch (the loader's round-robin `shard`, or the
bucketed loader's shard mode) and builds its `Trainer` after `initialize`:
a Trainer built while the group is up all-reduces the gradients. The JAX `global_batch_from_local` has no
counterpart: each rank keeps its local slice. Tensor parallelism
(`densecap_tpu/parallel/mesh.py`) is not ported.

Single-process runs form no group: `initialize` returns False and the
helpers below answer as rank 0 of 1.
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

# Rank 0 evaluates and writes the checkpoint while the other ranks wait in
# a barrier; the group's timeout has to outlast that.
TIMEOUT = datetime.timedelta(minutes=60)


def rank_device(device, process_id=0):
    """The device of rank `process_id`: cuda:{process_id % device count}
    for a CUDA device that names no index, else `device` as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda",
                            process_id % max(torch.cuda.device_count(), 1))
    return device


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               init_method=None, device="cpu", backend=None):
    """Join this process to the job as rank `process_id` of
    `num_processes`. Returns True when a group was formed, False for a
    single-process run (num_processes None).

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
    return True


def is_initialized():
    return dist.is_available() and dist.is_initialized()


def rank():
    return dist.get_rank() if is_initialized() else 0


def world_size():
    return dist.get_world_size() if is_initialized() else 1


def is_main_process():
    return rank() == 0


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
    if is_initialized():
        dist.destroy_process_group()
