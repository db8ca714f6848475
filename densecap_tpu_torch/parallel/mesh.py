"""Data-parallel inference over model replicas in one process.

Counterpart of the `'data'` axis of `densecap_tpu/parallel/mesh.py`: the
JAX package replicates the params over a ('data', 'model') mesh and lets
XLA shard each batch; here one process holds a replica of the model per
device and runs each contiguous shard of a batch on its own replica.
Tensor parallelism (the `'model'` axis: fc6 / fc7 and the vocab
projection sharded over devices, `--model_parallel`) is not ported yet.

  * `data_devices(n, device)`: the n devices of `--data_parallel n`.
  * `Replicas(model, devices)`: one replica of a `DenseCap` per device,
    each driven by its own host thread on its own CUDA stream.
"""

from __future__ import annotations

import copy
from concurrent.futures import ThreadPoolExecutor, wait

import torch
from torch import nn

from ..utils.image import to_model_input


def data_devices(n, device="cuda"):
    """The devices of `--data_parallel n` on `device`.

    A CUDA device without an index gives cuda:0 .. cuda:n-1, one with an
    index starts there; asking for more CUDA devices than exist is an
    error (never a silent shrink). "cpu" gives n times the CPU (each
    replica then runs on its own thread), which the tests use."""
    n = int(n)
    if n < 1:
        raise ValueError(f"--data_parallel must be >= 1, got {n}")
    device = torch.device(device)
    if device.type == "cpu":
        return [device] * n
    if device.type != "cuda":
        raise ValueError(f"data parallel on {device} is not supported")
    start = device.index or 0
    have = torch.cuda.device_count()
    if start + n > have:
        raise ValueError(f"--data_parallel {n} from {device} needs "
                         f"{start + n} CUDA devices, but {have} "
                         f"{'is' if have == 1 else 'are'} visible")
    return [torch.device("cuda", start + i) for i in range(n)]


def _index(device):
    """cuda -> cuda:<current>; other devices as they are."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def replicate(model, device):
    """A copy of `model` whose parameters and buffers (an int8 layer's
    codes and scales too) live on `device`; copied straight from their
    device to `device`."""
    memo = {}
    for p in model.parameters():
        memo[id(p)] = nn.Parameter(p.detach().to(device),
                                   requires_grad=p.requires_grad)
    for b in model.buffers():
        memo[id(b)] = b.to(device)
    return copy.deepcopy(model, memo)


class Replicas:
    """One replica of an inference `DenseCap` per entry of `devices`.

    Replicas on the model's own device use the model itself (inference
    reads its weights only); another device gets one copy
    (`replicate`), shared by the replicas there. Each replica has its
    own host thread and, on a CUDA device, its own stream: the forward
    waits on the host inside (the decode's early exit, the plain NMS),
    so replicas issued in turn from one thread would run one after
    another. Call `close()` to stop the threads.
    """

    def __init__(self, model, devices):
        devices = [_index(d) for d in devices]
        if not devices:
            raise ValueError("Replicas needs at least one device")
        home = next(model.parameters()).device
        copies = {home: model}
        for d in devices:
            if d not in copies:
                copies[d] = replicate(model, d)
        self.devices = devices
        self.models = [copies[d] for d in devices]
        self.streams = [torch.cuda.Stream(device=d) if d.type == "cuda"
                        else None for d in devices]
        self._workers = [
            ThreadPoolExecutor(1, thread_name_prefix=f"replica{i}")
            for i in range(len(devices))]

    def __len__(self):
        return len(self.devices)

    def close(self):
        """Finish the queued shards and join the replica threads."""
        for w in self._workers:
            w.shutdown(wait=True)

    def _shard(self, i, canvases, hs, ws, fn):
        dev, model, stream = self.devices[i], self.models[i], self.streams[i]
        if stream is None:
            return fn(model, *to_model_input(canvases, hs, ws, dev)), None
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            out = fn(model, *to_model_input(canvases, hs, ws, dev))
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    def submit(self, canvases, hs, ws, fn=None):
        """Split a batch (canvases as for `to_model_input`, their heights
        and widths) into contiguous shards, one per replica, empty shards
        skipped, and queue each on its replica's thread, where
        `fn(model, images, hs, ws)` (default `forward_test_batch`) runs
        it. -> one future per shard, in batch order, each giving
        (output, event): the event (None on the CPU) marks the end of the
        shard's work on its stream; wait on it before reading the output
        from another stream."""
        fn = fn or (lambda m, x, h, w: m.forward_test_batch(x, h, w))
        bounds = torch.tensor_split(torch.arange(len(canvases)), len(self))
        futures = []
        for i, ix in enumerate(bounds):
            if len(ix) == 0:
                continue
            a, b = int(ix[0]), int(ix[-1]) + 1
            futures.append(self._workers[i].submit(
                self._shard, i, canvases[a:b], list(hs[a:b]), list(ws[a:b]),
                fn))
        return futures

    def run(self, canvases, hs, ws, fn=None):
        """`submit`, then wait: the shards' outputs in batch order, each
        finished on its device."""
        futures = self.submit(canvases, hs, ws, fn)
        wait(futures)
        outs = []
        for f in futures:
            out, event = f.result()
            if event is not None:
                event.synchronize()
            outs.append(out)
        return outs
