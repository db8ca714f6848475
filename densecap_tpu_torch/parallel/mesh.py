"""Both axes of the JAX package's ('data', 'model') mesh
(`densecap_tpu/parallel/mesh.py`).

The `'data'` axis of inference: the JAX package replicates the params
over the mesh and lets XLA shard each batch; here one process holds a
replica of the model per device and runs each contiguous shard of a batch
on its own replica.

  * `data_devices(n, device)`: the n devices of `--data_parallel n`.
  * `Replicas(model, devices)`: one replica of a `DenseCap` per device,
    each driven by its own host thread on its own CUDA stream.

The `'model'` axis, tensor parallelism (`--model_parallel`): its layout
over the numpy parameter tree of `utils.checkpoint.init_params` /
`load_params`. The twin of `param_pspecs` is `param_shard_dims`: fc6,
fc7 and the vocab projection shard their output columns (the last dim of
a (in, out) weight and of its bias), everything else is replicated. The
columns split unevenly where M does not divide them, as
`torch.tensor_split` does (`split_columns`): V+1 = 10 001 at the
flagship vocab, so nothing is padded, and no padded column can reach a
softmax, a gradient or a checkpoint (the JAX package pads the vocab to a
multiple of M and masks the padded logits instead).

  * `shard_params(params, model_rank, M)` / `gather_params(shards)`: a
    full tree to one rank's shard (what `utils.checkpoint.to_torch`
    builds a training model of inside a model group) and M shards back
    to the full tree;
  * `shard_optimizer_state` / `gather_optimizer_state`: the same for
    Adam's `exp_avg` and `exp_avg_sq` in a `torch.optim.Adam`
    state dict, whose entries are indexed by parameter position.

The model group's collectives live in `parallel/tensor_parallel.py`.
"""
from __future__ import annotations

import copy
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np
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


# ---------------------------------------------------------------------------
# The 'model' axis: which leaves shard, and how a tree splits and joins.
# ---------------------------------------------------------------------------


def is_sharded(name):
    """Whether the leaf `name` ('/'-joined tree path or a dotted torch
    parameter name) shards over the model group: the `w` and `b` of
    recog's fc6 / fc7 and of lm's vocab projection (`param_pspecs`)."""
    keys = name.replace(".", "/").split("/")
    return keys[-1] in ("w", "b") and (
        "recog" in keys or ("lm" in keys and "proj" in keys))


def split_columns(width, m):
    """[(start, stop)] of each of the m ranks' columns of a dim of
    `width`: `torch.tensor_split`'s sizes, the first width % m one
    wider."""
    base, extra = divmod(int(width), int(m))
    bounds, start = [], 0
    for r in range(m):
        stop = start + base + (r < extra)
        bounds.append((start, stop))
        start = stop
    return bounds


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _map_tree(fn, tree, prefix=""):
    return {k: (_map_tree(fn, v, f"{prefix}{k}/") if isinstance(v, dict)
                else fn(prefix + k, v)) for k, v in tree.items()}


def param_shard_dims(params):
    """{'/'-joined leaf name: the dim sharded over the model group, or
    None}: the twin of `param_pspecs` on the same tree."""
    return {name: np.ndim(leaf) - 1 if is_sharded(name) else None
            for name, leaf in _leaves(params)}


def local_columns(x, model_rank, m):
    """Rank `model_rank`'s columns (last dim) of a full array or tensor."""
    start, stop = split_columns(x.shape[-1], m)[model_rank]
    return x[..., start:stop]


def _join(parts):
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts, -1)
    return np.concatenate(parts, -1)


def shard_params(params, model_rank, m):
    """A full numpy tree -> rank `model_rank`'s of M shards: the leaves
    that `param_shard_dims` shards keep their columns of `split_columns`,
    the rest stay whole. `utils.checkpoint.to_torch` builds a training
    model inside a model group from it."""
    dims = param_shard_dims(params)
    return _map_tree(
        lambda name, x: (x if dims[name] is None else
                         np.ascontiguousarray(local_columns(x, model_rank, m))),
        params)


def gather_params(shards):
    """The M shards of `shard_params`, in model-rank order -> the full
    tree (replicated leaves from the first)."""
    flat = [dict(_leaves(s)) for s in shards]
    dims = param_shard_dims(shards[0])
    return _map_tree(
        lambda name, x: (x if dims[name] is None else
                         _join([f[name] for f in flat])), shards[0])


MOMENTS = ("exp_avg", "exp_avg_sq")


def map_moments(fn, opt_state, names):
    """A copy of a `torch.optim.Adam` state dict whose moments of the
    sharded parameters are fn(index, key, moment); `names[i]` is the
    name of the parameter at position i."""
    state = {}
    for i, st in opt_state["state"].items():
        if is_sharded(names[i]):
            st = {k: fn(i, k, v) if k in MOMENTS else v
                  for k, v in st.items()}
        state[i] = st
    return dict(opt_state, state=state)


def shard_optimizer_state(opt_state, names, model_rank, m):
    """A full Adam state dict -> rank `model_rank`'s: the sharded
    parameters' `exp_avg` and `exp_avg_sq` keep their columns."""
    return map_moments(
        lambda i, k, v: local_columns(v, model_rank, m).contiguous(),
        opt_state, names)


def gather_optimizer_state(states, names):
    """The M ranks' Adam state dicts, in model-rank order -> the full
    one."""
    return map_moments(
        lambda i, k, v: _join([s["state"][i][k] for s in states]),
        states[0], names)
