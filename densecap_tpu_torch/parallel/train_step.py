"""The training step: batched loss, backward, zoned weight decay and Adam.

Twin of `densecap_tpu/parallel/train_step.py` (`param_zones`,
`batched_loss`, `make_optimizer`, `train_step`) under the static-freeze
policy that `densecap_tpu/cli/train.py` runs:

  * zones: trunk1 is `frozen` (never moves, not even by weight decay; it
    runs under `no_grad`, so it has no gradient at all), trunk2 is `cnn`
    (no gradient until the finetune flip: `cfg.static_freeze_cnn` runs it
    under `no_grad`), everything else is `main`;
  * weight decay is added to the gradients, g += wd * p, in the trainable
    zones;
  * Adam with the reference hyperparameters, and ONE learning-rate
    schedule outside the zones, advanced every step;
  * an optional batch["weight"] reweights the loss mean (the bucketed
    loader's repeat-padded slots carry weight 0).

A `Trainer` built while the default `torch.distributed` group is up
(`parallel/distributed.initialize`) runs a data parallel step over it,
one process per device. Each rank holds its own slice of the global
batch; the loss denominator is all-reduced first, each rank backpropagates
its share of the global weighted mean, and the trainable zones' gradients
are summed by one all-reduce over one flattened buffer a step. This is not
`DistributedDataParallel`: the set of parameters that take a gradient
changes at the finetune flip, and DDP's reducer is built once over a
fixed set.

Under tensor parallelism (`initialize(model_parallel=M)`, a training
model built by `to_torch` inside the group) fc6, fc7 and the vocab
projection hold this rank's columns, and the ranks of a model group run
the same batch slice. Those three collectives then run over the data
group, the ranks of one model index: over the world, the M copies of
each replicated gradient and loss would be summed, and ranks of other
model indices flatten buffers of other lengths. The replicated
parameters' gradients are then model rank 0's on every rank of the group
(`_share_replicated_grads`), so the ranks' copies stay equal. Weight
decay and Adam are elementwise and run on the shards as they are;
`state_dict` gathers Adam's moments of the sharded parameters to full
width, and `load_state_dict` takes this rank's columns of them. With
M = 1 the data group is the world and nothing changes.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from . import distributed
from .mesh import map_moments, shard_optimizer_state
from ..utils.image import normalize_uint8_images


def param_zones(model):
    """Parameter name -> 'frozen' | 'cnn' | 'main', by top-level module."""
    zone = {"trunk1": "frozen", "trunk2": "cnn"}
    return {name: zone.get(name.split(".")[0], "main")
            for name, _ in model.named_parameters()}


def cosine_decay_schedule(init_value, decay_steps, alpha=0.0):
    """optax.cosine_decay_schedule: the learning rate of update `count`
    (0 for the first)."""
    def schedule(count):
        frac = min(count, decay_steps) / decay_steps
        cosine = 0.5 * (1.0 + math.cos(math.pi * frac))
        return init_value * ((1.0 - alpha) * cosine + alpha)
    return schedule


def batched_loss(model, batch, generator=None, debug_sampler=None,
                 denom=None):
    """The per-image losses' mean over the batch. A uint8 batch['image']
    is normalized on the device first (the raw-uint8 feed).

    An optional batch['weight'] (B,) reweights the mean, as in the JAX
    package: every key becomes sum(v * w) / max(sum(w), 1), so a slot of
    weight 0 adds nothing to the losses or their gradient. `denom`, when
    given, replaces that denominator (or B without weights): the
    distributed step passes the global batch's, so each rank's losses are
    its share of the global mean."""
    images = batch["image"]
    if images.dtype == torch.uint8:
        images = normalize_uint8_images(images, batch["height"],
                                        batch["width"])
    losses = model.forward_train(
        images, batch["height"], batch["width"], batch["gt_boxes"],
        batch["gt_labels"], batch["gt_valid"], generator=generator,
        debug_sampler=debug_sampler)
    w = batch.get("weight")
    if w is None:
        # sum / B, the same arithmetic as the distributed step's
        denom = images.shape[0] if denom is None else denom
        return {k: v.sum() / denom for k, v in losses.items()}
    w = w.float()
    if denom is None:
        denom = torch.clamp(w.sum(), min=1.0)
    return {k: (v * w).sum() / denom for k, v in losses.items()}


class Trainer:
    """Owns the optimizer of a training `DenseCap` (`to_torch(...,
    train=True)`) and runs its steps.

    learning_rate: a float, or a function of the update count (e.g.
    `cosine_decay_schedule`), shared by every zone. Built while a process
    group is up, the Trainer runs the data parallel step over it; the
    parameters are broadcast from rank 0 here (a shard from the rank of
    data index 0 with this rank's model index), so every rank starts
    from the same ones.
    """

    def __init__(self, model, learning_rate=1e-5, beta1=0.9, beta2=0.999,
                 eps=1e-8):
        self.model = model
        self.learning_rate = learning_rate
        self.hyper = {"betas": (beta1, beta2), "eps": eps}
        self.distributed = distributed.is_initialized()
        # the collectives' group: the data group under tensor
        # parallelism, else None (the world)
        self.group = distributed.data_group()
        # column-parallel parameters -> their layer's ColumnShard
        self.shards = {f"{m}.{k}": mod.shard
                       for m, mod in model.named_modules()
                       if getattr(mod, "shard", None) is not None
                       for k in ("w", "b")}
        zones = param_zones(model)
        params = dict(model.named_parameters())
        self.main = [p for n, p in params.items() if zones[n] == "main"]
        self.cnn = [p for n, p in params.items() if zones[n] == "cnn"]
        # the name of each parameter, by its position in the optimizer
        self.names = ([n for n in params if zones[n] == "main"]
                      + [n for n in params if zones[n] == "cnn"])
        self.sharded = {id(params[n]) for n in self.shards}
        # One Adam for both zones. torch.optim.Adam creates a parameter's
        # state lazily, at its first non-None gradient, with step 0: trunk2
        # has no gradient until the flip, so its m = v = 0 and its count
        # starts at the flip, exactly the fresh state the JAX static-freeze
        # optimizer and the reference's lazily created cnn state give.
        self.opt = torch.optim.Adam(
            [{"params": self.main}, {"params": self.cnn}],
            lr=self.lr_at(0), **self.hyper)
        self.count = 0
        self.set_finetune(False)
        if self.distributed:
            with torch.no_grad():
                for n, p in params.items():
                    if n in self.shards:
                        dist.broadcast(p, distributed.model_rank(),
                                       group=self.group)
                    else:
                        dist.broadcast(p, 0)

    def set_finetune(self, on):
        """Turn trunk2's gradient (and its Adam updates) on or off."""
        self.finetune_cnn = bool(on)
        self.model.cfg = self.model.cfg.replace(static_freeze_cnn=not on)

    def lr_at(self, count):
        lr = self.learning_rate
        return lr(count) if callable(lr) else lr

    def state_dict(self):
        """What a resumed run needs besides the parameters: the Adam
        state, the schedule's count and the finetune flag. Under tensor
        parallelism the sharded parameters' moments are gathered to full
        width (a collective: every rank of the model group calls it)."""
        opt = self.opt.state_dict()
        if self.shards:
            opt = map_moments(
                lambda i, k, v: self.shards[self.names[i]].gather(v), opt,
                self.names)
        return {"optimizer": opt, "count": self.count,
                "finetune_cnn": self.finetune_cnn}

    def load_state_dict(self, state):
        """Restore `state_dict()` into a Trainer built the same way (over
        a model with the same parameters). Before the flip trunk2 has no
        Adam state, and it still has none after the load. The betas and
        eps stay this Trainer's own, as the JAX CLI builds its optimizer
        from its flags at resume (the learning rate is set every step).
        The state is the full model's, whatever M wrote it: under tensor
        parallelism each rank loads its columns of the moments."""
        opt = state["optimizer"]
        if self.shards:
            opt = shard_optimizer_state(opt, self.names,
                                        distributed.model_rank(),
                                        distributed.model_size())
        self.opt.load_state_dict(opt)
        for group in self.opt.param_groups:
            group.update(self.hyper)
        self.count = int(state["count"])
        self.set_finetune(state["finetune_cnn"])

    def _share_replicated_grads(self, trainable):
        """Give every rank of the model group its model rank 0's gradients
        of the replicated parameters (one broadcast of one flattened
        buffer). The ranks compute them from the same inputs, but on the
        card a backward that adds with atomics (K2b's d feats after the
        flip, some of cuDNN's weight gradients) differs in the last bits
        from run to run, and the ranks' replicated parameters would drift
        apart."""
        rep = [p for p in trainable if id(p) not in self.sharded]
        flat = torch.cat([p.grad.reshape(-1) for p in rep])
        first = distributed.data_rank() * distributed.model_size()
        dist.broadcast(flat, first, group=distributed.model_group())
        for p, g in zip(rep, flat.split([p.numel() for p in rep])):
            p.grad.copy_(g.view_as(p.grad))

    def step(self, batch, generator=None, debug_sampler=None):
        """One update on a batch of device tensors (image, height, width,
        gt_boxes, gt_labels, gt_valid, and optionally weight). Returns the
        batch-mean losses as detached scalars; distributed, the global
        batch's, the same on every rank."""
        self.opt.zero_grad(set_to_none=True)
        denom = None
        if self.distributed:
            w = batch.get("weight")
            denom = (w.float().sum() if w is not None else torch.tensor(
                float(batch["image"].shape[0]), device=batch["image"].device))
            dist.all_reduce(denom, group=self.group)
            denom = torch.clamp(denom, min=1.0)
        losses = batched_loss(self.model, batch, generator, debug_sampler,
                              denom=denom)
        losses["total_loss"].backward()
        trainable = self.main + (self.cnn if self.finetune_cnn else [])
        wd = self.model.cfg.weight_decay
        with torch.no_grad():
            for p in trainable:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            if self.distributed:
                # one buffer, flattened in the zones' order (the same on
                # every rank: the flip happens at the same step on all)
                flat = torch.cat([p.grad.reshape(-1) for p in trainable])
                dist.all_reduce(flat, group=self.group)
                for p, g in zip(trainable, flat.split(
                        [p.numel() for p in trainable])):
                    p.grad.copy_(g.view_as(p.grad))
            if self.shards:
                self._share_replicated_grads(trainable)
            for p in trainable:
                p.grad.add_(p, alpha=wd)
        lr = self.lr_at(self.count)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.count += 1
        out = {k: v.detach() for k, v in losses.items()}
        if self.distributed:
            vals = torch.stack(list(out.values()))
            dist.all_reduce(vals, group=self.group)
            out = dict(zip(out, vals.unbind()))
        return out
