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
    schedule outside the zones, advanced every step.
"""

from __future__ import annotations

import math

import torch

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


def batched_loss(model, batch, generator=None, debug_sampler=None):
    """Mean over the batch of the per-image losses. A uint8 batch['image']
    is normalized on the device first (the raw-uint8 feed)."""
    images = batch["image"]
    if images.dtype == torch.uint8:
        images = normalize_uint8_images(images, batch["height"],
                                        batch["width"])
    losses = model.forward_train(
        images, batch["height"], batch["width"], batch["gt_boxes"],
        batch["gt_labels"], batch["gt_valid"], generator=generator,
        debug_sampler=debug_sampler)
    return {k: v.mean() for k, v in losses.items()}


class Trainer:
    """Owns the optimizer of a training `DenseCap` (`to_torch(...,
    train=True)`) and runs its steps.

    learning_rate: a float, or a function of the update count (e.g.
    `cosine_decay_schedule`), shared by every zone.
    """

    def __init__(self, model, learning_rate=1e-5, beta1=0.9, beta2=0.999,
                 eps=1e-8):
        self.model = model
        self.learning_rate = learning_rate
        zones = param_zones(model)
        params = dict(model.named_parameters())
        self.main = [p for n, p in params.items() if zones[n] == "main"]
        self.cnn = [p for n, p in params.items() if zones[n] == "cnn"]
        # One Adam for both zones. torch.optim.Adam creates a parameter's
        # state lazily, at its first non-None gradient, with step 0: trunk2
        # has no gradient until the flip, so its m = v = 0 and its count
        # starts at the flip, exactly the fresh state the JAX static-freeze
        # optimizer and the reference's lazily created cnn state give.
        self.opt = torch.optim.Adam(
            [{"params": self.main}, {"params": self.cnn}],
            lr=self.lr_at(0), betas=(beta1, beta2), eps=eps)
        self.count = 0
        self.set_finetune(False)

    def set_finetune(self, on):
        """Turn trunk2's gradient (and its Adam updates) on or off."""
        self.finetune_cnn = bool(on)
        self.model.cfg = self.model.cfg.replace(static_freeze_cnn=not on)

    def lr_at(self, count):
        lr = self.learning_rate
        return lr(count) if callable(lr) else lr

    def step(self, batch, generator=None, debug_sampler=None):
        """One update on a batch of device tensors (image, height, width,
        gt_boxes, gt_labels, gt_valid).
        Returns the batch-mean losses as detached scalars."""
        self.opt.zero_grad(set_to_none=True)
        losses = batched_loss(self.model, batch, generator, debug_sampler)
        losses["total_loss"].backward()
        wd = self.model.cfg.weight_decay
        with torch.no_grad():
            for p in self.main + (self.cnn if self.finetune_cnn else []):
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                p.grad.add_(p, alpha=wd)
        lr = self.lr_at(self.count)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.count += 1
        return {k: v.detach() for k, v in losses.items()}
