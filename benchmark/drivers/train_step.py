"""The training step: `parallel.train_step.Trainer.step`, trunk2 frozen.

Set-up builds one Trainer over the training model of the seed's weights
and drives it through its first `check.steps` steps, each on a different
batch and through the window's own call and feed; those steps are the
warm-up (every batch has the same shapes) and the start that the
reference follows from the seed. The window then goes on stepping the
same object. One step of the window, drawn from the seed, is kept: the
trainable leaves and Adam's moments before it and after it (copied to
pinned host memory behind the step, with no wait), Adam's count, the
generator's state, the batch, the sampler's picks and the loss. After
the window the reference replays that step from the program's state.

Batches are made on the host from the seed, as the CLI's loader hands
them over: B uint8 canvases of S x S, each holding a frame whose longer
side is S and whose aspect ratio lies in [aspect_min, 1], the rest zero;
gt_min to gt_max ground-truth boxes inside the frame, captions of 1 to
seq_length words, padded to `max_gt_boxes` slots. Every seed makes the
same sizes (aspects, orientations, box counts, caption lengths) in its
own order, with its own pixels, boxes and words. A pool of distinct
batches in pinned memory is cycled; each step's batch is copied to the
card (non-blocking) while the step before it runs, and each step's loss
is read one step later, as the CLI does.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from benchlib import program as pg
from benchlib.weights import Weights
from reference.densecap_ref import f32_math
from reference.train_ref import TRAINABLE, TrainReference

# the program's parameter names of the trainable zone, by tree path
PROGRAM_NAMES = {
    "rpn/conv/w": "rpn.conv_w", "rpn/conv/b": "rpn.conv_b",
    "rpn/box/w": "rpn.box_w", "rpn/box/b": "rpn.box_b",
    "rpn/score/w": "rpn.score_w", "rpn/score/b": "rpn.score_b",
    "recog/fc6/w": "recog.fc6.w", "recog/fc6/b": "recog.fc6.b",
    "recog/fc7/w": "recog.fc7.w", "recog/fc7/b": "recog.fc7.b",
    "objectness/w": "obj_w", "objectness/b": "obj_b",
    "box_reg/w": "box_w", "box_reg/b": "box_b",
    "lm/img_enc/w": "lm.enc_w", "lm/img_enc/b": "lm.enc_b",
    "lm/embed": "lm.embed_w", "lm/lstm/Wx": "lm.Wx", "lm/lstm/Wh": "lm.Wh",
    "lm/lstm/b": "lm.b", "lm/proj/w": "lm.proj.w", "lm/proj/b": "lm.proj.b",
}


# program layout (OIHW) -> the tree's (HWIO)
CONV = ("rpn/conv/w", "rpn/box/w", "rpn/score/w")


def tree_layout(path, x):
    return x.permute(2, 3, 1, 0).contiguous() if path in CONV else x


def make_batches(spec, cfg, seed):
    """The pool of host batches (numpy), all different, from the seed;
    every seed has the same multiset of sizes."""
    rng = np.random.default_rng([int(seed), 9])
    B, S = int(spec["size"]), int(spec["canvas"])
    G, L, V = cfg["max_gt_boxes"], cfg["seq_length"], cfg["vocab_size"]
    n_img = B * int(spec["pool"])
    aspects = iter(rng.permutation(np.linspace(spec["aspect_min"], 1.0,
                                               n_img)))
    tall = iter(rng.permutation(np.arange(n_img) % 2 == 0))
    counts = rng.permutation(np.round(np.linspace(
        spec["gt_min"], spec["gt_max"], n_img)).astype(int))
    lens_all = iter(rng.permutation(np.arange(counts.sum()) % L + 1))
    counts = iter(counts)
    out = []
    for _ in range(int(spec["pool"])):
        image = np.zeros((B, S, S, 3), np.uint8)
        hw = np.zeros((B, 2), np.float32)
        boxes = np.zeros((B, G, 4), np.float32)
        labels = np.zeros((B, G, L), np.int64)
        valid = np.zeros((B, G), bool)
        for b in range(B):
            short = int(round(S * next(aspects)))
            h, w = (S, short) if next(tall) else (short, S)
            hw[b] = h, w
            image[b, :h, :w] = rng.integers(0, 256, (h, w, 3), np.uint8)
            n = int(next(counts))
            bw = rng.uniform(16, w, n)
            bh = rng.uniform(16, h, n)
            x0 = rng.uniform(0, w - bw) + 1
            y0 = rng.uniform(0, h - bh) + 1
            boxes[b, :n] = np.stack([x0 + bw / 2, y0 + bh / 2, bw, bh], 1)
            lens = np.array([next(lens_all) for _ in range(n)])
            words = rng.integers(1, V + 1, (n, L))
            labels[b, :n] = np.where(np.arange(L)[None] < lens[:, None],
                                     words, 0)
            valid[b, :n] = True
        out.append({"image": image, "height": hw[:, 0], "width": hw[:, 1],
                    "gt_boxes": boxes, "gt_labels": labels,
                    "gt_valid": valid})
    return out


def pinned(batch, cuda):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    return {k: v.pin_memory() for k, v in out.items()} if cuda else out


def to_device(batch, dev):
    cuda = dev.type == "cuda"
    return {k: v.to(dev, non_blocking=cuda) for k, v in batch.items()}


def norm(x):
    return float(torch.linalg.vector_norm(x.float()))


def leaf_norms(tensors):
    return {k: norm(v) for k, v in tensors.items()}


class Snapshot:
    """One window step of the program, in host memory (pinned on the
    card's machine): `before` and `after` hold, by tree path and in the
    program's layout, the trainable leaves ("p") and Adam's moments ("m",
    and "v" before); with Adam's count `t` before the step, the
    generator's state, the batch's index, the sampler's picks and the
    step's loss."""

    def __init__(self, params, cuda):
        def buf(x):
            return torch.empty_strided(x.size(), x.stride(), dtype=x.dtype,
                                       device="cpu", pin_memory=cuda)

        self.before = {k: {path: buf(params[name]) for path, name in
                           PROGRAM_NAMES.items()} for k in "pmv"}
        self.after = {k: {path: buf(params[name]) for path, name in
                          PROGRAM_NAMES.items()} for k in "pm"}
        self.sample = self.loss = self.t = None

    def keep(self, into, params, state):
        """Copies the leaves and moments into `into` (a moment Adam has
        not made yet is zero)."""
        for k, bufs in into.items():
            for path, name in PROGRAM_NAMES.items():
                p = params[name]
                if k == "p":
                    bufs[path].copy_(p.detach(), non_blocking=True)
                    continue
                src = state.get(p, {}).get(
                    "exp_avg" if k == "m" else "exp_avg_sq")
                if src is None:
                    bufs[path].zero_()
                else:
                    bufs[path].copy_(src, non_blocking=True)


class Driver:
    def __init__(self, run):
        self.run = run
        self.spec = run.workload["batch"]
        self.dev = torch.device(run.device)
        self.trainer = None
        self._restore = None

    def setup(self):
        import densecap_tpu_torch.models.localization as loc_mod
        from densecap_tpu_torch.ops.cuda import build
        from densecap_tpu_torch.parallel.train_step import Trainer
        from densecap_tpu_torch.utils.checkpoint import to_torch

        run, cfg, dev = self.run, self.run.cfg, self.dev
        cuda = dev.type == "cuda"
        if cuda:
            build.load()
        self.host = [pinned(b, cuda)
                     for b in make_batches(self.spec, cfg, run.seed)]
        tree = pg.weights_numpy(cfg, run.seed, dev)
        model = to_torch(tree, pg.program_config(cfg), dev, train=True)
        self.trainer = Trainer(model, learning_rate=cfg["learning_rate"],
                               beta1=cfg["optim_beta1"],
                               beta2=cfg["optim_beta2"],
                               eps=cfg["optim_epsilon"])
        self.trainer.set_finetune(cfg["finetune_cnn_after"] == 0)
        self.gen = torch.Generator(device=dev).manual_seed(run.seed + 1)
        self.params = params = dict(model.named_parameters())
        self.p0 = {path: params[name].detach().cpu().clone()
                   for path, name in PROGRAM_NAMES.items()}
        self.snap = Snapshot(params, cuda)
        # from outside: the sampler's picks of the kept window step
        self.capturing = False
        inner = loc_mod.sample_rois

        def sample_rois(*a, **kw):
            out = inner(*a, **kw)
            if self.capturing:
                self.snap.sample = tuple(x.detach().clone() for x in (
                    out.pos_input_idx, out.pos_target_idx, out.pos_valid,
                    out.neg_input_idx, out.neg_valid))
            return out

        loc_mod.sample_rois = sample_rois
        self._restore = (loc_mod, inner)
        if run.tracing:
            self.adam = pg.CudaSpans()
            self.trainer.opt.step = self.adam.wrap(self.trainer.opt.step)
        # the first steps: warm-up, and the start the reference follows
        b1 = cfg["optim_beta1"]
        self.losses, self.step_i = [], 0
        batch = to_device(self.host[0], dev)
        n_start = int(run.workload["check"]["steps"])
        for s in range(n_start):
            if s == n_start - 1:
                sync(dev)
                t0 = time.perf_counter()
            out = self.trainer.step(batch, generator=self.gen)
            self.step_i += 1
            batch = to_device(self.host[self.step_i % len(self.host)], dev)
            self.losses.append(float(out["total_loss"]))
            if s == 0:
                st = self.trainer.opt.state
                self.g1 = leaf_norms({
                    path: (st[params[name]]["exp_avg"] / (1 - b1)
                           if "exp_avg" in st.get(params[name], {})
                           else torch.zeros(()))
                    for path, name in PROGRAM_NAMES.items()})
        sync(dev)
        t_step = time.perf_counter() - t0
        self.delta = {path: norm(params[name].detach().cpu() - self.p0[path])
                      for path, name in PROGRAM_NAMES.items()}
        self.next_batch = batch
        # the kept window step, from the seed, in the first half of the
        # steps an untraced window holds: the profiler of a traced run
        # slows the step by about half, and the window runs on until the
        # kept step is done
        n_est = max(1, int(0.5 * run.seconds / max(t_step, 1e-3)))
        self.kept_step = int(np.random.default_rng([run.seed, 11]
                                                   ).integers(0, n_est))
        if run.tracing:
            self.adam.events.clear()

    def window(self, seconds):
        dev, trainer, snap = self.dev, self.trainer, self.snap
        state = trainer.opt.state
        steps, pending = 0, None
        batch = self.next_batch
        with self.run.window():
            t0 = time.perf_counter()
            while (time.perf_counter() - t0 < seconds
                   or steps <= self.kept_step):
                kept = steps == self.kept_step
                if kept:
                    snap.index = self.step_i % len(self.host)
                    snap.gen_state = self.gen.get_state()
                    snap.t = int(state.get(self.params["lm.Wh"], {}).get(
                        "step", 0))
                    snap.keep(snap.before, self.params, state)
                    self.capturing = True
                out = trainer.step(batch, generator=self.gen)
                if kept:
                    self.capturing = False
                    snap.keep(snap.after, self.params, state)
                    snap.loss = out["total_loss"]
                self.step_i += 1
                steps += 1
                batch = to_device(self.host[self.step_i % len(self.host)],
                                  dev)
                if pending is not None:
                    float(pending)
                pending = out["total_loss"]
            float(pending)
            sync(dev)
            elapsed = time.perf_counter() - t0
        snap.loss = float(snap.loss)
        B = int(self.spec["size"])
        self.run.counters.update(steps=steps, images=steps * B,
                                 kept_step=self.kept_step)
        if self.run.tracing:
            self.run.spans["adam_ms"] = self.adam.ms()
        return {"metrics": {"train_images_per_s": steps * B / elapsed},
                "attempted": steps * B, "failed": 0}

    def release(self):
        if self._restore is not None:
            loc_mod, inner = self._restore
            loc_mod.sample_rois = inner
            self._restore = None
        self.trainer = None
        self.params = None
        self.next_batch = None

    def batch(self, index, half=False):
        batch = to_device(self.host[index], self.dev)
        batch["gt_labels"] = batch["gt_labels"].long()
        if half:
            n = batch["image"].shape[0] // 2
            batch = {k: v[:n] for k, v in batch.items()}
        return batch

    def reference_readings(self, precision="f32", half=False):
        """The reference's losses of the first steps from the seed, its
        first gradient and its change after them, per leaf (norms), and
        the reference itself (its state after them). `half`: a planted
        fault, the loss of each batch's first half alone."""
        run, cfg = self.run, self.run.cfg
        tree = Weights(cfg, run.seed, self.dev).tree
        ref = TrainReference(tree, cfg, precision)
        p0 = {k: v.detach().clone() for k, v in ref.params.items()}
        gen = torch.Generator(device=self.dev).manual_seed(run.seed + 1)
        losses = []
        with f32_math():
            for s in range(int(run.workload["check"]["steps"])):
                loss, grads = ref.step(self.batch(s % len(self.host), half),
                                       gen)
                losses.append(loss)
                if s == 0:
                    g1 = leaf_norms(grads)
                del grads
        delta = leaf_norms({k: ref.params[k].detach() - p0[k]
                            for k in TRAINABLE})
        ref.gen = gen
        return losses, g1, delta, ref

    def replay(self, state, index, gen_state, precision="f32", given=None,
               half=False):
        """One step of the reference from `state` (params, m, v by tree
        path in the tree's layout, and Adam's count) on batch `index`,
        the generator at `gen_state`; `given`: the sample to take. ->
        (loss, {path: gradient}, {path: change}, the reference)."""
        run, cfg = self.run, self.run.cfg
        ref = TrainReference(Weights(cfg, run.seed, self.dev).tree, cfg,
                             precision)
        ref.load_state(*state)
        p0 = {k: v.detach().clone() for k, v in ref.params.items()}
        gen = torch.Generator(device=self.dev)
        gen.set_state(gen_state)
        with f32_math():
            loss, grads = ref.step(self.batch(index, half), gen, given)
        change = {k: ref.params[k].detach() - p0[k] for k in TRAINABLE}
        return loss, grads, change, ref

    def check(self):
        losses, g1, delta, ref = self.reference_readings()
        del ref
        out = compare((self.losses, self.g1, self.delta),
                      (losses, g1, delta))
        out.update(self.check_kept_step())
        return out

    def check_kept_step(self):
        """The kept window step, replayed by the reference from the
        program's state before it with the program's sample."""
        snap, dev, b1 = self.snap, self.dev, self.run.cfg["optim_beta1"]

        def tree_of(bufs):
            return {path: tree_layout(path, bufs[path].to(dev))
                    for path in TRAINABLE}

        state = (tree_of(snap.before["p"]), tree_of(snap.before["m"]),
                 tree_of(snap.before["v"]), snap.t)
        given = tuple(x.to(dev) for x in snap.sample)
        loss, grads, change, ref = self.replay(state, snap.index,
                                               snap.gen_state, given=given)
        m0, p0 = state[1], state[0]
        del state
        prog_g, prog_d = {}, {}
        for path in TRAINABLE:
            m1 = tree_layout(path, snap.after["m"][path].to(dev))
            p1 = tree_layout(path, snap.after["p"][path].to(dev))
            prog_g[path] = (m1 - b1 * m0.pop(path)) / (1 - b1)
            prog_d[path] = p1 - p0.pop(path)
        return step_numbers((snap.loss, prog_g, prog_d),
                            (loss, grads, change), ref.sample_mismatch)


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def step_numbers(prog, ref, mismatch):
    """The numbers of one replayed step: the relative loss gap; for the
    change of the leaves, each leaf's gap between the program's norm and
    the reference's over the larger of the reference leaf's norm and the
    median leaf's, by the worst leaf (as `compare`); for the change of
    the language model's leaves (`lm/...`), the norm of the difference
    over the reference leaf's norm, by the median leaf; and, beside them,
    the same norms of the difference for the gradient as Adam gets it
    and for the change of every leaf, by the median leaf and by the
    worst, and the share of the program's sample that the reference's
    own draw lacks. Leaves whose reference gradient is under a thousandth
    of the median leaf's are left out (round-off alone moves them under
    Adam)."""
    (pl, pg_, pd), (rl, rg, rd) = prog, ref
    gn = {k: norm(v) for k, v in rg.items()}
    med = statistics.median(gn.values())
    live = [k for k in rg if gn[k] >= 1e-3 * med]
    ge = {k: norm(pg_[k] - rg[k]) / gn[k] for k in live}
    dn = {k: norm(rd[k]) for k in live}
    med_d = statistics.median(dn.values())
    dg = {k: abs(norm(pd[k]) - dn[k]) / max(dn[k], med_d) for k in live}
    de = {k: norm(pd[k] - rd[k]) / max(dn[k], 1e-30) for k in live}
    lm = [de[k] for k in live if k.startswith("lm/")]
    return {"step_loss_gap": abs(pl - rl) / abs(rl),
            "step_change_gap": max(dg.values()),
            "step_lm_change_err": statistics.median(lm),
            "step_grad_err": statistics.median(ge.values()),
            "step_grad_err_max": max(ge.values()),
            "step_change_err": statistics.median(de.values()),
            "step_change_err_max": max(de.values()),
            "step_sample_mismatch": mismatch,
            "step_grad_err_by_leaf": ge, "step_change_err_by_leaf": de}


def compare(prog, ref):
    """The numbers: the first step's relative loss gap; for the first
    gradient and for the change after the steps, each leaf's gap between
    the program's norm and the reference's, over the larger of the
    reference leaf's norm and the median leaf's, by the worst leaf and by
    the median leaf. Leaves whose reference gradient is under a thousandth
    of the median leaf's are left out of the change (round-off alone moves
    them under Adam). The losses of the later steps and each leaf's gaps
    go beside them. Which are compared is the cell's `limits`."""
    (pl, pg1, pd), (rl, rg1, rd) = prog, ref
    med_g = statistics.median(rg1.values())
    med_d = statistics.median(rd.values())
    grad = {k: abs(pg1[k] - rg1[k]) / max(rg1[k], med_g) for k in rg1}
    moved = [k for k in rd if rg1[k] >= 1e-3 * med_g]
    change = {k: abs(pd[k] - rd[k]) / max(rd[k], med_d) for k in moved}
    return {"loss_gap": abs(pl[0] - rl[0]) / abs(rl[0]),
            "grad_gap": max(grad.values()),
            "grad_median_gap": statistics.median(grad.values()),
            "change_gap": max(change.values()),
            "change_median_gap": statistics.median(change.values()),
            "later_loss_gap": max(abs(a - b) / abs(b)
                                  for a, b in zip(pl, rl)),
            "left_out": sorted(set(rd) - set(moved)),
            "losses": [list(pl), list(rl)],
            "grad_by_leaf": grad, "change_by_leaf": change}
