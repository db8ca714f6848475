"""Device time of the port's B=8 flagship train step, stage by stage.

Twin of scripts/stage_profile_train.py. `forward_train` is cut into the
stages it runs (`chain`: trunk, localization, recognition, the heads, the
language model, the losses), each a function of the outputs of the ones
before; chained, they give `forward_train`'s losses
(tests/test_torch_tools.py holds them equal). Timed alone, forward (without
autograd) and forward + backward, on device-resident inputs:

  trunk        `DenseCap.features` (frozen: no gradient)
  rpn          the RPN conv and heads with the box-decay mask
  localize     `localize_train`: RPN, sampler, RoI align, mid losses
  roi_align    K2 on the sampled boxes; with the backward K2b (the
               positions only, as while the trunk is frozen)
  recog        fc6 / fc7 with dropout
  lm           teacher-forced LSTM over T + 2 steps on the positives
  loss         the whole `batched_loss`
  adam         `torch.optim.Adam.step` over the f32 masters (the main zone)
  step         one whole `Trainer.step`

Each row: CUDA events around `--reps` back-to-back calls, repeated
`--iters` times, the median per call. Defaults: the frozen step at B=8 on
the 720 px square with 720x540 content, vocab 10 000, sampler 256, 128 gt
slots (20 valid), bf16, `fuse_conv_pool` on (K3 in trunk1, as
chip_smoke.py trains), random weights from seed 0.

    python scripts/torch_stage_profile_train.py [--reps 10]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_tool_common as tc  # noqa: E402
from torch_stage_profile_b8 import time_stage  # noqa: E402
from densecap_tpu_torch.models.localization import localize_train  # noqa: E402
from densecap_tpu_torch.models.lstm import get_target  # noqa: E402
from densecap_tpu_torch.models.vgg16 import feat_extent  # noqa: E402
from densecap_tpu_torch.ops import losses as L  # noqa: E402
from densecap_tpu_torch.ops.roi_align import roi_align  # noqa: E402
from densecap_tpu_torch.parallel.train_step import (  # noqa: E402
    Trainer, batched_loss)
from densecap_tpu_torch.utils.checkpoint import (  # noqa: E402
    init_params, to_torch)


def trunk(m, s):
    s["feats"] = m.features(s["image"], s["height"], s["width"])


def localize(m, s):
    cfg = m.cfg
    s["loc"] = localize_train(
        m.rpn, s["feats"], s["height"], s["width"], s["gt_boxes"],
        s["gt_labels"], s["gt_valid"], s["generator"], cfg,
        cfg.anchor_tensor(s["feats"].device),
        debug_sampler=s.get("debug_sampler"))


def recog(m, s):
    s["codes"] = m.recog(s["loc"].roi_feats.flatten(0, 1),
                         drop_prob=m.cfg.drop_prob, generator=s["generator"])


def heads(m, s):
    """The final objectness and box losses, and the positives' codes."""
    cfg, loc, codes = m.cfg, s["loc"], s["codes"]
    B, R = loc.roi_boxes.shape[:2]
    P = loc.pos_valid.shape[1]
    roi_valid = torch.cat([loc.pos_valid, loc.neg_valid], 1)
    obj_scores = m._linear(codes, m.obj_w, m.obj_b)
    obj_labels = torch.cat([loc.pos_valid.long(),
                            torch.zeros_like(loc.neg_valid.long())], 1)
    s["end_obj"] = cfg.end_objectness_weight * L.logistic(
        obj_scores.reshape(B, R, -1), obj_labels, roi_valid)
    s["pos_codes"] = codes.reshape(B, R, -1)[:, :P].flatten(0, 1)
    final_trans = m._linear(s["pos_codes"], m.box_w, m.box_b)
    s["end_box"] = L.box_regression(
        loc.pos_boxes, final_trans.reshape(B, P, 4), loc.pos_target_boxes,
        loc.pos_valid, weight=cfg.end_box_reg_weight)


def lm(m, s):
    cfg, loc = m.cfg, s["loc"]
    B, P = loc.pos_valid.shape
    labels = loc.pos_target_labels
    scores = m.lm.forward_train(s["pos_codes"], labels.flatten(0, 1))
    s["cap"] = cfg.captioning_weight * L.temporal_cross_entropy(
        scores.reshape(B, P, *scores.shape[1:]),
        get_target(labels, cfg.vocab_size), loc.pos_valid)


def losses(m, s):
    out = dict(s["loc"].losses)
    out["end_objectness_loss"] = s["end_obj"]
    out["end_box_reg_loss"] = s["end_box"]
    out["captioning_loss"] = s["cap"]
    out["total_loss"] = (out["mid_objectness_loss"] + out["mid_box_reg_loss"]
                         + out["box_decay_loss"] + s["end_obj"]
                         + s["end_box"] + s["cap"])
    s["losses"] = out


CHAIN = (("trunk", trunk), ("localize", localize), ("recog", recog),
         ("heads", heads), ("lm", lm), ("losses", losses))


def chain(model, batch, generator=None, debug_sampler=None):
    """`forward_train`'s stages chained on a batch of device tensors ->
    the state; its "losses" are `forward_train`'s per-image losses."""
    s = dict(batch, height=batch["height"].float(),
             width=batch["width"].float(), generator=generator,
             debug_sampler=debug_sampler)
    for _, fn in CHAIN:
        fn(model, s)
    return s


def checksum(x):
    """A scalar over every float tensor of x (a tensor, tuple or dict)."""
    if isinstance(x, torch.Tensor):
        return x.float().sum() if x.is_floating_point() else 0.0
    vals = x.values() if isinstance(x, dict) else x
    return sum(checksum(v) for v in vals)


def backward(model, out):
    torch.autograd.backward(checksum(out))
    model.zero_grad(set_to_none=True)


def no_grad(fn):
    with torch.no_grad():
        fn(False)


def stage_calls(model, trainer, batch, state, gen):
    """{row name: a call} of the module docstring's rows."""
    cfg = model.cfg
    feats, loc = state["feats"], state["loc"]
    anchors = cfg.anchor_tensor(feats.device)
    fh, fw = feat_extent(state["height"], state["width"])
    feats_nhwc = feats.permute(0, 2, 3, 1).contiguous()
    roi_boxes = loc.roi_boxes.detach()
    roi_feats = loc.roi_feats.detach()
    lm_state = dict(state, pos_codes=state["pos_codes"].detach())

    def rpn(grad):
        out = model.rpn(feats, anchors, cfg.field_centers,
                        box_reg_decay=cfg.box_reg_decay)
        if grad:
            backward(model, out[:1] + out[2:])

    def loc_call(grad):
        s = dict(state, generator=gen)
        localize(model, s)
        if grad:
            lo = s["loc"]
            backward(model, (lo.roi_feats, lo.losses, lo.pos_boxes,
                             lo.pos_trans))

    def roi(grad):
        b = roi_boxes.clone().requires_grad_(grad)
        out = roi_align(feats_nhwc, b, state["height"], state["width"], fh,
                        fw, cfg.output_height, cfg.output_width)
        if grad:
            backward(model, out)

    def rec(grad):
        x = roi_feats.clone().requires_grad_(grad)
        out = model.recog(x.flatten(0, 1), drop_prob=cfg.drop_prob,
                          generator=gen)
        if grad:
            backward(model, out)

    def lm_call(grad):
        s = dict(lm_state)
        if grad:
            s["pos_codes"] = s["pos_codes"].clone().requires_grad_()
        lm(model, s)
        if grad:
            backward(model, s["cap"])

    def loss(grad):
        out = batched_loss(model, batch, gen)
        if grad:
            backward(model, out["total_loss"])

    def trunk_fwd():
        with torch.no_grad():
            model.features(batch["image"], state["height"], state["width"])

    calls = {"trunk": trunk_fwd}
    for name, fn in (("rpn", rpn), ("localize", loc_call), ("roi_align", roi),
                     ("recog", rec), ("lm", lm_call), ("loss", loss)):
        calls[f"{name} fwd"] = lambda fn=fn: no_grad(fn)
        calls[f"{name} fwd+bwd"] = lambda fn=fn: fn(True)
    # Adam over the gradients of one whole backward, put back before each
    # call (the other rows clear them)
    batched_loss(model, batch, gen)["total_loss"].backward()
    grads = [(p, p.grad) for p in model.parameters() if p.grad is not None]
    model.zero_grad(set_to_none=True)

    def adam():
        for p, g in grads:
            p.grad = g
        trainer.opt.step()

    calls["adam"] = adam
    calls["step"] = lambda: trainer.step(batch, generator=gen)
    return calls


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    tc.add_model_flags(ap)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--sampler_batch_size", type=int, default=256)
    ap.add_argument("--max_gt_boxes", type=int, default=128)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--iters", type=int, default=3)
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    dev = tc.card(args.device)
    device = tc.print_device(dev)
    cfg = tc.model_config(args, sampler_batch_size=args.sampler_batch_size,
                          max_gt_boxes=args.max_gt_boxes,
                          fuse_conv_pool=True)
    model = to_torch(init_params(cfg, seed=0), cfg, dev, train=True)
    trainer = Trainer(model, learning_rate=1e-5)
    B, S = args.batch, cfg.image_size
    batch = tc.train_batch(model.cfg, B, S, S, S * 0.75, dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    with torch.no_grad():
        state = chain(model, batch, gen)
    rows, counts = {}, {}
    for name, call in stage_calls(model, trainer, batch, state, gen).items():
        ms, counts[name] = tc.launches_of(
            lambda call=call: time_stage(call, args.reps, args.iters, dev))
        rows[name] = ms
        print(f"{name:20s} " + (ms if isinstance(ms, str)
                                else f"{ms:8.3f} ms/call"), flush=True)
    if dev.type == "cuda":
        need = {"roi_align fwd+bwd": "roi_align_bwd", "step": "roi_align_bwd",
                "trunk": "conv_pool",
                "roi_align fwd": "roi_align"}
        for row, kernel in need.items():
            if not counts[row][kernel]:
                raise SystemExit(f"{kernel} never launched in {row}")
    return tc.emit({
        "check": "stage_profile_train", "device": device, "batch": B,
        "canvas": [S, S], "stages_ms": rows,
        "rois_per_image": int(state["loc"].roi_boxes.shape[1]),
        "launches": counts})


if __name__ == "__main__":
    main()
