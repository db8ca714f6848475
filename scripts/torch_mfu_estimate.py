"""MFU of the port's flagship inference and training programs on the card.

Twin of scripts/mfu_estimate.py. There is no compiler cost analysis to
ask, so the FLOPs are counted by hand from the shapes of the program that
runs (`inference_flops`, `train_flops`, importable by a benchmark): two
per multiply-add of every convolution and matrix product, nothing for
elementwise work, sorts, NMS or RoI align's bilinear sampling.

  * trunk: VGG-16's 13 3x3 convs over the whole canvas (H x W, halved
    with floor at each pool), whatever part of it holds the image;
  * RPN: the 3x3 conv and the two 1x1 heads on the H/16 x W/16 map;
  * fc6, fc7 and the two heads on every RoI slot the program carries
    (B x test_max_proposals after NMS: padded slots are computed too);
  * the greedy decode: the image encoding, one LSTM step on it, then
    `steps` steps of LSTM + vocab projection, where `steps` is what the
    loop ran (`decode_steps`: the longest caption up to its first END,
    plus one, at most T; the loop exits early on a trained model);
  * training: the forward at the sampler's 384 RoIs per image (128 of
    them positives, which the box head and the LM take, over T + 2
    steps), and a backward of one product per gradient taken: the
    weight's for every trainable layer, the input's wherever the input
    depends on a trainable weight. Trunk1 never trains; trunk2 only
    after the finetune flip; the RPN conv's input gradient only then.
    RoI align's position gradient (K2b) is elementwise and not counted.

MFU = FLOPs / time / 989 TFLOP/s (the H100 SXM's dense bf16 peak), beside
the card's power limit. Times: CUDA events around each call, median of
`--iters`, after a warm-up. Programs: inference at B=8 on the 720 px
square and on the 720x544 bucket (720x540 content), random weights from
seed 0 (the worst-case decode); the frozen and finetune train steps at
B=8 on the square.

    python scripts/torch_mfu_estimate.py [--iters 10] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_tool_common as tc  # noqa: E402
from densecap_tpu_torch.models.vgg16 import TRUNK1_CFG, TRUNK2_CFG  # noqa: E402
from densecap_tpu_torch.parallel.train_step import Trainer  # noqa: E402
from densecap_tpu_torch.utils.checkpoint import (  # noqa: E402
    init_params, to_torch)

PEAK_BF16 = 989e12  # H100 SXM dense bf16 FLOP/s (data sheet)


def conv(B, H, W, cin, cout, k=3):
    return 2 * B * H * W * cin * cout * k * k


def dot(rows, k, n):
    return 2 * rows * k * n


def trunk_layers(B, H, W):
    """[(name, FLOPs, trunk)] of VGG-16's convs on a B x H x W canvas."""
    out, cin = [], 3
    for part, spec in (("trunk1", TRUNK1_CFG), ("trunk2", TRUNK2_CFG)):
        for item in spec:
            if item == "M":
                H, W = H // 2, W // 2
                continue
            name, cout = item
            out.append((name, conv(B, H, W, cin, cout), part))
            cin = cout
    return out


def feature_hw(H, W):
    for _ in range(4):
        H, W = H // 2, W // 2
    return H, W


def rpn_flops(cfg, B, Hf, Wf):
    k, nf = cfg.num_anchors, cfg.rpn_num_filters
    C = TRUNK2_CFG[-1][1]
    return {"conv": conv(B, Hf, Wf, C, nf, cfg.rpn_filter_size),
            "heads": conv(B, Hf, Wf, nf, 6 * k, 1)}


def recog_in(cfg):
    return cfg.output_height * cfg.output_width * TRUNK2_CFG[-1][1]


def decode_steps(captions, end_token, seq_length):
    """The greedy loop's iterations for `captions` (..., T): it stops at
    the start of the step after every row has emitted END, so the longest
    caption up to its first END, plus one, at most T."""
    caps = np.asarray(captions).reshape(-1, np.shape(captions)[-1])
    if caps.size == 0:
        return 0
    return int(min(seq_length, tc.lengths_to_end(caps, end_token).max() + 1))


def inference_flops(cfg, B, H, W, steps, rois=None):
    """FLOPs of `forward_test_batch` at batch B on an H x W canvas whose
    greedy decode ran `steps` steps, by part, with the total. `rois`: the
    RoI slots per image (cfg.test_max_proposals)."""
    K = cfg.test_max_proposals if rois is None else rois
    F, E, Hd, V = cfg.fc_dim, cfg.rnn_encoding_size, cfg.rnn_size, \
        cfg.vocab_size
    n = B * K
    lstm = dot(n, E, 4 * Hd) + dot(n, Hd, 4 * Hd)
    parts = {
        "trunk": sum(f for _, f, _ in trunk_layers(B, H, W)),
        "rpn": sum(rpn_flops(cfg, B, *feature_hw(H, W)).values()),
        "recog": dot(n, recog_in(cfg), F) + dot(n, F, F),
        "heads": dot(n, F, 1) + dot(n, F, 4),
        "decode": (dot(n, F, E) + lstm
                   + steps * (lstm + dot(n, Hd, V + 1))),
    }
    parts["total"] = sum(parts.values())
    return parts


def train_flops(cfg, B, H, W, finetune):
    """FLOPs of one train step (`Trainer.step`) at batch B on an H x W
    canvas, forward and backward, by part, with the total. Positives P =
    sampler_batch_size / 2 and RoIs R = P + sampler_batch_size per image,
    the slots the program carries; the LM runs T + 2 steps on the P."""
    F, E, Hd, V = cfg.fc_dim, cfg.rnn_encoding_size, cfg.rnn_size, \
        cfg.vocab_size
    T = cfg.seq_length
    P = cfg.sampler_batch_size // 2
    R = P + cfg.sampler_batch_size
    Hf, Wf = feature_hw(H, W)
    layers = trunk_layers(B, H, W)
    fwd = {"trunk": sum(f for _, f, _ in layers)}
    rpn = rpn_flops(cfg, B, Hf, Wf)
    fwd["rpn"] = sum(rpn.values())
    recog = [dot(B * R, recog_in(cfg), F), dot(B * R, F, F)]
    fwd["recog"] = sum(recog)
    heads = dot(B * R, F, 1) + dot(B * P, F, 4)
    fwd["heads"] = heads
    n = B * P
    step = dot(n, E, 4 * Hd) + dot(n, Hd, 4 * Hd)
    enc, proj = dot(n, F, E), dot(n, Hd, V + 1)
    fwd["lm"] = enc + (T + 2) * (step + proj)

    bwd = {}
    # trunk2 after the flip: every conv's weight gradient, and the input
    # gradient of all but conv3_1 (its input comes from frozen trunk1)
    t2 = [f for _, f, part in layers if part == "trunk2"]
    bwd["trunk"] = (sum(t2) + sum(t2[1:])) if finetune else 0
    # RPN: both products of the heads; the conv's input gradient only
    # when trunk2 trains
    bwd["rpn"] = 2 * rpn["heads"] + rpn["conv"] * (2 if finetune else 1)
    # fc6's input depends on the RoI positions, so both products everywhere
    bwd["recog"] = 2 * fwd["recog"]
    bwd["heads"] = 2 * heads
    # the first LSTM step multiplies a zero state that takes no gradient
    bwd["lm"] = 2 * fwd["lm"] - dot(n, Hd, 4 * Hd)
    parts = {"forward": fwd, "backward": bwd}
    parts["total"] = sum(fwd.values()) + sum(bwd.values())
    return parts


def mfu(flops, ms):
    return ms if isinstance(ms, str) else flops / (ms * 1e-3) / PEAK_BF16


def report(name, flops, times, B, dev, **extra):
    ms = tc.median(times)
    line = {"program": name, "flops": flops["total"], "flops_by_part": {
        k: v for k, v in flops.items() if k != "total"}, "ms_per_step": ms,
        "images_per_s": tc.rate(B, ms),
        "tflops_per_s": ms if isinstance(ms, str) else
        flops["total"] / (ms * 1e-3) / 1e12,
        "mfu": mfu(flops["total"], ms), **extra}
    mfu_s = line["mfu"] if isinstance(line["mfu"], str) else \
        f"{100 * line['mfu']:.1f}%"
    print(f"{name}: {flops['total'] / 1e12:.3f} TFLOP per step, "
          f"{ms if isinstance(ms, str) else f'{ms:.2f} ms'}, MFU {mfu_s}",
          flush=True)
    return line


def inference(model, B, H, W, content_w, iters, dev, seed=1):
    cfg = model.cfg
    images = torch.from_numpy(tc.random_canvases((B, H, W, 3), seed)).to(dev)
    hs = torch.full((B,), float(H), device=dev)
    ws = torch.full((B,), float(content_w), device=dev)
    out = model.forward_test_batch(images, hs, ws)
    steps = decode_steps(out.captions.cpu().numpy(), cfg.vocab_size + 1,
                         cfg.seq_length)
    times = tc.call_ms(lambda: model.forward_test_batch(images, hs, ws),
                       iters, dev)
    return inference_flops(cfg, B, H, W, steps,
                           rois=out.boxes.shape[1]), times, steps


def train(params, cfg, B, H, content_w, finetune, iters, dev):
    model = to_torch(params, cfg, dev, train=True)
    trainer = Trainer(model, learning_rate=1e-5)
    trainer.set_finetune(finetune)
    batch = tc.train_batch(cfg, B, H, H, content_w, dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    times = tc.call_ms(lambda: trainer.step(batch, generator=gen), iters,
                       dev)
    del trainer, model
    return train_flops(cfg, B, H, H, finetune), times


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    tc.add_model_flags(ap)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--bucket_w", type=int, default=544)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--sampler_batch_size", type=int, default=256)
    ap.add_argument("--max_gt_boxes", type=int, default=128)
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    dev = tc.card(args.device)
    device = tc.print_device(dev)
    cfg = tc.model_config(args, sampler_batch_size=args.sampler_batch_size,
                          max_gt_boxes=args.max_gt_boxes)
    B, S = args.batch, cfg.image_size
    content_w = S * 0.75
    params = init_params(cfg, seed=0)
    model = to_torch(params, cfg, dev)
    lines = []
    for name, W in ((f"inference B={B} {S}px square", S),
                    (f"inference B={B} {S}x{args.bucket_w} bucket",
                     args.bucket_w)):
        flops, times, steps = inference(model, B, S, W, content_w,
                                        args.iters, dev)
        lines.append(report(name, flops, times, B, dev, decode_steps=steps))
    del model
    for label, finetune in (("frozen", False), ("finetune", True)):
        flops, times = train(params, cfg, B, S, content_w, finetune,
                             args.iters, dev)
        lines.append(report(f"train_step B={B} {S}px {label}", flops,
                            times, B, dev))
    return tc.emit({"check": "mfu_estimate", "device": device,
                    "peak_flops": PEAK_BF16, "programs": lines})


if __name__ == "__main__":
    main()
