"""The hand FLOP count of DenseCap's inference and training programs: a
frozen copy of `scripts/torch_mfu_estimate.py` (`inference_flops`,
`train_flops`, `decode_steps` and their helpers), kept here so that the
yardstick does not move with the scripts. `tests/test_flops.py` holds it
equal to the script at the cells' shapes.

Two FLOPs per multiply-add of every convolution and matrix product;
nothing for elementwise work, sorts, NMS or RoI align's sampling. `cfg` is
a configuration file's dict.
"""

from __future__ import annotations

import numpy as np

from .weights import NUM_ANCHORS, TRUNK1, TRUNK2

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 (data sheet)


def conv(B, H, W, cin, cout, k=3):
    return 2 * B * H * W * cin * cout * k * k


def dot(rows, k, n):
    return 2 * rows * k * n


def trunk_layers(B, H, W):
    """[(name, FLOPs, trunk)] of VGG-16's convs on a B x H x W canvas."""
    out, cin = [], 3
    for part, spec in (("trunk1", TRUNK1), ("trunk2", TRUNK2)):
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
    k, nf = NUM_ANCHORS, cfg["rpn_num_filters"]
    C = TRUNK2[-1][1]
    return {"conv": conv(B, Hf, Wf, C, nf, cfg["rpn_filter_size"]),
            "heads": conv(B, Hf, Wf, nf, 6 * k, 1)}


def recog_in(cfg):
    return cfg["output_height"] * cfg["output_width"] * TRUNK2[-1][1]


def lengths_to_end(captions, end_token):
    is_end = captions == end_token
    return np.where(is_end.any(1), is_end.argmax(1), captions.shape[1])


def decode_steps(captions, end_token, seq_length):
    """The greedy loop's iterations for `captions` (..., T): the longest
    caption up to its first END, plus one, at most T."""
    caps = np.asarray(captions).reshape(-1, np.shape(captions)[-1])
    if caps.size == 0:
        return 0
    return int(min(seq_length, lengths_to_end(caps, end_token).max() + 1))


def inference_flops(cfg, B, H, W, steps, rois=None):
    """FLOPs of `forward_test_batch` at batch B on an H x W canvas whose
    greedy decode ran `steps` steps, by part, with the total."""
    K = cfg["test_max_proposals"] if rois is None else rois
    F, E, Hd, V = (cfg["fc_dim"], cfg["rnn_encoding_size"], cfg["rnn_size"],
                   cfg["vocab_size"])
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
    """FLOPs of one train step at batch B on an H x W canvas, forward and
    backward, by part, with the total."""
    F, E, Hd, V = (cfg["fc_dim"], cfg["rnn_encoding_size"], cfg["rnn_size"],
                   cfg["vocab_size"])
    T = cfg["seq_length"]
    P = cfg["sampler_batch_size"] // 2
    R = P + cfg["sampler_batch_size"]
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
    t2 = [f for _, f, part in layers if part == "trunk2"]
    bwd["trunk"] = (sum(t2) + sum(t2[1:])) if finetune else 0
    bwd["rpn"] = 2 * rpn["heads"] + rpn["conv"] * (2 if finetune else 1)
    bwd["recog"] = 2 * fwd["recog"]
    bwd["heads"] = 2 * heads
    bwd["lm"] = 2 * fwd["lm"] - dot(n, Hd, 4 * Hd)
    parts = {"forward": fwd, "backward": bwd}
    parts["total"] = sum(fwd.values()) + sum(bwd.values())
    return parts
