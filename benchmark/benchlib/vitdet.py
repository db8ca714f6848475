"""What the ViTDet cells share: the seed's weights with a ViTDet trunk,
the hand FLOP count of its forward, the least time of a global block's
attention core, and the program's ViTDet spans read per call.

Weights. The tree of `weights.Weights` with the trunk under "vit" in
place of VGG-16's ("trunk1" / "trunk2"), and the RPN conv and fc6 reading
`vit_out_channels` channels. Init laws (the configuration's `assumed`):
N(0, 0.02) for the patch embedding, the linear layers, the position
table and the relative-position tables; He-normal over fan-out for the
neck's convs (detectron2's c2_msra_fill); zero biases; unit LayerNorm
weights; the DenseCap heads and LM as `weights.leaves` has them.

FLOPs. Two a multiply-add, as `flops.py`: the patch embedding, each
block's qkv over the padded windows (the padding's keys and values are
needed), its output projection and MLP over the grid, the attention's
two products and the relative terms' (2 x 2 L S d a head), the neck's
convs; the shared stages at `vit_out_channels` channels with
`flops.py`'s own functions.
"""

from __future__ import annotations

import numpy as np
import torch

from . import flops, roofline
from .program_spans import window_summary
from .weights import Weights, _insert, leaves

STD = 0.02


def blocks(cfg):
    """[(index, window or 0 for a global block)]."""
    glob = set(cfg["vit_global_blocks"])
    return [(i, 0 if i in glob else cfg["vit_window_size"])
            for i in range(cfg["vit_depth"])]


def grid(cfg):
    return cfg["vit_img_size"] // cfg["vit_patch_size"]


def vit_leaves(cfg):
    """[(path, shape, law, scale)] of the trunk, under "vit/"."""
    C, p = cfg["vit_embed_dim"], cfg["vit_patch_size"]
    hd, g = C // cfg["vit_num_heads"], cfg["vit_pretrain_grid"]
    hid, out = int(C * cfg["vit_mlp_ratio"]), cfg["vit_out_channels"]
    n = ("normal", STD)
    z, one = ("zeros", 0.0), ("ones", 1.0)
    spec = [("patch_embed/w", (p, p, 3, C), *n), ("patch_embed/b", (C,), *z),
            ("pos_embed", (g, g, C), *n)]
    for i, window in blocks(cfg):
        S = window or grid(cfg)
        b = f"block{i}/"
        spec += [(b + "norm1/w", (C,), *one), (b + "norm1/b", (C,), *z),
                 (b + "attn/qkv/w", (C, 3 * C), *n),
                 (b + "attn/qkv/b", (3 * C,), *z),
                 (b + "attn/proj/w", (C, C), *n),
                 (b + "attn/proj/b", (C,), *z),
                 (b + "attn/rel_pos_h", (2 * S - 1, hd), *n),
                 (b + "attn/rel_pos_w", (2 * S - 1, hd), *n),
                 (b + "norm2/w", (C,), *one), (b + "norm2/b", (C,), *z),
                 (b + "mlp/fc1/w", (C, hid), *n),
                 (b + "mlp/fc1/b", (hid,), *z),
                 (b + "mlp/fc2/w", (hid, C), *n), (b + "mlp/fc2/b", (C,), *z)]
    spec += [("neck/conv1/w", (1, 1, C, out), "normal", (2.0 / out) ** 0.5),
             ("neck/ln1/w", (out,), *one), ("neck/ln1/b", (out,), *z),
             ("neck/conv2/w", (3, 3, out, out), "normal",
              (2.0 / (9 * out)) ** 0.5),
             ("neck/ln2/w", (out,), *one), ("neck/ln2/b", (out,), *z)]
    return [("vit/" + path, shape, law, scale)
            for path, shape, law, scale in spec]


def head_leaves(cfg):
    """`weights.leaves` without VGG-16, its RPN conv and fc6 reading the
    neck's channels."""
    c = cfg["vit_out_channels"]
    out = []
    for path, shape, law, scale in leaves(cfg):
        if path.startswith("trunk"):
            continue
        if path == "rpn/conv/w":
            shape = shape[:2] + (c, shape[3])
        elif path == "recog/fc6/w":
            in_dim = cfg["output_height"] * cfg["output_width"] * c
            shape, scale = (in_dim, shape[1]), (2.0 / in_dim) ** 0.5
        out.append((path, shape, law, scale))
    return out


class VitWeights(Weights):
    """`weights.Weights` for a ViTDet configuration: its leaves, and unit
    LayerNorm weights (law "ones"), drawn the same way."""

    def __init__(self, cfg, seed, device):
        self.layout = vit_leaves(cfg) + head_leaves(cfg)
        gen = torch.Generator(device=device).manual_seed(int(seed))
        sizes = {"normal": 0, "uniform": 0}
        for _, shape, law, _ in self.layout:
            if law in sizes:
                sizes[law] += int(np.prod(shape))
        self.buffers = {
            "normal": torch.randn(sizes["normal"], generator=gen,
                                  device=device),
            "uniform": torch.rand(sizes["uniform"], generator=gen,
                                  device=device).mul_(2.0).sub_(1.0)}
        self.slices, self.tree = {}, {}
        offset = {"normal": 0, "uniform": 0}
        for path, shape, law, scale in self.layout:
            if law in ("zeros", "ones"):
                leaf = torch.full(shape, scale, device=device)
            else:
                n = int(np.prod(shape))
                start = offset[law]
                offset[law] += n
                self.slices[path] = (law, start, n, shape)
                leaf = self.buffers[law][start:start + n].view(shape)
                leaf.mul_(scale)
            _insert(self.tree, path, leaf)

    def tree_numpy(self):
        host = {k: v.cpu().numpy() for k, v in self.buffers.items()}
        out = {}
        for path, shape, law, scale in self.layout:
            if law in ("zeros", "ones"):
                leaf = np.full(shape, scale, np.float32)
            else:
                _, start, n, _ = self.slices[path]
                leaf = host[law][start:start + n].reshape(shape)
            _insert(out, path, leaf)
        return out


def weights_numpy(cfg, seed, device):
    """As `program.weights_numpy`, for a ViTDet configuration."""
    w = VitWeights(cfg, seed, device)
    tree = w.tree_numpy()
    del w
    return tree


# -- FLOPs ----------------------------------------------------------------

def attn_core_flops(n, L, S, d, heads):
    """The attention core of n (windows or images) of L tokens on an S x S
    grid: the two products and the relative terms, 2 x 2 L S d each."""
    return n * heads * (4 * L * L * d + 4 * L * S * d)


def trunk_flops(cfg, B):
    """{"embed", "linear", "window_attn", "global_attn", "neck"} at batch
    B, with "total"."""
    C, p, heads = (cfg["vit_embed_dim"], cfg["vit_patch_size"],
                   cfg["vit_num_heads"])
    d, hid = C // heads, int(C * cfg["vit_mlp_ratio"])
    out = cfg["vit_out_channels"]
    G = grid(cfg)
    T = B * G * G
    parts = {"embed": flops.dot(T, p * p * 3, C), "linear": 0,
             "window_attn": 0, "global_attn": 0,
             "neck": flops.dot(T, C, out) + flops.conv(B, G, G, out, out)}
    for _, window in blocks(cfg):
        if window:
            Gp = G + (-G % window)
            n = B * (Gp // window) ** 2
            qkv_rows = B * Gp * Gp
            parts["window_attn"] += attn_core_flops(n, window * window,
                                                    window, d, heads)
        else:
            qkv_rows = T
            parts["global_attn"] += attn_core_flops(B, G * G, G, d, heads)
        parts["linear"] += (flops.dot(qkv_rows, C, 3 * C) + flops.dot(T, C, C)
                            + flops.dot(T, C, hid) + flops.dot(T, hid, C))
    parts["total"] = sum(parts.values())
    return parts


def inference_flops(cfg, B, steps):
    """`forward_test_batch` with a ViTDet trunk: the trunk above, the RPN
    and fc6 at `vit_out_channels` channels, and the heads and decode of
    `flops.inference_flops`."""
    G, c = grid(cfg), cfg["vit_out_channels"]
    K = cfg["test_max_proposals"]
    n, F = B * K, cfg["fc_dim"]
    shared = flops.inference_flops(cfg, B, 16 * G, 16 * G, steps)
    nf, k = cfg["rpn_num_filters"], flops.NUM_ANCHORS
    parts = {"trunk": trunk_flops(cfg, B)["total"],
             "rpn": (flops.conv(B, G, G, c, nf, cfg["rpn_filter_size"])
                     + flops.conv(B, G, G, nf, 6 * k, 1)),
             "recog": (flops.dot(n, cfg["output_height"]
                                 * cfg["output_width"] * c, F)
                       + flops.dot(n, F, F)),
             "heads": shared["heads"], "decode": shared["decode"]}
    parts["total"] = sum(parts.values())
    return parts


def global_attn_least_ms(cfg, B):
    """The least time of one global block's attention core at batch B:
    its operations (`attn_core_flops`) at the bf16 peak, or q, k, v and
    the output in bf16 read or written once each, whichever is longer."""
    C, G = cfg["vit_embed_dim"], grid(cfg)
    heads = cfg["vit_num_heads"]
    ops = attn_core_flops(B, G * G, G, C // heads, heads)
    nbytes = 4 * B * G * G * C * 2
    return roofline.least_ms(nbytes, ops, "bf16_flops")[0]


# -- the program's spans ------------------------------------------------------

def per_call_ms(run, name):
    """The device ms a call of the program's spans named `name`: their
    mean times their count over the calls' `trunk` spans in the window;
    None where the program has no such span."""
    s, calls = window_summary(run, name), window_summary(run, "trunk")
    if s is None or calls is None:
        return None
    return s["device_ms"] * s["count"] / calls["count"]


def span_mean_ms(run, name):
    """The mean device ms of one span named `name`, or None."""
    s = window_summary(run, name)
    return None if s is None else s["device_ms"]
