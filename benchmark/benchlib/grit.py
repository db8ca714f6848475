"""What the GRiT cells share: the seed's weights with GRiT's text decoder
on a ViTDet trunk, the hand FLOP count of the forward, the least times
of the decoder's prefill and of its steps' attention, and the program's
decoder spans read per call.

Weights. `vitdet.VitWeights`'s tree with the LSTM's leaves under "lm"
replaced by the text decoder's, drawn the same way. Init laws (the
configuration's `assumed`, BERT's): N(0, 0.02) for every linear layer,
the word and position tables and the vocab head; zero biases; unit
LayerNorm weights.

FLOPs. Two a multiply-add, as `flops.py`. The prefill: the object
projection, and in every layer but the last the qkv product over the R x
P prefix tokens (P = the pool's cells), the attention's two products (4
P^2 d a head and row), the output projection and the FFN; the last
layer's object outputs feed nothing, so there only its k and v products
are needed. A step at text position t: in each layer the qkv, output
and FFN products of R tokens and the attention's two products over P + t
+ 1 keys (4 (P + t + 1) d a head and row), then the vocab head. The
trunk, RPN, fc6 / fc7 and the heads as `vitdet.inference_flops`.

Least times. The prefill's: its operations at the bf16 peak. The steps'
attention: bytes, each step's keys and values of every layer read once
in bf16 (the columns up to the step), its q read and its output written.
"""

from __future__ import annotations

import numpy as np
import torch

from . import flops, roofline, vitdet
from .program_spans import window_summary
from .weights import _insert

STD = 0.02


def final_rows(cfg):
    """Rows an image that the final NMS keeps and the decoder decodes."""
    K = cfg["test_max_proposals"]
    return min(K, cfg.get("test_final_max_boxes") or K)


def prefix_len(cfg):
    return cfg["textdec_obj_pool"] ** 2


def textdec_leaves(cfg):
    """[(path, shape, law, scale)] of the text decoder, under "lm/"."""
    C, Fd, V = cfg["textdec_dim"], cfg["textdec_ffn"], cfg["vocab_size"]
    n = ("normal", STD)
    z, one = ("zeros", 0.0), ("ones", 1.0)
    spec = [("obj_proj/w", (cfg["vit_out_channels"], C), *n),
            ("obj_proj/b", (C,), *z),
            ("obj_ln/w", (C,), *one), ("obj_ln/b", (C,), *z),
            ("words", (V + 1, C), *n),
            ("pos", (cfg["textdec_positions"], C), *n),
            ("emb_ln/w", (C,), *one), ("emb_ln/b", (C,), *z)]
    for i in range(cfg["textdec_layers"]):
        b = f"layer{i}/"
        spec += [(b + "qkv/w", (C, 3 * C), *n), (b + "qkv/b", (3 * C,), *z),
                 (b + "out/w", (C, C), *n), (b + "out/b", (C,), *z),
                 (b + "ln1/w", (C,), *one), (b + "ln1/b", (C,), *z),
                 (b + "ffn1/w", (C, Fd), *n), (b + "ffn1/b", (Fd,), *z),
                 (b + "ffn2/w", (Fd, C), *n), (b + "ffn2/b", (C,), *z),
                 (b + "ln2/w", (C,), *one), (b + "ln2/b", (C,), *z)]
    spec += [("proj/w", (C, V + 1), *n), ("proj/b", (V + 1,), *z)]
    return [("lm/" + path, shape, law, scale)
            for path, shape, law, scale in spec]


def grit_leaves(cfg):
    return (vitdet.vit_leaves(cfg)
            + [leaf for leaf in vitdet.head_leaves(cfg)
               if not leaf[0].startswith("lm/")]
            + textdec_leaves(cfg))


class GritWeights(vitdet.VitWeights):
    """`vitdet.VitWeights` with the text decoder in the LSTM's place."""

    def __init__(self, cfg, seed, device):
        self.layout = grit_leaves(cfg)
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


def weights_numpy(cfg, seed, device):
    """As `program.weights_numpy`, for a GRiT configuration."""
    w = GritWeights(cfg, seed, device)
    tree = w.tree_numpy()
    del w
    return tree


# -- FLOPs ----------------------------------------------------------------

def _layer_dots(cfg, tokens):
    """The output projection and the FFN of `tokens` tokens."""
    C, Fd = cfg["textdec_dim"], cfg["textdec_ffn"]
    return (flops.dot(tokens, C, C) + flops.dot(tokens, C, Fd)
            + flops.dot(tokens, Fd, C))


def prefix_flops(cfg, rows):
    """The prefill of `rows` regions (see the module's doc)."""
    C, L = cfg["textdec_dim"], cfg["textdec_layers"]
    P = prefix_len(cfg)
    T = rows * P
    attn = 4 * rows * P * P * C  # heads x d = C
    return (flops.dot(T, cfg["vit_out_channels"], C)
            + (L - 1) * (flops.dot(T, C, 3 * C) + attn + _layer_dots(cfg, T))
            + flops.dot(T, C, 2 * C))


def step_flops(cfg, rows, t):
    """The step at text position t over `rows` regions, its head
    included."""
    C, L = cfg["textdec_dim"], cfg["textdec_layers"]
    keys = prefix_len(cfg) + t + 1
    layer = (flops.dot(rows, C, 3 * C) + 4 * rows * keys * C
             + _layer_dots(cfg, rows))
    return L * layer + flops.dot(rows, C, cfg["vocab_size"] + 1)


def inference_flops(cfg, B, steps):
    """`forward_test_batch` with GRiT's text decoder at batch B whose
    decode ran `steps` steps: `vitdet.inference_flops`'s trunk, RPN,
    recog and heads, the prefill ("prefix") and the steps ("decode")."""
    parts = vitdet.inference_flops(cfg, B, 0)
    del parts["decode"], parts["total"]
    rows = B * final_rows(cfg)
    parts["prefix"] = prefix_flops(cfg, rows)
    parts["decode"] = sum(step_flops(cfg, rows, t) for t in range(steps))
    parts["total"] = sum(parts.values())
    return parts


def prefix_least_ms(cfg, B):
    """The prefill's least time at batch B: its operations at the bf16
    peak."""
    return prefix_flops(cfg, B * final_rows(cfg)) / roofline.PEAKS[
        "bf16_flops"] * 1e3


def decode_attn_bytes(cfg, B, steps):
    """Bytes the attention of `steps` steps needs at batch B: every
    layer's keys and values up to each step's column, and each step's q
    and output, in bf16."""
    C, L = cfg["textdec_dim"], cfg["textdec_layers"]
    rows, P = B * final_rows(cfg), prefix_len(cfg)
    return sum(L * rows * C * 2 * (2 * (P + t + 1) + 2)
               for t in range(steps))


def decode_attn_least_ms(cfg, B, steps):
    return decode_attn_bytes(cfg, B, steps) / roofline.PEAKS[
        "hbm_bytes_per_s"] * 1e3


# -- the program's spans ------------------------------------------------------

def per_call_ms(run, name):
    """The device ms a call of the program's spans named `name`: their
    mean times their count over the calls' `textdec.decode` spans in the
    window; None where the program has no such span."""
    s, calls = window_summary(run, name), window_summary(run,
                                                         "textdec.decode")
    if s is None or calls is None:
        return None
    return s["device_ms"] * s["count"] / calls["count"]


def steps_per_call(run):
    """The decode steps a call (the `textdec.steps` counter of the
    `textdec.decode` span), or None."""
    s = window_summary(run, "textdec.decode")
    if s is None or "textdec.steps" not in s["counters"]:
        return None
    return s["counters"]["textdec.steps"]["n"]
