"""ViTDet-B as DenseCap's trunk in plain PyTorch, one image at a time: the
benchmark's reference for the ViTDet configurations. It imports nothing
of the program and no kernel; `Reference` supplies the RPN, the RoI
sampling, fc6 / fc7, the heads and the LSTM, and this class replaces only
`features`.

The trunk follows Li, Mao, Girshick, He, "Exploring Plain Vision
Transformer Backbones for Object Detection" (ECCV 2022, arXiv:2203.16527)
as detectron2's `ViT` and `SimpleFeaturePyramid` compute it
(`projects/ViTDet/configs/COCO/mask_rcnn_vitdet_b_100ep.py`):

  * the image in RGB, normalized by mean (123.675, 116.28, 103.53) and
    std (58.395, 57.12, 57.375), zero past the frame, zero-padded to the
    `vit_img_size` square;
  * a 16x16 stride-16 patch embedding with bias; the absolute position
    table of the pretraining grid (its cls slot already dropped)
    interpolated bicubically, `align_corners=False`, to the patch grid;
  * pre-norm blocks `x + Attn(LN1(x))`, `x + MLP(LN2(x))`, LayerNorm eps
    1e-6, exact GELU, no drop path at inference. Attention has
    `vit_num_heads` heads and a qkv layer with bias; its logits are
    `(q * d^-0.5) k^T + rel_h + rel_w` with `rel_h[i, kh] = q_i .
    Rh[qh(i) - kh + S - 1]` of the unscaled q (the width the same way),
    then softmax, `@ v`, the output projection with bias;
  * windowed blocks pad LN1's output with zeros to a multiple of the
    window, attend within each window with no mask (the padded tokens
    are keys through the qkv bias), merge, crop; the blocks of
    `vit_global_blocks` attend over the whole grid;
  * no final norm; the stride-16 level of the simple feature pyramid: a
    1x1 conv to `vit_out_channels` with no bias, a channel LayerNorm, a
    3x3 conv with no bias, a channel LayerNorm.

Departures from ViTDet: only the stride-16 level of the pyramid is built
(DenseCap's localization is single-scale at stride 16); the input comes
from DenseCap's canvas (BGR less the VGG mean, the frame's longer side
at the configuration's `image_size`) rather than ViTDet's own resize; the
relative-position tables are random, where ViTDet starts them at zero.

`precision` "fp8" rounds every operand of every convolution and matrix
product here too, the attention's two products and the relative terms'
included (`Reference`'s control).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .densecap_ref import VGG_MEAN_BGR, Reference

VIT_MEAN_RGB = (123.675, 116.28, 103.53)
VIT_STD_RGB = (58.395, 57.12, 57.375)
LN_EPS = 1e-6


def layer_norm(x, p):
    """LayerNorm over the last axis with the {"w", "b"} pair p."""
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + LN_EPS) * p["w"] + p["b"]


def rel_positions(table, size):
    """(2 size - 1, d) -> (size, size, d): [qh, kh] = table[qh - kh +
    size - 1]."""
    q = torch.arange(size, device=table.device)[:, None]
    k = torch.arange(size, device=table.device)[None, :]
    return table[q - k + size - 1]


class VitReference(Reference):
    """DenseCap with a ViTDet trunk, from a weight tree whose trunk lies
    under "vit" (`benchlib.vitdet.VitWeights.tree`)."""

    def vit_input(self, image, h, w):
        """(H, W, 3) normalized canvas -> (S, S, 3) ViTDet input."""
        dev = image.device
        rgb = (image + torch.tensor(VGG_MEAN_BGR, device=dev)).flip(-1)
        x = (rgb - torch.tensor(VIT_MEAN_RGB, device=dev)) / torch.tensor(
            VIT_STD_RGB, device=dev)
        x[int(h):] = 0
        x[:, int(w):] = 0
        S = self.cfg["vit_img_size"]
        out = x.new_zeros(S, S, 3)
        out[:x.shape[0], :x.shape[1]] = x
        return out

    def attention(self, x, p):
        """x: (n, hh, ww, C) windows or the grid -> (n, hh, ww, C)."""
        q_ = self.q
        n, hh, ww, C = x.shape
        heads = self.cfg["vit_num_heads"]
        d = C // heads
        qkv = self.mm(x.reshape(-1, C), p["qkv"]["w"], p["qkv"]["b"])
        q, k, v = qkv.reshape(n, hh * ww, 3, heads, d).permute(
            2, 0, 3, 1, 4)                                 # (n, heads, L, d)
        logits = q_(q * d ** -0.5) @ q_(k).transpose(-1, -2)
        r = q_(q).reshape(n, heads, hh, ww, d)
        Rh = q_(rel_positions(p["rel_pos_h"], hh))
        Rw = q_(rel_positions(p["rel_pos_w"], ww))
        rel_h = torch.einsum("bnhwc,hkc->bnhwk", r, Rh)
        rel_w = torch.einsum("bnhwc,wkc->bnhwk", r, Rw)
        logits = (logits.reshape(n, heads, hh, ww, hh, ww)
                  + rel_h[..., :, None] + rel_w[..., None, :]).reshape(
                      n, heads, hh * ww, hh * ww)
        o = q_(torch.softmax(logits, -1)) @ q_(v)
        o = o.transpose(1, 2).reshape(-1, C)
        return self.mm(o, p["proj"]["w"], p["proj"]["b"]).reshape(
            n, hh, ww, C)

    def block(self, x, p, window):
        G, _, C = x.shape
        h = layer_norm(x, p["norm1"])
        if window:
            Gp = G + (-G % window)
            h = F.pad(h, (0, 0, 0, Gp - G, 0, Gp - G))
            nw = Gp // window
            h = h.reshape(nw, window, nw, window, C).permute(
                0, 2, 1, 3, 4).reshape(-1, window, window, C)
            a = self.attention(h, p["attn"])
            a = a.reshape(nw, nw, window, window, C).permute(
                0, 2, 1, 3, 4).reshape(Gp, Gp, C)[:G, :G]
        else:
            a = self.attention(h[None], p["attn"])[0]
        x = x + a
        m = p["mlp"]
        h = F.gelu(self.mm(layer_norm(x, p["norm2"]).reshape(-1, C),
                           m["fc1"]["w"], m["fc1"]["b"]))
        return x + self.mm(h, m["fc2"]["w"], m["fc2"]["b"]).reshape(G, G, C)

    def features(self, image, h, w):
        """(H, W, 3) normalized canvas -> (vit_out_channels, G, G) ViTDet
        features, G = vit_img_size / vit_patch_size."""
        cfg, v = self.cfg, self.p["vit"]
        x = self.vit_input(image, h, w).permute(2, 0, 1)[None]
        pe = v["patch_embed"]
        ps = cfg["vit_patch_size"]
        x = self.gq(F.conv2d(self.q(x), self.q(pe["w"].permute(3, 2, 0, 1)),
                             stride=ps)) + pe["b"].view(1, -1, 1, 1)
        G = x.shape[-1]
        pos = F.interpolate(v["pos_embed"].permute(2, 0, 1)[None],
                            size=(G, G), mode="bicubic", align_corners=False)
        x = (x + pos)[0].permute(1, 2, 0)                  # (G, G, C)
        glob = set(cfg["vit_global_blocks"])
        for i in range(cfg["vit_depth"]):
            window = 0 if i in glob else cfg["vit_window_size"]
            x = self.block(x, v[f"block{i}"], window)
        n = v["neck"]
        zero1 = torch.zeros(n["conv1"]["w"].shape[-1], device=x.device)
        y = self.conv(x.permute(2, 0, 1)[None], n["conv1"]["w"], zero1, 0)
        y = layer_norm(y[0].permute(1, 2, 0), n["ln1"])
        zero2 = torch.zeros(n["conv2"]["w"].shape[-1], device=x.device)
        y = self.conv(y.permute(2, 0, 1)[None], n["conv2"]["w"], zero2, 1)
        return layer_norm(y[0].permute(1, 2, 0), n["ln2"]).permute(2, 0, 1)
