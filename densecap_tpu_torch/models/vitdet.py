"""ViTDet's plain ViT and the stride-16 level of its simple feature
pyramid as DenseCap's trunk (Li, Mao, Girshick, He, "Exploring Plain
Vision Transformer Backbones for Object Detection", ECCV 2022,
arXiv:2203.16527; detectron2's `ViT` and `SimpleFeaturePyramid`).

  * input: the port's canvases (BGR less the VGG mean, zero past the
    frame) back to RGB pixels, normalized by ViTDet's mean and std, zero
    past each frame and zero-padded to a `vit_img_size` square;
  * a 16x16 stride-16 patch embedding with bias, plus the absolute
    position table of the pretraining grid interpolated bicubically to
    the patch grid (once, at build);
  * pre-norm blocks, `x + Attn(LN1(x))` then `x + MLP(LN2(x))` (LayerNorm
    eps 1e-6, exact GELU). Windowed blocks pad LN1's output with zeros to
    a multiple of the window and attend within each window with no mask,
    so padded tokens are keys through the qkv bias; global blocks
    (`vit_global_blocks`) attend over the whole grid. The logits are
    `(q * d^-0.5) k^T + rel_h + rel_w`, the decomposed relative positions
    of the unscaled q (`rel_h[i, kh] = q_i . Rh[qh(i) - kh + S - 1]`);
  * no final norm; the neck is a 1x1 conv to `vit_out_channels` with no
    bias and a channel LayerNorm, then a 3x3 conv with no bias and a
    channel LayerNorm. ViTDet builds four levels for an FPN head;
    DenseCap's localization is single-scale at stride 16, so only that
    level is built.

Precision as in the rest of the port: bf16 operands, f32 accumulation,
LayerNorm, softmax statistics and the residual stream in f32.

Attention never writes a (heads x N x N) tensor. On the card its core is
kernel K6 (`ops/vit_attention.py`, `ops/cuda/vit_attention.cu`): one
launch a block that reads q, k and v where the qkv product left them,
computes each query's relative terms from q and the tables, adds them to
each tile of logits in registers and writes the heads' output
token-major, so merging the heads is a view. On the CPU the relative
terms fold into one softmax product at scale 1, `q' = [q d^-0.5,
rel_h(q), rel_w(q)]` against `k' = [k, onehot(kh), onehot(kw)]`.

Spans (`utils.profiling`), under `trunk`: `vit.attn.window` and
`vit.attn.global` (the attention core, from q, k, v to the heads' output,
with the relative-position terms; counter `vit.attn.k6`, one a core that
ran as K6), `vit.mlp` (LN2 and the MLP) and `vit.neck`; counters
`vit.tokens` (query tokens through attention a call, window padding
included) and `vit.pad_tokens` (the padding's share).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import VGG_MEAN_BGR
from ..ops import vit_attention
from ..ops.linear import dot_f32, frozen, linear_cd, linear_f32
from ..utils.profiling import count, span

VIT_MEAN_RGB = (123.675, 116.28, 103.53)
VIT_STD_RGB = (58.395, 57.12, 57.375)
LN_EPS = 1e-6
VIT_TRAINING = ("training through a ViTDet trunk is not supported: the "
                "port runs it for inference only")


def vit_input(images, img_h, img_w, size):
    """(B, H, W, 3) f32 canvases, BGR less the VGG mean -> (B, size, size,
    3) f32 ViTDet input: RGB normalized by ViTDet's mean and std, zero
    past each (img_h, img_w) frame and zero-padded to size x size."""
    B, H, W, _ = images.shape
    if H > size or W > size:
        raise ValueError(f"the ViTDet trunk takes canvases of at most "
                         f"{size}x{size} (vit_img_size); got {H}x{W}")
    dev = images.device
    vgg = torch.tensor(VGG_MEAN_BGR, device=dev)
    mean = torch.tensor(VIT_MEAN_RGB, device=dev)
    std = torch.tensor(VIT_STD_RGB, device=dev)
    x = ((images + vgg).flip(-1) - mean) / std
    rows = torch.arange(H, device=dev)[None, :] < img_h[:, None]
    cols = torch.arange(W, device=dev)[None, :] < img_w[:, None]
    x = x * (rows[:, :, None] & cols[:, None, :])[..., None]
    return F.pad(x, (0, 0, 0, size - W, 0, size - H))


def attention_core(q, k, v, rel_h_table, rel_w_table, hw, cd, table=None):
    """Softmax attention with decomposed relative positions.

    q, k, v: (N, L, heads, d) in the compute dtype, token-major (the qkv
    product's columns as they are), over an (hh, ww) grid (L = hh ww,
    row-major); the tables: (2 hh - 1, d), (2 ww - 1, d). -> (N, heads,
    L, d) in the compute dtype, a view of the token-major result.

    On the card kernel K6 (`ops/vit_attention.py`), counted as
    `vit.attn.k6` on the open span: it reads q, k and v in place, adds
    each query's relative terms to each tile of logits inside the kernel
    and writes o token-major, so the caller's merge of the heads is a
    view; `table` is K6's stack of the two tables where the caller keeps
    it. On the CPU the relative terms fold into one softmax product
    (`vit_attention.fold`)."""
    o = vit_attention.attention(q, k, v, rel_h_table, rel_w_table, hw, table)
    if q.is_cuda:
        count("vit.attn.k6")
    return o.transpose(1, 2).to(cd)


def layer_norm(x, p):
    return F.layer_norm(x, (x.shape[-1],), p[0], p[1], LN_EPS)


class Attention(nn.Module):
    """qkv (with bias), the attention core, the output projection."""

    def __init__(self, qkv, proj, rel_h, rel_w, heads, cd):
        super().__init__()
        self.qkv_w, self.qkv_b = frozen(qkv[0]), frozen(qkv[1])
        self.proj_w, self.proj_b = frozen(proj[0]), frozen(proj[1])
        self.rel_h, self.rel_w = frozen(rel_h), frozen(rel_w)
        self.heads, self.cd = heads, cd
        self._table = self._table_key = None

    def table(self):
        """K6's stack of the two tables, made again only after either
        changes (its version or storage)."""
        key = tuple((t._version, t.data_ptr()) for t in (self.rel_h,
                                                         self.rel_w))
        if key != self._table_key:
            self._table = vit_attention.table(self.rel_h, self.rel_w)
            self._table_key = key
        return self._table

    def core(self, x, name):
        """x: (N, hh, ww, C) in the compute dtype -> the heads' output
        (N, hh, ww, C), in it too."""
        N, hh, ww, C = x.shape
        nh = self.heads
        qkv = linear_cd(x.reshape(-1, C), self.qkv_w, self.qkv_b, self.cd)
        q, k, v = qkv.view(N, hh * ww, 3, nh, C // nh).unbind(2)
        with span(name):
            o = attention_core(q, k, v, self.rel_h, self.rel_w, (hh, ww),
                               self.cd, self.table() if q.is_cuda else None)
        return o.transpose(1, 2).reshape(N, hh, ww, C)

    def project(self, o):
        shape = o.shape
        return linear_f32(o.reshape(-1, shape[-1]), self.proj_w, self.proj_b,
                          self.cd).reshape(shape)


class Block(nn.Module):
    def __init__(self, norm1, attn, norm2, fc1, fc2, window, cd):
        super().__init__()
        self.norm1 = nn.ParameterList([frozen(t) for t in norm1])
        self.norm2 = nn.ParameterList([frozen(t) for t in norm2])
        self.attn = attn
        self.fc1_w, self.fc1_b = frozen(fc1[0]), frozen(fc1[1])
        self.fc2_w, self.fc2_b = frozen(fc2[0]), frozen(fc2[1])
        self.window, self.cd = window, cd

    def forward(self, x):
        """x: (B, H, W, C) f32 residual stream."""
        B, H, W, C = x.shape
        h = layer_norm(x, self.norm1)
        ws = self.window
        if ws:
            Hp, Wp = H + (-H % ws), W + (-W % ws)
            pad = h.new_zeros((B, Hp, Wp, C), dtype=self.cd)
            pad[:, :H, :W] = h
            h = pad.view(B, Hp // ws, ws, Wp // ws, ws, C).transpose(
                2, 3).reshape(-1, ws, ws, C)
            o = self.attn.core(h, "vit.attn.window")
            o = o.reshape(B, Hp // ws, Wp // ws, ws, ws, C).transpose(
                2, 3).reshape(B, Hp, Wp, C)[:, :H, :W]
            count("vit.tokens", B * Hp * Wp)
            count("vit.pad_tokens", B * (Hp * Wp - H * W))
        else:
            o = self.attn.core(h.to(self.cd), "vit.attn.global")
            count("vit.tokens", B * H * W)
        # the projection is per token: the padding's rows are dropped first
        x = x + self.attn.project(o)
        with span("vit.mlp"):
            h = layer_norm(x, self.norm2).reshape(-1, C)
            h = F.gelu(linear_cd(h, self.fc1_w, self.fc1_b, self.cd))
            y = linear_f32(h, self.fc2_w, self.fc2_b, self.cd)
        return x + y.reshape(B, H, W, C)


class ViTDet(nn.Module):
    """The trunk: `forward(images, img_h, img_w)` takes the port's
    canvases and gives (B, vit_out_channels, G, G) f32 channels_last
    features, G = vit_img_size / vit_patch_size.

    patch: (w (p, p, 3, C) HWIO, b); pos: the pretraining grid's table
    (g, g, C); blocks: `Block`s; neck: (w1 (C, out), ln1, w2 (out, out,
    3, 3) OIHW, ln2)."""

    def __init__(self, cfg, patch, pos, blocks, neck):
        super().__init__()
        self.cfg, self.cd = cfg, cfg.compute_dtype
        self.patch_w, self.patch_b = frozen(patch[0]), frozen(patch[1])
        self.pos_table = frozen(pos)
        G = cfg.vit_img_size // cfg.vit_patch_size
        grid = F.interpolate(pos.float().permute(2, 0, 1)[None], size=(G, G),
                             mode="bicubic", align_corners=False)
        self.register_buffer("pos", grid[0].permute(1, 2, 0).contiguous(),
                             persistent=False)
        self.blocks = nn.ModuleList(blocks)
        self.neck_w1 = frozen(neck[0])
        self.neck_ln1 = nn.ParameterList([frozen(t) for t in neck[1]])
        self.neck_w2 = frozen(neck[2])
        self.neck_ln2 = nn.ParameterList([frozen(t) for t in neck[3]])

    def feat_extent(self, h, w):
        """Each (h, w) frame's extent on the patch grid, the patches wholly
        inside it: floor(h / p) x floor(w / p), int32."""
        p = self.cfg.vit_patch_size
        return (torch.div(h, p, rounding_mode="floor").to(torch.int32),
                torch.div(w, p, rounding_mode="floor").to(torch.int32))

    def embed(self, x):
        """(B, S, S, 3) f32 input -> (B, G, G, C) f32 tokens."""
        B, S, _, _ = x.shape
        p = self.cfg.vit_patch_size
        G = S // p
        patches = x.reshape(B, G, p, G, p, 3).transpose(2, 3).reshape(
            B * G * G, p * p * 3)
        w = self.patch_w.reshape(p * p * 3, -1)
        t = linear_f32(patches, w, self.patch_b, self.cd)
        return t.reshape(B, G, G, -1) + self.pos

    def neck(self, x):
        """(B, G, G, C) f32 -> (B, out, G, G) f32 channels_last."""
        B, G, _, C = x.shape
        cd = self.cd
        y = dot_f32(x.reshape(-1, C), self.neck_w1, cd).reshape(B, G, G, -1)
        y = layer_norm(y, self.neck_ln1).to(cd).permute(0, 3, 1, 2)
        y = F.conv2d(y, self.neck_w2.to(cd), padding=1).float()
        y = layer_norm(y.permute(0, 2, 3, 1), self.neck_ln2)
        return y.permute(0, 3, 1, 2)

    def forward(self, images, img_h, img_w):
        x = self.embed(vit_input(images, img_h, img_w,
                                 self.cfg.vit_img_size))
        for blk in self.blocks:
            x = blk(x)
        with span("vit.neck"):
            return self.neck(x)
