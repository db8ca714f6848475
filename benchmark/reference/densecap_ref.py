"""DenseCap in plain PyTorch, one image at a time: the benchmark's
reference. It imports nothing of the program and takes no tensor the
program made: weights come from `benchlib.weights` (the seed), images
from the benchmark's own inputs.

It follows the published model (Johnson et al., CVPR 2016) as the
reference implementation computes it: VGG-16 with every activation past
the image's extent zeroed after each conv and pool, the RPN's 3x3 conv
and two 1x1 heads over 12 anchors on a stride-16 grid, clip to the image,
softmax objectness, the 6000 best proposals, greedy NMS at 0.7 with the
Pascal +1 IoU, 7x7 bilinear RoI sampling through the affine grid of the
reference's BilinearRoiPooling, fc6 / fc7 with ReLU, the objectness and
box-regression heads, final NMS at 0.3, and an LSTM (torch-rnn's gate
order i, f, o, g) decoding greedily from the image code (START = END =
V + 1).

`precision` is "f32" (TF32 off: the caller sets the backends' flags, see
`f32_math`) or "fp8": every operand of every convolution and matrix
product, and in a backward the gradient each product receives, rounded
to float8 e4m3 with a per-tensor scale: the control that `correct` has
to reject.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

ANCHORS = ((45, 90), (90, 45), (64, 64), (90, 180), (180, 90), (128, 128),
           (181, 362), (362, 181), (256, 256), (362, 724), (724, 362),
           (512, 512))
FIELD = (8.5, 8.5, 16.0, 16.0)
VGG_MEAN_BGR = (103.939, 116.779, 123.68)
TRUNK = ["conv1_1", "conv1_2", "M", "conv2_1", "conv2_2", "M",
         "conv3_1", "conv3_2", "conv3_3", "M", "conv4_1", "conv4_2",
         "conv4_3", "M", "conv5_1", "conv5_2", "conv5_3"]
TRUNK1 = {"conv1_1", "conv1_2", "conv2_1", "conv2_2"}
FP8_MAX = 448.0


@contextlib.contextmanager
def f32_math():
    """True f32 products and convolutions (no TF32) inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fp8_round(x):
    """x rounded to float8 e4m3 under a per-tensor scale, back in f32."""
    s = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def fp8(x):
    """An operand of a product at fp8: rounded in the forward; the
    gradient passes as through the identity."""
    return x + (fp8_round(x.detach()) - x.detach())


class _Fp8Grad(torch.autograd.Function):
    """Identity forward; the gradient rounded to fp8 on its way back, as
    the program rounds a product's incoming gradient to its compute
    dtype."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g)


def normalize(canvas_bgr_u8, h, w):
    """(H, W, 3) uint8 BGR canvas -> f32 less the VGG mean, zero past the
    (h, w) frame."""
    x = canvas_bgr_u8.float() - torch.tensor(VGG_MEAN_BGR,
                                             device=canvas_bgr_u8.device)
    x[int(h):] = 0
    x[:, int(w):] = 0
    return x


def floor_halve(v, n):
    for _ in range(n):
        v = v // 2
    return v


def to_x1y1x2y2(b):
    xc, yc, w, h = b.unbind(-1)
    return torch.stack([xc - (w - 1) / 2.0, yc - (h - 1) / 2.0,
                        xc + (w - 1) / 2.0, yc + (h - 1) / 2.0], -1)


def iou_pascal(a, b):
    """(N, 4) x (M, 4) x1y1x2y2 -> (N, M), areas with +1."""
    area1 = (a[:, 2] - a[:, 0] + 1.0) * (a[:, 3] - a[:, 1] + 1.0)
    area2 = (b[:, 2] - b[:, 0] + 1.0) * (b[:, 3] - b[:, 1] + 1.0)
    xx1 = torch.maximum(a[:, None, 0], b[None, :, 0])
    yy1 = torch.maximum(a[:, None, 1], b[None, :, 1])
    xx2 = torch.minimum(a[:, None, 2], b[None, :, 2])
    yy2 = torch.minimum(a[:, None, 3], b[None, :, 3])
    iw = torch.clamp_min(xx2 - xx1 + 1.0, 0.0)
    ih = torch.clamp_min(yy2 - yy1 + 1.0, 0.0)
    inter = iw * ih
    return inter / (area1[:, None] + area2[None, :] - inter)


def box_transform(boxes, trans):
    xa, ya, wa, ha = boxes.unbind(-1)
    tx, ty, tw, th = trans.unbind(-1)
    tw, th = tw.clamp(-20.0, 20.0), th.clamp(-20.0, 20.0)
    return torch.stack([tx * wa + xa, ty * ha + ya, wa * torch.exp(tw),
                        ha * torch.exp(th)], -1)


def clip(boxes, w, h):
    """xcycwh boxes clipped to [1, w] x [1, h] -> (boxes, valid)."""
    bb = to_x1y1x2y2(boxes)
    x0 = torch.clamp(bb[:, 0], min=1.0).clamp(max=w - 1)
    y0 = torch.clamp(bb[:, 1], min=1.0).clamp(max=h - 1)
    x1 = torch.clamp(bb[:, 2], min=2.0).clamp(max=w)
    y1 = torch.clamp(bb[:, 3], min=2.0).clamp(max=h)
    valid = (x1 > x0) & (y1 > y0)
    out = torch.stack([(x0 + x1) / 2.0, (y0 + y1) / 2.0, x1 - x0, y1 - y0],
                      -1)
    return out, valid


def greedy_nms(boxes_x1y1x2y2, order, thresh, max_out):
    """Greedy NMS over the boxes taken in `order` (indices, best first):
    a box is dropped when its IoU with a kept box exceeds `thresh`.
    -> the kept indices, at most max_out."""
    b = boxes_x1y1x2y2[order]
    sup = (iou_pascal(b, b) > thresh).cpu().numpy()
    order = order.cpu().numpy()
    dead = np.zeros(len(order), bool)
    keep = []
    for i in range(len(order)):
        if dead[i]:
            continue
        keep.append(order[i])
        if len(keep) == max_out:
            break
        dead |= sup[i]
    return np.asarray(keep, np.int64)


class Reference:
    """The model from a weight tree (`benchlib.weights.Weights.tree`)."""

    def __init__(self, tree, cfg, precision="f32"):
        self.p = tree
        self.cfg = cfg
        low = precision == "fp8"
        self.q = fp8 if low else (lambda x: x)
        self.gq = _Fp8Grad.apply if low else (lambda x: x)
        self.V = cfg["vocab_size"]

    # -- layers ------------------------------------------------------------
    def conv(self, x, w_hwio, b, pad):
        w = w_hwio.permute(3, 2, 0, 1)
        y = self.gq(F.conv2d(self.q(x), self.q(w), padding=pad))
        return y + b.view(1, -1, 1, 1)

    def mm(self, x, w, b=None):
        y = self.gq(self.q(x) @ self.q(w))
        return y if b is None else y + b

    def trunk(self, x, h, w):
        """x (1, 3, H, W) -> VGG-16's features, zero past the extent after
        every conv and pool."""
        eh, ew = h, w
        for item in TRUNK:
            if item == "M":
                x = F.max_pool2d(x, 2, 2)
                eh, ew = eh // 2, ew // 2
            else:
                part = "trunk1" if item in TRUNK1 else "trunk2"
                x = torch.relu(self.conv(x, self.p[part][item]["w"],
                                         self.p[part][item]["b"], 1))
            x[:, :, int(eh):] = 0
            x[:, :, :, int(ew):] = 0
        return x

    def features(self, image, h, w):
        """(H, W, 3) normalized canvas -> (512, H/16, W/16) features."""
        return self.trunk(image.permute(2, 0, 1)[None], h, w)[0]

    def rpn(self, feats, h, w):
        """-> probs (A,), clipped boxes (A, 4), valid (A,), in the
        reference's k-major order."""
        r = self.p["rpn"]
        C, Hf, Wf = feats.shape
        k = len(ANCHORS)
        hid = torch.relu(self.conv(feats[None], r["conv"]["w"],
                                   r["conv"]["b"], 1))
        trans = self.conv(hid, r["box"]["w"], r["box"]["b"], 0)[0]
        scores = self.conv(hid, r["score"]["w"], r["score"]["b"], 0)[0]
        trans = trans.reshape(k, 4, Hf, Wf).permute(0, 2, 3, 1).reshape(-1, 4)
        scores = scores.reshape(k, 2, Hf, Wf).permute(0, 2, 3, 1).reshape(
            -1, 2)
        dev = feats.device
        x0, y0, sx, sy = FIELD
        xc = (x0 + sx * torch.arange(Wf, device=dev, dtype=torch.float32))
        yc = (y0 + sy * torch.arange(Hf, device=dev, dtype=torch.float32))
        sizes = torch.tensor(ANCHORS, dtype=torch.float32, device=dev)
        anchors = torch.stack([
            xc[None, None, :].expand(k, Hf, Wf),
            yc[None, :, None].expand(k, Hf, Wf),
            sizes[:, 0, None, None].expand(k, Hf, Wf),
            sizes[:, 1, None, None].expand(k, Hf, Wf)], -1).reshape(-1, 4)
        boxes, clip_ok = clip(box_transform(anchors, trans), float(w),
                              float(h))
        fh, fw = floor_halve(int(h), 4), floor_halve(int(w), 4)
        rows = torch.arange(Hf, device=dev)[:, None] < fh
        cols = torch.arange(Wf, device=dev)[None, :] < fw
        center = (rows & cols).reshape(-1).repeat(k)
        probs = torch.softmax(scores, -1)[:, 0]
        return probs, boxes, center & clip_ok

    def proposals(self, probs, boxes, valid, topk, thresh, max_out):
        """The RPN's NMS: the `topk` best valid proposals (stable), greedy
        NMS -> kept anchor indices."""
        masked = torch.where(valid, probs, -torch.inf)
        order = torch.sort(-masked, stable=True).indices
        order = order[:min(topk, int(valid.sum()))]
        return greedy_nms(to_x1y1x2y2(boxes), order, thresh, max_out)

    def roi_align(self, feats, boxes, h, w):
        """(C, Hf, Wf) features and (K, 4) xcycwh boxes -> (K, 7, 7, C),
        sampled bilinearly on the affine grid of each box, positions
        clamped to the image's feature extent."""
        C, Hf, Wf = feats.shape
        oh, ow = self.cfg["output_height"], self.cfg["output_width"]
        fh, fw = floor_halve(int(h), 4), floor_halve(int(w), 4)
        xc, yc, bw, bh = boxes.unbind(-1)
        dev = feats.device
        gy = torch.linspace(-1.0, 1.0, oh, device=dev)
        gx = torch.linspace(-1.0, 1.0, ow, device=dev)
        yn = (bh / h)[:, None] * gy + ((2.0 * yc - h - 1.0) / (h - 1.0))[:,
                                                                        None]
        xn = (bw / w)[:, None] * gx + ((2.0 * xc - w - 1.0) / (w - 1.0))[:,
                                                                        None]
        yf = ((yn + 1.0) * (fh - 1.0) / 2.0).clamp(0.0, fh - 1.0)
        xf = ((xn + 1.0) * (fw - 1.0) / 2.0).clamp(0.0, fw - 1.0)
        sh, sw = min(max(fh, 1), Hf), min(max(fw, 1), Wf)

        def taps(p, size):
            p0 = torch.floor(p)
            i0 = p0.long().clamp(0, size - 1)
            i1 = (i0 + 1).clamp(0, size - 1)
            return i0, i1, p - p0

        y0, y1, fy = taps(yf, sh)
        x0, x1, fx = taps(xf, sw)
        fm = feats.permute(1, 2, 0)                        # (Hf, Wf, C)

        def at(yi, xi):
            return fm[yi[:, :, None], xi[:, None, :]]      # (K, oh, ow, C)

        fy = fy[:, :, None, None]
        fx = fx[:, None, :, None]
        top = at(y0, x0) * (1 - fx) + at(y0, x1) * fx
        bot = at(y1, x0) * (1 - fx) + at(y1, x1) * fx
        return top * (1 - fy) + bot * fy

    def codes(self, roi_feats, drop=None):
        """(K, 7, 7, C) -> (K, fc_dim); `drop` (mask6, mask7, keep) applies
        inverted dropout after each ReLU."""
        r = self.p["recog"]
        x = roi_feats.reshape(roi_feats.shape[0], -1)
        for i, name in enumerate(("fc6", "fc7")):
            x = torch.relu(self.mm(x, r[name]["w"], r[name]["b"]))
            if drop is not None:
                x = torch.where(drop[i], x / drop[2], 0.0)
        return x

    def heads(self, codes):
        """-> objectness logits (K,), box transforms (K, 4)."""
        o, b = self.p["objectness"], self.p["box_reg"]
        return (self.mm(codes, o["w"], o["b"])[:, 0],
                self.mm(codes, b["w"], b["b"]))

    # -- language model ----------------------------------------------------
    def lstm_step(self, h, c, x):
        L = self.p["lm"]["lstm"]
        gates = self.mm(x, L["Wx"]) + self.mm(h, L["Wh"]) + L["b"]
        i, f, o, g = gates.chunk(4, -1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c

    def embed(self, tok):
        E = self.p["lm"]["embed"]
        return E[(tok - 1).clamp(0, E.shape[0] - 1)]

    def encode(self, codes):
        e = self.p["lm"]["img_enc"]
        return torch.relu(self.mm(codes, e["w"], e["b"]))

    def logits(self, h):
        p = self.p["lm"]["proj"]
        return self.mm(h, p["w"], p["b"])

    def teacher_logits(self, codes, tokens):
        """The logits (N, T, V + 1) at each step of decoding `tokens` (N, T)
        from the image codes: step t's input is the token of step t - 1
        (START first)."""
        N, T = tokens.shape
        z = torch.zeros(N, self.p["lm"]["lstm"]["Wh"].shape[0],
                        device=codes.device)
        h, c = self.lstm_step(z, z, self.encode(codes))
        prev = torch.full((N,), self.V + 1, dtype=torch.long,
                          device=codes.device)
        out = []
        for t in range(T):
            h, c = self.lstm_step(h, c, self.embed(prev))
            out.append(self.logits(h))
            prev = tokens[:, t].long()
        return torch.stack(out, 1)

    def greedy(self, codes, T):
        """Greedy decode -> tokens (N, T); a row's tokens after its first
        END are END."""
        N = codes.shape[0]
        END = self.V + 1
        z = torch.zeros(N, self.p["lm"]["lstm"]["Wh"].shape[0],
                        device=codes.device)
        h, c = self.lstm_step(z, z, self.encode(codes))
        tok = torch.full((N,), END, dtype=torch.long, device=codes.device)
        done = torch.zeros(N, dtype=torch.bool, device=codes.device)
        seq = []
        for _ in range(T):
            h, c = self.lstm_step(h, c, self.embed(tok))
            tok = torch.where(done, END, self.logits(h).argmax(-1) + 1)
            seq.append(tok)
            done = done | (tok == END)
        return torch.stack(seq, 1)

    # -- the whole forward, in the program's place -------------------------
    def forward_test(self, image, h, w):
        """One image through the whole test path -> dict of rois (K, 4),
        roi_valid (K,), roi_scores (K,), idx (K,), valid (K,), boxes
        (K, 4), scores (K,), tokens (K, T): the program's outputs for one
        image."""
        cfg = self.cfg
        K = cfg["test_max_proposals"]
        feats = self.features(image, h, w)
        probs, boxes, valid = self.rpn(feats, h, w)
        keep = self.proposals(probs, boxes, valid, cfg["test_pre_nms_topk"],
                              cfg["test_rpn_nms_thresh"], K)
        n = len(keep)
        dev = image.device
        keep_t = torch.as_tensor(keep, device=dev)
        rois = torch.zeros(K, 4, device=dev)
        rois[:n] = boxes[keep_t]
        roi_scores = torch.zeros(K, device=dev)
        roi_scores[:n] = probs[keep_t]
        roi_valid = torch.arange(K, device=dev) < n
        codes = self.codes(self.roi_align(feats, rois, h, w))
        scores, trans = self.heads(codes)
        final = box_transform(rois, trans)
        masked = torch.where(roi_valid, scores, -1e38)
        order = torch.sort(-masked, stable=True).indices[:n]
        fk = greedy_nms(to_x1y1x2y2(final), order,
                        cfg["test_final_nms_thresh"], K)
        idx = torch.zeros(K, dtype=torch.long, device=dev)
        idx[:len(fk)] = torch.as_tensor(fk, device=dev)
        out_valid = torch.arange(K, device=dev) < len(fk)
        tokens = self.greedy(codes[idx], cfg["seq_length"])
        return {"rois": rois, "roi_valid": roi_valid,
                "roi_scores": roi_scores, "idx": idx,
                "valid": out_valid, "boxes": final[idx],
                "scores": scores[idx], "tokens": tokens}
