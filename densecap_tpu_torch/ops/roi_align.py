"""Bilinear RoI align, batched over images, differentiable in the
features and the boxes.

Twin of `densecap_tpu/ops/roi_align.py:roi_align` (gather formulation):

  * `roi_align_plain`: PyTorch gathers under autograd; the CPU path and
    the reference the CUDA kernels are held against.
  * `roi_align_cuda`: kernel K2 forward and K2b backward
    (`cuda/roi_align.cu`) as one autograd Function over the sample
    positions. `_sample_coords` stays plain torch outside it, so autograd
    carries the position gradient through the clamp into the boxes.
  * `roi_align`: a CPU tensor takes the plain version, a CUDA tensor the
    kernels.

Inputs: `feats` (B, Hf, Wf, C) channels-last f32 (a padded canvas);
`boxes` (B, K, 4) xcycwh in 1-indexed image coordinates; `img_h`/`img_w`
(B,) the true image size of each canvas; `feat_h`/`feat_w` (B,) int the
cropped feature extent of each image. Output (B, K, out_h, out_w, C) f32.
"""

from __future__ import annotations

import torch

from .cuda import build


def _sample_coords(boxes, img_h, img_w, feat_h, feat_w, out_h, out_w):
    """Per-box sampling positions on the feature map (0-indexed, clamped
    to the cropped extent): yf (B, K, out_h), xf (B, K, out_w)."""
    xc, yc, w, h = boxes.float().unbind(-1)
    img_h = img_h.float()[:, None]
    img_w = img_w.float()[:, None]
    th13 = (2.0 * yc - img_h - 1.0) / (img_h - 1.0)
    th23 = (2.0 * xc - img_w - 1.0) / (img_w - 1.0)
    th11 = h / img_h
    th22 = w / img_w
    dev = boxes.device
    gy = torch.linspace(-1.0, 1.0, out_h, dtype=torch.float32, device=dev)
    gx = torch.linspace(-1.0, 1.0, out_w, dtype=torch.float32, device=dev)
    y_norm = th11[..., None] * gy + th13[..., None]
    x_norm = th22[..., None] * gx + th23[..., None]
    fh = feat_h.float()[:, None, None]
    fw = feat_w.float()[:, None, None]
    yf = (y_norm + 1.0) * (fh - 1.0) / 2.0
    xf = (x_norm + 1.0) * (fw - 1.0) / 2.0
    # maximum / minimum against tensors, not clamp_min: at a tie they
    # split the gradient 0.5 / 0.5, as jnp.clip does
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    yf = torch.minimum(torch.maximum(yf, zero), fh - 1.0)
    xf = torch.minimum(torch.maximum(xf, zero), fw - 1.0)
    return yf, xf


def roi_align_plain(feats, boxes, img_h, img_w, feat_h, feat_w,
                    out_h=7, out_w=7):
    """Plain PyTorch RoI align (see module docstring).

    The tap indices clamp each extent into [1, Hf] x [1, Wf] as the
    kernels do (`roi_align.cu` `extent()`), so an empty extent (a frame
    under 16 px) reads cell 0, where the JAX gather's clip to -1 wraps to
    the map's last cell. The trunk zeroes the map outside the extent, so
    both read 0 there and the trunk's mask drops the scatter into either
    cell."""
    B, Hf, Wf, C = feats.shape
    K = boxes.shape[1]
    yf, xf = _sample_coords(boxes, img_h, img_w, feat_h, feat_w,
                            out_h, out_w)

    def taps(pos, size):
        p0 = torch.floor(pos)
        i0 = torch.minimum(p0.long().clamp_min(0), size - 1)
        i1 = torch.minimum((i0 + 1).clamp_min(0), size - 1)
        return i0, i1, pos - p0

    sh = feat_h.long().clamp(1, Hf)[:, None, None]
    sw = feat_w.long().clamp(1, Wf)[:, None, None]
    y0, y1, fy = taps(yf, sh)                    # (B, K, out_h)
    x0, x1, fx = taps(xf, sw)                    # (B, K, out_w)
    flat = feats.reshape(B * Hf * Wf, C)
    base = (torch.arange(B, device=feats.device) * Hf)[:, None, None, None]

    def gather(yi, xi):
        rows = (base + yi[..., :, None]) * Wf + xi[..., None, :]
        return flat[rows.reshape(-1)].reshape(B, K, out_h, out_w, C)

    fy = fy[..., :, None, None]
    fx = fx[..., None, :, None]
    r0 = gather(y0, x0) * (1.0 - fy) + gather(y1, x0) * fy
    r1 = gather(y0, x1) * (1.0 - fy) + gather(y1, x1) * fy
    return r0 * (1.0 - fx) + r1 * fx


class _RoiAlignFn(torch.autograd.Function):
    """K2 forward, K2b backward, over precomputed sample positions."""

    @staticmethod
    def forward(ctx, feats, yf, xf, img_idx, fh, fw):
        C = feats.shape[3]
        R, out_h = yf.shape
        out_w = xf.shape[1]
        out = torch.empty((R, out_h, out_w, C), dtype=torch.float32,
                          device=feats.device)
        launch_fwd(feats, yf, xf, img_idx, fh, fw, out)
        build.count_launch("roi_align")
        ctx.save_for_backward(feats, yf, xf, img_idx, fh, fw)
        return out

    @staticmethod
    def backward(ctx, g):
        feats, yf, xf, img_idx, fh, fw = ctx.saved_tensors
        # d feats only while the trunk trains: a frozen trunk runs the
        # positions-only instance of K2b
        d_feats = (torch.zeros_like(feats) if ctx.needs_input_grad[0]
                   else None)
        d_yf = torch.empty_like(yf)
        d_xf_rows = yf.new_empty((*yf.shape, xf.shape[1]))
        launch_bwd(g.contiguous(), feats, yf, xf, img_idx, fh, fw, d_yf,
                   d_xf_rows, d_feats)
        build.count_launch("roi_align_bwd" if d_feats is None
                           else "roi_align_bwd_feats")
        # each row's share of d xf, summed over the rows in a fixed order
        return d_feats, d_yf, d_xf_rows.sum(1), None, None, None


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def launch_fwd(feats, yf, xf, img_idx, fh, fw, out):
    """One launch of K2 on prepared tensors (`prepare_cuda`) into `out`
    (R, out_h, out_w, C); not counted."""
    _, Hf, Wf, C = feats.shape
    R, out_h = yf.shape
    rc = build.load().dc_roi_align_fwd(
        feats.data_ptr(), yf.data_ptr(), xf.data_ptr(), img_idx.data_ptr(),
        fh.data_ptr(), fw.data_ptr(), R, Hf, Wf, C, out_h, xf.shape[1],
        out.data_ptr(), _stream(feats))
    build.check(rc, "roi_align")


def launch_bwd(g, feats, yf, xf, img_idx, fh, fw, d_yf, d_xf_rows,
               d_feats=None):
    """One launch of K2b on the forward's prepared tensors and the
    upstream gradient `g` (R, out_h, out_w, C): writes `d_yf` (R, out_h)
    and `d_xf_rows` (R, out_h, out_w), each grid row's share of d xf, and
    when `d_feats` is given adds the feature gradient into it; not
    counted."""
    _, Hf, Wf, C = feats.shape
    R, out_h = yf.shape
    rc = build.load().dc_roi_align_bwd(
        g.data_ptr(), feats.data_ptr(), yf.data_ptr(), xf.data_ptr(),
        img_idx.data_ptr(), fh.data_ptr(), fw.data_ptr(), R, Hf, Wf, C,
        out_h, xf.shape[1], d_yf.data_ptr(), d_xf_rows.data_ptr(),
        None if d_feats is None else d_feats.data_ptr(), _stream(feats))
    build.check(rc, "roi_align_bwd")


# K2b keeps a partial per output column in shared memory (roi_align.cu
# kMaxOut)
MAX_OUT_W = 16


def prepare_cuda(feats, boxes, img_h, img_w, feat_h, feat_w, out_h=7,
                 out_w=7):
    """The wrapper's work before K2: checks, the sample positions and each
    box's image and extent. -> (yf (R, out_h), xf (R, out_w), img_idx,
    fh, fw), R = B * K."""
    if not (feats.is_cuda and boxes.is_cuda):
        raise ValueError("roi_align_cuda takes CUDA tensors")
    if feats.dtype != torch.float32 or feats.dim() != 4:
        raise ValueError("roi_align_cuda: feats must be (B, Hf, Wf, C) f32")
    if not feats.is_contiguous():
        raise ValueError("roi_align_cuda: feats must be contiguous NHWC")
    if out_w > MAX_OUT_W:
        raise ValueError(f"roi_align_cuda: out_w must be <= {MAX_OUT_W}")
    B, Hf, Wf, C = feats.shape
    K = boxes.shape[1]
    if boxes.shape != (B, K, 4):
        raise ValueError(f"boxes must be (B, K, 4), got {tuple(boxes.shape)}")
    dev = feats.device
    yf, xf = _sample_coords(boxes, img_h, img_w, feat_h, feat_w,
                            out_h, out_w)
    img_idx = torch.arange(B, dtype=torch.int32, device=dev
                           ).repeat_interleave(K)
    fh = feat_h.to(torch.int32).repeat_interleave(K)
    fw = feat_w.to(torch.int32).repeat_interleave(K)
    return (yf.reshape(B * K, out_h).contiguous(),
            xf.reshape(B * K, out_w).contiguous(), img_idx, fh, fw)


def roi_align_cuda(feats, boxes, img_h, img_w, feat_h, feat_w,
                   out_h=7, out_w=7):
    """Kernels K2 / K2b on CUDA tensors; same contract as
    `roi_align_plain`, gradients included. No host read."""
    B, K = boxes.shape[:2]
    yf, xf, img_idx, fh, fw = prepare_cuda(feats, boxes, img_h, img_w,
                                           feat_h, feat_w, out_h, out_w)
    out = _RoiAlignFn.apply(feats, yf, xf, img_idx, fh, fw)
    return out.reshape(B, K, out_h, out_w, feats.shape[3])


def roi_align(feats, boxes, img_h, img_w, feat_h, feat_w, out_h=7, out_w=7):
    """RoI align over a batch: the kernel on CUDA, the plain version on CPU."""
    if feats.is_cuda:
        return roi_align_cuda(feats, boxes, img_h, img_w, feat_h, feat_w,
                              out_h, out_w)
    if feats.device.type != "cpu":
        raise ValueError(f"roi_align: no implementation for {feats.device}")
    return roi_align_plain(feats, boxes, img_h, img_w, feat_h, feat_w,
                           out_h, out_w)
