"""The table of peaks and the operations and bytes of the kernels whose
roofline share the benchmark reports.

Bytes count each input byte read once and each output byte written once,
whatever the kernel reads again; operations count what the work needs.
The least time is the larger of bytes over the memory bandwidth and
operations over the peak rate of their type.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "bf16_flops": 989e12,
    "tf32_flops": 495e12,
    "f32_flops": 67e12,
    "fp8_flops": 1979e12,
    "int8_ops": 1979e12,
}

F32 = 4
I32 = 4


def least_ms(nbytes, ops, ops_peak):
    """(ms, "bytes" or "operations")."""
    t_b = nbytes / PEAKS["hbm_bytes_per_s"] * 1e3
    t_o = ops / PEAKS[ops_peak] * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def roi_align_fwd(B, Hf, Wf, C, rois, out_h=7, out_w=7):
    """K2 (`roi_align_fwd_kernel`): reads the (B, Hf, Wf, C) f32 map, each
    RoI's sample positions (out_h + out_w f32), image index and extent
    (3 int32); writes the (rois, out_h, out_w, C) f32 output. Three lerps
    of 4 operations per output element, in f32."""
    nbytes = (B * Hf * Wf * C * F32 + rois * (out_h + out_w) * F32
              + rois * 3 * I32 + rois * out_h * out_w * C * F32)
    ops = rois * out_h * out_w * C * 12
    return least_ms(nbytes, ops, "f32_flops")


def roi_align_bwd(B, Hf, Wf, C, rois, d_feats, out_h=7, out_w=7):
    """K2b (`roi_align_bwd_kernel`): reads the upstream gradient (rois,
    out_h, out_w, C) f32, the map, the positions, index and extent;
    writes d yf (rois, out_h), each grid row's share of d xf (rois, out_h,
    out_w), and with `d_feats` the map's gradient (written once). ~16 f32
    operations per element of the gradient for the positions, ~24 with
    the feature scatter."""
    g = rois * out_h * out_w * C * F32
    fmap = B * Hf * Wf * C * F32
    nbytes = (g + fmap + rois * (out_h + out_w) * F32 + rois * 3 * I32
              + rois * out_h * F32 + rois * out_h * out_w * F32
              + (fmap if d_feats else 0))
    ops = rois * out_h * out_w * C * (24 if d_feats else 16)
    return least_ms(nbytes, ops, "f32_flops")
