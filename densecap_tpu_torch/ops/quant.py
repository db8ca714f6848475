"""int8 W8A8 dynamic quantization of the inference FC layers (twin of
densecap_tpu/ops/quant.py).

Scheme, as in the JAX package (no calibration data):
  * weights: symmetric per-output-channel int8,
      scale_n = max(max_k |w[k, n]|, 1e-30) / 127, codes round half to even;
  * activations: symmetric per-row int8, computed at each call;
  * an int32 product, dequantized as acc * scale_m * scale_n + bias.

A quantized model is a params transform: `quantize_for_inference` turns
the chosen layers of a numpy tree from {"w", "b"} into {"w_q", "w_scale",
"b"}, and `utils.checkpoint.to_torch` builds a `QuantLinear` for each such
layer, which `models.vgg16.Recog` and `models.lstm.LanguageModel`
dispatch on. Inference only: rounding has no useful gradient.

The int32 product is `torch._int_mm` on every device (cuBLASLt on the
card; exact, so the CPU and the card give the same integers). On the card
it wants more than 16 rows and K and N multiples of 8. `QuantLinear`
stores its codes zero-padded to multiples of 8 once, and `qdot` pads the
activation codes with zero rows and columns per call; zero codes add
nothing to the product, and the padding is sliced off before the dequant.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

# int8 symmetric range: 127 (not 128) keeps -amax and +amax exact
QMAX = 127.0
# scale floor: an all-zero row or column quantizes to zeros, not NaN
EPS = 1e-30
# XLA rewrites the activation scale's division by the constant 127 into a
# multiply by its f32 reciprocal (the JAX model runs qdot under jit), so
# the port multiplies too; an operand's code is its value over the scale
# by a true division in both. The weight scales divide: JAX quantizes the
# weights outside jit.
INV_QMAX = float(np.float32(1.0) / np.float32(QMAX))
# torch._int_mm's shape rules on CUDA: rows > 16, K and N multiples of 8
_MIN_ROWS = 17
_ALIGN = 8


def quantize_linear(p):
    """{"w": (K, N), "b": (N,)} numpy -> {"w_q" (K, N) int8, "w_scale" (N,)
    f32, "b" (N,) f32}. Exact zeros stay exact zeros."""
    w = np.asarray(p["w"], np.float32)
    scale = (np.maximum(np.abs(w).max(axis=0), np.float32(EPS))
             / np.float32(QMAX)).astype(np.float32)
    w_q = np.clip(np.round(w / scale), -QMAX, QMAX).astype(np.int8)
    out = {"w_q": w_q, "w_scale": scale}
    if "b" in p:
        out["b"] = np.asarray(p["b"], np.float32)
    return out


def is_quantized(p) -> bool:
    return isinstance(p, dict) and "w_q" in p


def quantize_for_inference(params, quantize_lm_proj=False):
    """Quantize recog.fc6 and recog.fc7 of a numpy params tree, and lm.proj
    too with `quantize_lm_proj`. Returns a new tree that shares every other
    leaf with `params`, which is left as it is; already quantized layers
    are kept."""
    out = dict(params)
    if "recog" in out:
        recog = dict(out["recog"])
        for name in ("fc6", "fc7"):
            if name in recog and not is_quantized(recog[name]):
                recog[name] = quantize_linear(recog[name])
        out["recog"] = recog
    if quantize_lm_proj and "lm" in out:
        lm = dict(out["lm"])
        if "proj" in lm and not is_quantized(lm["proj"]):
            lm["proj"] = quantize_linear(lm["proj"])
        out["lm"] = lm
    return out


def _up(n, m=_ALIGN):
    return -(-n // m) * m


class QuantLinear(nn.Module):
    """A quantized layer on a device, built from a {"w_q", "w_scale", "b"}
    tree node. The codes are held as `w_qt`, (N, K) zero-padded to
    multiples of 8 and row-major, so `w_qt.t()` is the (K, N) operand in
    column-major order; `in_features` / `out_features` are the true K / N.
    """

    def __init__(self, q, device):
        super().__init__()
        w_q = np.asarray(q["w_q"])
        if w_q.dtype != np.int8 or w_q.ndim != 2:
            raise ValueError(f"w_q must be a 2-D int8 array, not {w_q.dtype} "
                             f"{w_q.shape}")
        K, N = w_q.shape
        w_qt = np.zeros((_up(N), _up(K)), np.int8)
        w_qt[:N, :K] = w_q.T
        self.in_features, self.out_features = K, N
        self.register_buffer("w_qt", torch.from_numpy(w_qt).to(device))
        self.register_buffer("w_scale", torch.from_numpy(
            np.array(q["w_scale"], np.float32)).to(device))
        self.register_buffer("b", None if "b" not in q else torch.from_numpy(
            np.array(q["b"], np.float32)).to(device))

    def forward(self, x, compute_dtype=None):
        """`qdot(x, self)`; the compute dtype of a full-precision layer is
        not used (`x` is quantized from f32)."""
        return qdot(x, self)


def quantize_rows(x2):
    """(M, K) float -> (int8 codes (M, K), f32 row scales (M,))."""
    x2 = x2.float()
    sx = torch.clamp_min(x2.abs().amax(dim=1), EPS) * INV_QMAX
    x_q = torch.clamp(torch.round(x2 / sx[:, None]), -QMAX, QMAX)
    return x_q.to(torch.int8), sx


def int_mm(x_q, layer):
    """(M, K) int8 codes @ the layer's codes -> (M, N) int32, exact.

    Pads the codes to `torch._int_mm`'s rules on CUDA (on every device, so
    the CPU tests run the same shapes) and slices the result back."""
    M, K = x_q.shape
    Np, Kp = layer.w_qt.shape
    if M < _MIN_ROWS or K != Kp:
        x_q = torch.nn.functional.pad(x_q, (0, Kp - K, 0,
                                            max(_MIN_ROWS - M, 0)))
    return torch._int_mm(x_q, layer.w_qt.t())[:M, :layer.out_features]


def dequantize(acc, sx, layer):
    """int32 (M, N) -> f32 acc * row scale * channel scale (+ bias). XLA
    fuses the channel scale and the bias add into one multiply-add, and
    so does `addcmul` (one rounding), which keeps the port's outputs those
    of the JAX model where the bias cancels the product."""
    t = acc.float() * sx[:, None]
    if layer.b is None:
        return t * layer.w_scale
    return torch.addcmul(layer.b, t, layer.w_scale)


def qdot(x, layer):
    """x: (..., K) float -> (..., N) f32: the int8 product of x's per-row
    codes and the layer's codes, dequantized (JAX `quant.qdot`)."""
    lead, K = x.shape[:-1], x.shape[-1]
    x_q, sx = quantize_rows(x.reshape(-1, K))
    out = dequantize(int_mm(x_q, layer), sx, layer)
    return out.reshape(*lead, layer.out_features)
