"""The compute-dtype product of every full-precision layer of the port.

`dot_f32` is `x @ w` with operands in the compute dtype and an f32
result, the twin of the JAX package's `jnp.dot(x.astype(cd),
w.astype(cd), preferred_element_type=float32)`; `_DotF32` is its card
form with a hand-written backward; `linear_cd` and `linear_f32` add a
bias to it (in cuBLAS's epilogue on the card) for the inference layers
of the ViTDet trunk and of the text decoder; `Linear` is a layer over
`dot_f32`, the full-precision counterpart of `ops.quant.QuantLinear`;
`frozen` makes a tensor a parameter without a gradient.
"""

from __future__ import annotations

import torch
from torch import nn

from ..parallel.tensor_parallel import copy_to_model, gather_from_model


def frozen(t):
    return nn.Parameter(t, requires_grad=False)


class _DotF32(torch.autograd.Function):
    """bf16 GEMMs with f32 outputs, forward and backward, on the card."""

    @staticmethod
    def forward(ctx, x, w, cd):
        xc, wc = x.to(cd), w.to(cd)
        ctx.save_for_backward(xc, wc)
        return torch.mm(xc, wc, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        xc, wc = ctx.saved_tensors
        gc = g.to(xc.dtype)
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.mm(gc, wc.t(), out_dtype=torch.float32)
        if ctx.needs_input_grad[1]:
            gw = torch.mm(xc.t(), gc, out_dtype=torch.float32)
        return gx, gw, None


def dot_f32(x, w, cd):
    """2-D `x @ w` with operands in the compute dtype `cd` and an f32 result.

    The twin of `jnp.dot(x.astype(cd), w.astype(cd),
    preferred_element_type=float32)`: bf16 operands, f32 accumulation,
    f32 output. On the card a bf16 product is `_DotF32`, whose backward
    is bf16 GEMMs with f32 outputs as well, so an f32 master weight gets
    an f32 gradient. On the CPU the bf16 operands are widened to f32,
    which is exact, so the products and the f32 sum are the same.
    """
    if cd == torch.float32:
        return x.float() @ w.float()
    if x.is_cuda:
        return _DotF32.apply(x, w, cd)
    return x.to(cd).float() @ w.to(cd).float()


def linear_cd(x, w, b, cd):
    """`x @ w + b` accumulated in f32 and rounded once to the compute
    dtype `cd` (a bf16 product with its bias in cuBLAS's epilogue on the
    card; widened operands on the CPU, which is exact)."""
    if x.is_cuda and cd != torch.float32:
        return torch.addmm(b.to(cd), x.to(cd), w.to(cd))
    return (dot_f32(x, w, cd) + b).to(cd)


def linear_f32(x, w, b, cd):
    """`dot_f32(x, w, cd) + b`: on the card one bf16 product with an f32
    result and the f32 bias in cuBLAS's epilogue."""
    if x.is_cuda and cd != torch.float32:
        return torch.addmm(b, x.to(cd), w.to(cd), out_dtype=torch.float32)
    return dot_f32(x, w, cd) + b


class Linear(nn.Module):
    """A full-precision layer: weight (in, out) and f32 bias, `x @ w + b`
    by `dot_f32`. Its quantized counterpart is `ops.quant.QuantLinear`;
    both are called as `layer(x, compute_dtype)`.

    With a `shard` (`parallel.tensor_parallel.ColumnShard`) the layer is
    column-parallel: `w` and `b` hold this rank's columns, the input is
    copied into the model group and the output gathered to full width,
    so callers see the unsharded layer. The input enters the group as
    f32 (exact for a bf16 input): on the card `dot_f32` then returns each
    rank's part of its gradient in f32, the group sums them in f32, and
    the sum is rounded to the input's dtype once, as the unsharded
    layer's one product is. (On the CPU a bf16 product rounds each part
    first.)"""

    def __init__(self, w, b, shard=None):
        super().__init__()
        self.w, self.b = frozen(w), frozen(b)
        self.shard = shard

    def forward(self, x, compute_dtype):
        if self.shard is None:
            return dot_f32(x, self.w, compute_dtype) + self.b
        x = copy_to_model(x.float(), self.shard)
        return gather_from_model(dot_f32(x, self.w, compute_dtype) + self.b,
                                 self.shard)

    def full(self):
        """(w, b) at full width, detached: this rank's own without a
        shard, else gathered over the model group (a collective)."""
        w, b = self.w.detach(), self.b.detach()
        if self.shard is None:
            return w, b
        return self.shard.gather(w), self.shard.gather(b)
