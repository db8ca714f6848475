"""Fused 3x3 conv + bias + ReLU + extent mask + 2x2/2 max pool + mask.

Twin of `densecap_tpu/ops/pallas/conv_pool_kernel.py:fused_conv_relu_pool`,
the stage pair conv1_2+pool1 / conv2_2+pool2 of trunk1:

  * `conv_relu_pool_plain`: the unfused stage pair in PyTorch; the CPU
    path and the reference the kernel is held against.
  * `conv_relu_pool_cuda`: kernel K3 (`cuda/conv_pool.cu`).
  * `conv_relu_pool`: a CPU tensor takes the plain version, a CUDA tensor
    the kernel.

Inputs: `x` (B, C, H, W) in the compute dtype, channels_last memory (the
kernel's wrapper copies any other layout into it, e.g. the NCHW map that
PyTorch's own conv writes when cuDNN is off);
`w` (C, C, 3, 3) OIHW and `b` (C,) in the compute dtype; `eh` / `ew` (B,)
f32 true extents. Output (B, C, H // 2, W // 2) channels_last, zero past
the floor-halved extents. Trunk1 is never trained, so there is no
gradient: the kernel's wrapper raises if one is asked for.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .cuda import build


def extent_mask(H, W, eh, ew, dtype):
    """(B, 1, H, W) mask: 1 inside each image's (eh, ew) extent, else 0."""
    dev = eh.device
    rows = torch.arange(H, dtype=torch.float32, device=dev)[None] < eh[:, None]
    cols = torch.arange(W, dtype=torch.float32, device=dev)[None] < ew[:, None]
    return (rows[:, None, :, None] & cols[:, None, None, :]).to(dtype)


def conv_relu_pool_plain(x, w, b, eh, ew):
    """conv -> bias (in the compute dtype) -> ReLU -> mask -> pool -> mask."""
    x = F.conv2d(x, w, padding=1)
    x = torch.relu(x + b.view(1, -1, 1, 1))
    x = x * extent_mask(x.shape[2], x.shape[3], eh, ew, x.dtype)
    x = F.max_pool2d(x, 2, 2)
    eh, ew = torch.floor(eh / 2.0), torch.floor(ew / 2.0)
    return x * extent_mask(x.shape[2], x.shape[3], eh, ew, x.dtype)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def prepare_cuda(x, w, b, eh, ew):
    """The wrapper's work before K3: checks, the weight layout, the extents
    and the output. -> (x NHWC view, weights, bias, extents, out NHWC)."""
    if not x.is_cuda:
        raise ValueError("conv_relu_pool_cuda takes CUDA tensors")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad
                                    or b.requires_grad):
        raise RuntimeError("conv_relu_pool_cuda has no gradient (trunk1 is "
                           "never trained); run it under torch.no_grad()")
    B, C, H, W = x.shape
    if C not in (64, 128) or w.shape != (C, C, 3, 3) or b.shape != (C,):
        raise ValueError(f"conv_relu_pool_cuda: need a 3x3 CxC conv with C in "
                         f"{{64, 128}}, got x{tuple(x.shape)} w{tuple(w.shape)}")
    if H < 2 or W < 2:
        raise ValueError("conv_relu_pool_cuda: H and W must be >= 2")
    if x.dtype not in _DTYPES or w.dtype != x.dtype or b.dtype != x.dtype:
        raise ValueError("conv_relu_pool_cuda: x, w and b must share a dtype, "
                         "bf16 or f32")
    x_nhwc = x.contiguous(memory_format=torch.channels_last).permute(
        0, 2, 3, 1)
    # bf16: [dy][dx][co][ci], K-major for the wgmma; f32: [dy][dx][ci][co]
    wt = w.permute((2, 3, 0, 1) if x.dtype == torch.bfloat16
                   else (2, 3, 1, 0)).contiguous()
    ext = torch.stack([eh, ew], 1).float().contiguous()
    out = torch.empty((B, H // 2, W // 2, C), dtype=x.dtype, device=x.device)
    return x_nhwc, wt, b.contiguous(), ext, out


def launch_cuda(x_nhwc, wt, bias, ext, out):
    """One launch of K3 on prepared tensors (`prepare_cuda`); not counted.
    It launches on the tensors' device (a ctypes call launches on the
    calling thread's current device)."""
    B, H, W, C = x_nhwc.shape
    lib = build.load()
    with torch.cuda.device(x_nhwc.device):
        rc = lib.dc_conv_relu_pool(
            x_nhwc.data_ptr(), wt.data_ptr(), bias.data_ptr(),
            ext.data_ptr(), B, H, W, C, _DTYPES[x_nhwc.dtype],
            out.data_ptr(),
            torch.cuda.current_stream(x_nhwc.device).cuda_stream)
    build.check(rc, "conv_pool")


def conv_relu_pool_cuda(x, w, b, eh, ew):
    """Kernel K3 on CUDA tensors; same contract as `conv_relu_pool_plain`."""
    args = prepare_cuda(x, w, b, eh, ew)
    launch_cuda(*args)
    build.count_launch("conv_pool")
    return args[-1].permute(0, 3, 1, 2)


def conv_relu_pool(x, w, b, eh, ew):
    """The fused stage: the kernel on CUDA, the plain version on CPU."""
    if x.is_cuda:
        return conv_relu_pool_cuda(x, w, b, eh, ew)
    if x.device.type != "cpu":
        raise ValueError(f"conv_relu_pool: no implementation for {x.device}")
    return conv_relu_pool_plain(x, w, b, eh, ew)
