"""K3's plain version (`conv_relu_pool_plain`, the CPU path) against the
JAX package: the Pallas kernel in interpret mode, and the unfused
`apply_trunk` stage where the kernel's geometry limits (H % 8, even W)
exclude odd sizes. The port's `Trunk` with `fuse=True` must equal the
unfused trunk. f32, rtol / atol 1e-4 (conv summation order differs
between XLA:CPU and torch). In bf16 the plain version, the gate of the
card kernel's rounding order, is held to within 2 bf16 ulps of the
unfused JAX stage.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densecap_tpu.models.vgg16 import apply_trunk
from densecap_tpu.ops.pallas.conv_pool_kernel import fused_conv_relu_pool
from densecap_tpu_torch.models.vgg16 import TRUNK1_CFG, Trunk
from densecap_tpu_torch.ops.conv_pool import (conv_relu_pool,
                                              conv_relu_pool_plain)

torch.set_num_threads(2)
TOL = 1e-4


def _case(seed, N, H, W, C, ext):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, H, W, C)).astype(np.float32)
    w = (rng.standard_normal((3, 3, C, C)) * 0.05).astype(np.float32)
    b = rng.standard_normal(C).astype(np.float32)
    return x, w, b, np.asarray(ext, np.float32)


def _port(x, w, b, ext, fn=conv_relu_pool):
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)  # channels_last view
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    e = torch.from_numpy(ext)
    out = fn(xt, wt, torch.from_numpy(b), e[:, 0], e[:, 1])
    return out.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("C,H,W", [(64, 16, 12), (128, 16, 8)])
def test_plain_matches_pallas_interpret(C, H, W):
    # odd and even extents: odd ones exercise the floor-halved re-mask
    ext = [[H, W], [H - 3, W - 1], [H - 1, W - 3], [5, 4]]
    x, w, b, ext = _case(C, 4, H, W, C, ext)
    ref = fused_conv_relu_pool(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               jnp.asarray(ext), interpret=True)
    np.testing.assert_allclose(_port(x, w, b, ext), np.asarray(ref),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("C,H,W", [(64, 13, 11), (128, 9, 10)])
def test_odd_sizes_match_unfused_jax_trunk(C, H, W):
    ext = [[H, W], [H - 2, W - 3]]
    x, w, b, ext = _case(C + H, 2, H, W, C, ext)
    got = _port(x, w, b, ext)
    assert got.shape == (2, H // 2, W // 2, C)
    params = {"c": {"w": jnp.asarray(w), "b": jnp.asarray(b)}}
    for i in range(2):
        ref = apply_trunk(params, [("c", C), "M"], jnp.asarray(x[i:i + 1]),
                          jnp.float32, valid_h=float(ext[i, 0]),
                          valid_w=float(ext[i, 1]))
        np.testing.assert_allclose(got[i], np.asarray(ref[0]), rtol=TOL,
                                   atol=TOL)


def _bf16_bits(a):
    """Top 16 bits of non-negative f32 values that are bf16 numbers."""
    return (np.abs(np.asarray(a, np.float32)).view(np.uint32) >> 16
            ).astype(np.int64)


@pytest.mark.parametrize("C,H,W", [(64, 16, 12), (128, 13, 10)])
def test_plain_bf16_matches_unfused_jax_stage(C, H, W):
    # the bf16 stage rounds the f32 conv sums to bf16, adds the bf16 bias
    # and rounds again, then ReLU, mask, pool, mask: the order the card
    # kernel's epilogue reproduces. The f32 sums are taken in another
    # order on XLA:CPU and torch, so a rounding may differ by an ulp.
    ext = [[H, W], [H - 3, W - 5]]
    x, w, b, ext = _case(C + 7, 2, H, W, C, ext)
    x, w, b = (torch.from_numpy(a).bfloat16().float().numpy()
               for a in (x, w, b))
    xt = torch.from_numpy(x).bfloat16().permute(0, 3, 1, 2)
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    e = torch.from_numpy(ext)
    got = conv_relu_pool_plain(xt, wt.bfloat16(),
                               torch.from_numpy(b).bfloat16(), e[:, 0],
                               e[:, 1])
    assert got.dtype == torch.bfloat16
    got = got.float().permute(0, 2, 3, 1).numpy()
    params = {"c": {"w": jnp.asarray(w), "b": jnp.asarray(b)}}
    ref = np.concatenate([np.asarray(apply_trunk(
        params, [("c", C), "M"], jnp.asarray(x[i:i + 1]), jnp.bfloat16,
        valid_h=float(ext[i, 0]), valid_w=float(ext[i, 1])))
        for i in range(2)])
    assert got.shape == ref.shape == (2, H // 2, W // 2, C)
    assert (got >= 0).all() and (ref >= 0).all()
    ulps = np.abs(_bf16_bits(got) - _bf16_bits(ref))
    equal = float((ulps == 0).mean())
    assert ulps.max() <= 2, f"max {ulps.max()} ulps, {equal:.2%} bit-equal"
    assert equal >= 0.99, f"only {equal:.2%} of the outputs are bit-equal"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_trunk_fused_equals_unfused(dtype):
    rng = np.random.default_rng(5)
    convs, cin = {}, 3
    for item in TRUNK1_CFG:
        if item == "M":
            continue
        name, cout = item
        w = rng.standard_normal((cout, cin, 3, 3)) * (2.0 / (9 * cin)) ** 0.5
        convs[name] = (torch.tensor(w, dtype=dtype).contiguous(
            memory_format=torch.channels_last),
            torch.tensor(rng.standard_normal(cout) * 0.1, dtype=dtype))
        cin = cout
    trunk = Trunk(TRUNK1_CFG, convs, dtype)
    x = torch.from_numpy((rng.standard_normal((2, 30, 27, 3)) * 30
                          ).astype(np.float32)).permute(0, 3, 1, 2)
    eh, ew = torch.tensor([30.0, 21.0]), torch.tensor([25.0, 27.0])
    fused = trunk(x, eh, ew, fuse=True)
    plain = trunk(x, eh, ew)
    assert fused.shape == (2, 128, 7, 6)
    assert torch.equal(fused, plain)


def test_cpu_dispatch_takes_plain_version():
    x, w, b, ext = _case(0, 1, 6, 6, 64, [[6, 5]])
    np.testing.assert_array_equal(_port(x, w, b, ext),
                                  _port(x, w, b, ext, conv_relu_pool_plain))
