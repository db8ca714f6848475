"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: they skip where there is no CUDA device (a CUDA kernel has
no CPU mode). On a machine with a card and nvcc:

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q

(`--noconftest` because the root conftest.py configures JAX.)
These are the checks of chip_smoke.py's kernel phases at smaller
shapes: NMS picks identical, RoI align within 1e-5 on unit-scale
features and its backward (K2b) within 1e-5 (d feats) and 1e-4 (d boxes)
of the plain autograd gradient's scale, the fused conv+pool (K3) in f32 within 1e-4 and in
bf16 no worse than the plain version against an f32 oracle, and each
wrapper counting exactly its own launches; the int8 product of
`ops/quant.py` on the card identical to the CPU's; each kernel launched
on its tensors' device from a thread whose current device is another
(skipped with fewer than two cards); two model replicas on one card
(`parallel.mesh.Replicas`) equal to the model alone; and the loader over
an h5 the port's codec wrote, through the train CLI's copy into one
train step on the card.
"""

import threading

import numpy as np
import pytest
import torch

from densecap_tpu_torch.models.vgg16 import feat_extent
from densecap_tpu_torch.ops import conv_pool as cp
from densecap_tpu_torch.ops import nms as nms_mod
from densecap_tpu_torch.ops import roi_align as roi_mod
from densecap_tpu_torch.ops.boxes import xcycwh_to_x1y1x2y2
from densecap_tpu_torch.ops.cuda import build

pytestmark = pytest.mark.gpu
NONE = {k: 0 for k in build.launches}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # plain f32 convs in full f32, not TF32 (cuDNN's default)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = tf32


def _boxes(rng, b, n, clustered=False):
    if clustered:
        xy = rng.uniform(100, 140, (b, n, 2))
        wh = rng.uniform(40, 60, (b, n, 2))
    else:
        xy = rng.uniform(0, 720, (b, n, 2))
        wh = rng.uniform(8, 300, (b, n, 2))
    return np.concatenate([xy, wh], -1).astype(np.float32)


TIE_HEIGHT = {0.3: 3, 0.4: 4, 0.5: 5, 0.7: 7}


def threshold_ties(thresh):
    """Pairs of boxes whose pascal IoU sits on `thresh` (a key of
    TIE_HEIGHT): a 10 x h integer box inside a 10 x 10 one has IoU h / 10,
    and f32(h * 10 / 100) == f32(thresh), so `IoU > thresh` is false. Each
    pair also comes with the inner box's y2 or x1 one ulp either way. The
    pairs sit apart (no two pairs touch) at offsets 0 to 5000, so an ulp
    is from 5e-7 to 5e-4 px. -> boxes (1, N, 4) x1y1x2y2 f32 and scores
    (1, N) f32, every outer box scored above every inner one."""
    h = TIE_HEIGHT[thresh]
    up, down = np.float32(np.inf), np.float32(-np.inf)
    boxes = []
    for base in (0.0, 100.0, 700.0, 5000.0):
        for k, (coord, to) in enumerate([(None, None), (3, up), (3, down),
                                         (0, up), (0, down)]):
            ox, oy = np.float32(base + 20 * k), np.float32(base)
            outer = np.array([ox, oy, ox + 9, oy + 9], np.float32)
            inner = np.array([ox, oy, ox + 9, oy + h - 1], np.float32)
            if coord is not None:
                inner[coord] = np.nextafter(inner[coord], to)
            boxes.append((outer, inner))
    n = len(boxes)
    order = [b[0] for b in boxes] + [b[1] for b in boxes]
    scores = np.concatenate([2.0 - np.arange(n) / 100,
                             1.0 - np.arange(n) / 100]).astype(np.float32)
    return np.stack(order)[None], scores[None]


@pytest.mark.parametrize("presorted", [False, True])
@pytest.mark.parametrize("clustered", [False, True])
def test_nms_kernel_matches_plain(dev, presorted, clustered):
    rng = np.random.default_rng(int(presorted) * 2 + int(clustered))
    B, N, K = 3, 2000, 300
    boxes = xcycwh_to_x1y1x2y2(
        torch.from_numpy(_boxes(rng, B, N, clustered)).to(dev))
    scores = np.round(rng.uniform(0, 1, (B, N)), 2).astype(np.float32)
    if presorted:
        scores = -np.sort(-scores, axis=1)
    valid = torch.from_numpy(rng.uniform(0, 1, (B, N)) > 0.2).to(dev)
    args = (boxes, torch.from_numpy(scores).to(dev), 0.7, K)
    build.reset_launches()
    ki, kv = nms_mod.nms(*args, valid=valid, presorted=presorted)
    assert build.launches == dict(NONE, nms=1)
    pi, pv = nms_mod.nms_plain(*args, valid=valid, presorted=presorted)
    assert torch.equal(kv, pv) and torch.equal(ki, pi)


def test_nms_kernel_matches_plain_extract_features_shape(dev):
    """extract_features' final NMS: 1000 unsorted boxes -> 100 at 0.4,
    with a valid mask, so the scan stops at 100 survivors."""
    rng = np.random.default_rng(7)
    B, N, K = 4, 1000, 100
    boxes = xcycwh_to_x1y1x2y2(torch.from_numpy(_boxes(rng, B, N)).to(dev))
    scores = torch.from_numpy(rng.normal(0, 3, (B, N)).astype(np.float32)
                              ).to(dev)
    valid = torch.from_numpy(rng.uniform(0, 1, (B, N)) > 0.1).to(dev)
    build.reset_launches()
    ki, kv = nms_mod.nms(boxes, scores, 0.4, K, valid=valid)
    assert build.launches == dict(NONE, nms=1)
    pi, pv = nms_mod.nms_plain(boxes, scores, 0.4, K, valid=valid)
    assert torch.equal(kv, pv) and torch.equal(ki, pi)
    assert int(kv.sum()) == B * K


def _nms_edge_case(name):
    """-> (boxes x1y1x2y2 (B, N, 4), scores (B, N), valid (B, N) or None,
    thresh, max_out) as numpy, for one named edge case of K1."""
    rng = np.random.default_rng(len(name))
    if name.startswith("ties_"):
        thresh = float(name[5:])
        boxes, scores = threshold_ties(thresh)
        return boxes, scores, None, thresh, boxes.shape[1]
    B, N, K, thresh, valid = {
        "n_1000_not_tile_multiple": (2, 1000, 300, 0.7, True),
        "n_130_not_tile_multiple": (2, 130, 50, 0.5, True),
        "n_1": (3, 1, 4, 0.7, False),
        "all_invalid": (2, 200, 50, 0.7, None),
        "max_out_above_survivors": (2, 300, 290, 0.3, False),
        "max_out_4000": (2, 6000, 4000, 0.7, False),
        "n_24300_no_topk": (2, 24300, 1000, 0.7, False),
    }[name]
    boxes = xcycwh_to_x1y1x2y2(torch.from_numpy(_boxes(
        rng, B, N, clustered=name == "max_out_above_survivors"))).numpy()
    scores = rng.uniform(0, 1, (B, N)).astype(np.float32)
    if valid is None:
        v = np.zeros((B, N), bool)
    elif valid:
        v = rng.uniform(0, 1, (B, N)) > 0.2
    else:
        v = None
    return boxes, scores, v, thresh, K


NMS_EDGE_CASES = ["n_1000_not_tile_multiple", "n_130_not_tile_multiple",
                  "n_1", "all_invalid", "max_out_above_survivors",
                  "max_out_4000", "n_24300_no_topk", "ties_0.3", "ties_0.5",
                  "ties_0.7"]


@pytest.mark.parametrize("name", NMS_EDGE_CASES)
def test_nms_kernel_edge_cases_match_plain(dev, name):
    boxes, scores, valid, thresh, K = _nms_edge_case(name)
    args = (torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev),
            thresh, K)
    v = None if valid is None else torch.from_numpy(valid).to(dev)
    build.reset_launches()
    ki, kv = nms_mod.nms(*args, valid=v)
    assert build.launches == dict(NONE, nms=1)
    pi, pv = nms_mod.nms_plain(*args, valid=v)
    assert torch.equal(kv, pv) and torch.equal(ki, pi)
    if name == "all_invalid":
        assert not bool(kv.any())
    if name == "max_out_above_survivors":
        assert 0 < int(kv.sum(1).max()) < K
    if name == "max_out_4000":
        assert int(kv.sum(1).min()) == K


def test_nms_kernel_rejects_max_out_past_shared_memory(dev):
    boxes = torch.zeros((1, 8, 4), device=dev)
    with pytest.raises(ValueError):
        nms_mod.nms(boxes, torch.zeros((1, 8), device=dev), 0.5,
                    nms_mod.MAX_OUT + 1)


def test_roi_align_kernel_matches_plain(dev):
    rng = np.random.default_rng(0)
    feats = torch.from_numpy(
        rng.standard_normal((3, 45, 45, 512), dtype=np.float32)).to(dev)
    img_h = torch.tensor([720.0, 540.0, 300.0], device=dev)
    img_w = torch.tensor([540.0, 720.0, 700.0], device=dev)
    fh, fw = feat_extent(img_h, img_w)
    bx = _boxes(rng, 3, 200)
    bx[..., 2:] *= 1.5
    args = (feats, torch.from_numpy(bx).to(dev), img_h, img_w, fh, fw)
    build.reset_launches()
    got = roi_mod.roi_align(*args)
    assert build.launches == dict(NONE, roi_align=1)
    ref = roi_mod.roi_align_plain(*args)
    assert float((got - ref).abs().max()) <= 1e-5


# K2 takes 16-byte accesses when C % 4 == 0 and the feature base is
# 16-byte aligned, one channel per thread otherwise; cv > 128 makes a
# thread loop over channels. "ext_1x1": an image whose cropped extent is
# one feature cell; "misaligned": a contiguous view 4 bytes into its
# storage.
@pytest.mark.parametrize("C,out_hw,case", [
    (512, (7, 7), "plain"),
    (256, (7, 7), "plain"),
    (6, (7, 7), "plain"),
    (2048, (7, 7), "plain"),
    (512, (3, 5), "plain"),
    (256, (16, 16), "plain"),
    (512, (7, 7), "ext_1x1"),
    (512, (7, 7), "misaligned"),
], ids=["c512", "c256", "c6_scalar", "c2048_loop", "out_3x5", "out_16x16",
        "ext_1x1", "misaligned"])
def test_roi_align_kernel_shapes_match_plain(dev, C, out_hw, case):
    rng = np.random.default_rng(C + out_hw[0])
    B, Hf, Wf = 3, 23, 29
    base = torch.from_numpy(rng.standard_normal(
        B * Hf * Wf * C + 1, dtype=np.float32)).to(dev)
    off = 1 if case == "misaligned" else 0
    feats = base[off:off + B * Hf * Wf * C].view(B, Hf, Wf, C)
    assert feats.is_contiguous() and (feats.data_ptr() % 16 != 0) == bool(off)
    img_h = torch.tensor([360.0, 270.0, 300.0], device=dev)
    img_w = torch.tensor([460.0, 360.0, 200.0], device=dev)
    if case == "ext_1x1":
        img_h[1] = img_w[1] = 20.0
    fh, fw = feat_extent(img_h, img_w)
    assert int(fh.max()) <= Hf and int(fw.max()) <= Wf
    bx = _boxes(rng, B, 60) * [0.5, 0.5, 1.0, 1.0]
    args = (feats, torch.from_numpy(bx.astype(np.float32)).to(dev), img_h,
            img_w, fh, fw, *out_hw)
    build.reset_launches()
    got = roi_mod.roi_align(*args)
    assert build.launches == dict(NONE, roi_align=1)
    ref = roi_mod.roi_align_plain(*args)
    assert got.shape == ref.shape == (B, 60, *out_hw, C)
    assert float((got - ref).abs().max()) <= 1e-5


@pytest.mark.parametrize("extent", ["empty", "oversized"])
def test_roi_align_kernel_keeps_a_bad_extent_in_the_map(dev, extent):
    """The card does not check extents (the host only rejects a frame off
    its canvas, in utils.image): K2 and K2b clamp each extent to the map
    as the plain version does, so an empty or oversized one neither faults
    nor poisons the CUDA context, and agrees with plain."""
    rng = np.random.default_rng(3)
    B, Hf, Wf, C = 2, 9, 11, 64
    feats = torch.from_numpy(rng.standard_normal(
        (B, Hf, Wf, C), dtype=np.float32)).to(dev)
    img_h = torch.tensor([144.0, 100.0], device=dev)
    img_w = torch.tensor([176.0, 120.0], device=dev)
    bad = 0 if extent == "empty" else Hf + 7
    fh = torch.tensor([bad, 6], dtype=torch.int32, device=dev)
    fw = torch.tensor([7, bad], dtype=torch.int32, device=dev)
    bx = torch.from_numpy(_boxes(rng, B, 20) * 0.2).to(dev)

    def run(fn):
        f = feats.clone().requires_grad_()
        b = bx.clone().requires_grad_()
        out = fn(f, b, img_h, img_w, fh, fw)
        out.backward(torch.ones_like(out))
        return out, f.grad, b.grad

    got = run(roi_mod.roi_align)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(t).all()) for t in got)
    ref = run(roi_mod.roi_align_plain)
    for k, p, tol in zip(got, ref, (1e-5, 1e-5, 1e-4)):
        assert float((k - p).abs().max()) <= tol * max(
            float(p.abs().max()), 1.0)
    fh, fw = feat_extent(img_h, img_w)
    got = roi_mod.roi_align(feats, bx, img_h, img_w, fh, fw)
    ref = roi_mod.roi_align_plain(feats, bx, img_h, img_w, fh, fw)
    assert float((got - ref).abs().max()) <= 1e-5


# K2b, both instances (positions alone while the trunk is frozen, and
# with d feats), one launch per backward. One channel per thread when
# C % 4 != 0 or the feature base is not 16-byte aligned ("misaligned": a
# contiguous view 4 bytes into its storage); "ext_1x1" / "ext_0": an
# image whose cropped extent is one feature cell, or none (a frame under
# 16 px); "piled": 384 boxes on one feature cell, so the d feats
# reductions of every block contend for the same lines. The position
# gradients are summed in a fixed order: two launches give them bit for
# bit.
@pytest.mark.parametrize("feats_grad", [False, True],
                         ids=["frozen_trunk", "trunk_trains"])
@pytest.mark.parametrize("C,out_hw,case", [
    (512, (7, 7), "plain"),
    (256, (7, 7), "plain"),
    (6, (7, 7), "plain"),
    (256, (3, 5), "plain"),
    (64, (16, 16), "plain"),
    (256, (7, 7), "ext_1x1"),
    (256, (7, 7), "ext_0"),
    (512, (7, 7), "piled"),
    (256, (7, 7), "misaligned"),
], ids=["c512", "c256", "c6_scalar", "out_3x5", "out_16x16", "ext_1x1",
        "ext_0", "piled_384", "misaligned"])
def test_roi_align_backward_matches_plain(dev, C, out_hw, case, feats_grad):
    rng = np.random.default_rng(C + out_hw[0] + len(case))
    B, Hf, Wf = 2, 45, 45
    K = 384 if case == "piled" else 100
    base = torch.from_numpy(rng.standard_normal(
        B * Hf * Wf * C + 1, dtype=np.float32)).to(dev)
    off = 1 if case == "misaligned" else 0
    feats = base[off:off + B * Hf * Wf * C].view(B, Hf, Wf, C)
    assert (feats.data_ptr() % 16 != 0) == bool(off)
    img_h = torch.tensor([720.0, 540.0], device=dev)
    img_w = torch.tensor([540.0, 720.0], device=dev)
    if case == "ext_1x1":
        img_h[1] = img_w[1] = 20.0
    if case == "ext_0":
        img_w[1] = 10.0
    fh, fw = feat_extent(img_h, img_w)
    bx = _boxes(rng, B, K) * [1, 1, 1.5, 1.5]
    if case == "piled":
        bx[:] = [100.0, 100.0, 2.0, 2.0]
    bx = torch.from_numpy(bx).float().to(dev)
    g = torch.from_numpy(rng.standard_normal((B, K, *out_hw, C),
                                             dtype=np.float32)).to(dev)

    def grads(fn):
        f = feats.detach().requires_grad_(feats_grad)  # keeps the offset
        b = bx.clone().requires_grad_()
        fn(f, b, img_h, img_w, fh, fw, *out_hw).backward(g)
        return f.grad, b.grad

    build.reset_launches()
    kf, kb = grads(roi_mod.roi_align)
    assert build.launches == dict(
        NONE, roi_align=1, roi_align_bwd=int(not feats_grad),
        roi_align_bwd_feats=int(feats_grad))
    pf, pb = grads(roi_mod.roi_align_plain)
    assert float((kb - pb).abs().max()) <= 1e-4 * float(pb.abs().max())
    if feats_grad:
        assert float((kf - pf).abs().max()) <= 1e-5 * float(pf.abs().max())
    prep = roi_mod.prepare_cuda(feats, bx, img_h, img_w, fh, fw, *out_hw)
    runs = []
    for _ in range(2):
        d_yf = torch.empty_like(prep[0])
        d_xf_rows = torch.empty((B * K, *out_hw), device=dev)
        roi_mod.launch_bwd(g.reshape(B * K, *out_hw, C), feats, *prep, d_yf,
                           d_xf_rows, torch.zeros_like(feats) if feats_grad
                           else None)
        runs.append((d_yf, d_xf_rows))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# K3's tiles are 32 conv columns x 2 conv rows per warpgroup, two tiles
# per CTA, one CTA per SM: the cases cover a width that is not a multiple
# of the tile and one just past it, odd heights, extents of 2x2 and 0,
# three images of different extents, and more tiles than CTAs, so that
# the persistent walk wraps. ext None: (H, W - 1) and (H - 4, W - 6).
@pytest.mark.parametrize("C,H,W,ext", [
    (64, 37, 40, None),
    (128, 23, 26, None),
    (64, 10, 100, [(10, 100), (7, 61)]),
    (128, 9, 33, [(9, 33), (8, 30)]),
    (64, 7, 66, [(7, 66), (5, 65)]),
    (64, 12, 20, [(2, 2), (0, 0), (12, 20)]),
    (128, 15, 70, [(15, 70), (9, 33), (4, 65)]),
    (64, 200, 200, [(200, 200), (151, 97), (64, 200)]),
    (128, 200, 200, [(200, 200), (151, 97), (64, 200)]),
], ids=["c64", "c128", "w100", "w_tile_plus_1", "odd_h", "tiny_and_empty",
        "b3_ragged", "wrap_c64", "wrap_c128"])
def test_conv_pool_kernel_matches_plain(dev, C, H, W, ext):
    rng = np.random.default_rng(C)
    if ext is None:
        ext = [(H, W - 1.0), (H - 4.0, W - 6.0)]
    n = len(ext)
    x = torch.from_numpy(rng.standard_normal((n, C, H, W), dtype=np.float32)
                         ).to(dev).contiguous(memory_format=torch.channels_last)
    w = torch.from_numpy(rng.standard_normal((C, C, 3, 3), dtype=np.float32)
                         * (2 / (9 * C)) ** 0.5).to(dev)
    b = torch.from_numpy(rng.standard_normal(C, dtype=np.float32) * 0.1
                         ).to(dev)
    eh = torch.tensor([float(e[0]) for e in ext], device=dev)
    ew = torch.tensor([float(e[1]) for e in ext], device=dev)
    with torch.no_grad():
        build.reset_launches()
        got = cp.conv_relu_pool(x, w, b, eh, ew)
        assert build.launches == dict(NONE, conv_pool=1)
        ref = cp.conv_relu_pool_plain(x, w, b, eh, ew)
        assert got.shape == ref.shape == (n, C, H // 2, W // 2)
        assert torch.allclose(got, ref, rtol=1e-4, atol=1e-4)
        xb, wb, bb = x.bfloat16(), w.bfloat16(), b.bfloat16()
        oracle = cp.conv_relu_pool_plain(x.bfloat16().float(),
                                         wb.float(), bb.float(), eh, ew)
        k_err = (cp.conv_relu_pool(xb, wb, bb, eh, ew).float() - oracle)
        p_err = (cp.conv_relu_pool_plain(xb, wb, bb, eh, ew).float() - oracle)
        assert float(k_err.abs().max()) <= 1.25 * float(p_err.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_conv_pool_kernel_takes_an_nchw_map(dev, dtype):
    """PyTorch's own conv (cuDNN off) writes NCHW; the wrapper copies it
    into channels_last and gives the channels_last input's answer."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 64, 18, 30), dtype=np.float32)
                         ).to(dev, dtype)
    w = torch.from_numpy(rng.standard_normal((64, 64, 3, 3), dtype=np.float32)
                         * (2 / (9 * 64)) ** 0.5).to(dev, dtype)
    b = torch.zeros(64, device=dev, dtype=dtype)
    eh = torch.tensor([18.0, 11.0], device=dev)
    ew = torch.tensor([30.0, 25.0], device=dev)
    assert x.is_contiguous()
    with torch.no_grad():
        build.reset_launches()
        got = cp.conv_relu_pool(x, w, b, eh, ew)
        assert build.launches == dict(NONE, conv_pool=1)
        want = cp.conv_relu_pool(
            x.contiguous(memory_format=torch.channels_last), w, b, eh, ew)
    assert torch.equal(got, want)


def test_conv_pool_kernel_has_no_gradient(dev):
    x = torch.zeros((1, 64, 4, 4), device=dev, requires_grad=True)
    w = torch.zeros((64, 64, 3, 3), device=dev)
    with pytest.raises(RuntimeError):
        cp.conv_relu_pool_cuda(x.contiguous(memory_format=torch.channels_last),
                               w, torch.zeros(64, device=dev),
                               torch.ones(1, device=dev) * 4,
                               torch.ones(1, device=dev) * 4)


@pytest.mark.parametrize("M,K,N", [(1, 37, 13), (16, 64, 48), (17, 256, 128),
                                   (50, 25088, 4096), (300, 512, 10001)])
def test_int8_qdot_on_card_matches_cpu(dev, M, K, N):
    """The int8 product (torch._int_mm, not a kernel of this repository)
    on the card at its shape rules' edges: M <= 16 and K, N off a multiple
    of 8 are padded by `qdot`. Codes and int32 products identical to the
    CPU's, outputs within rtol 1e-6."""
    from densecap_tpu_torch.ops import quant

    rng = np.random.default_rng(M + K)
    p = {"w": (rng.standard_normal((K, N)) * 0.02).astype(np.float32),
         "b": (rng.standard_normal(N) * 0.01).astype(np.float32)}
    x = torch.from_numpy(np.abs(rng.standard_normal((M, K))).astype(
        np.float32)).bfloat16()
    q = quant.quantize_linear(p)
    layers = {d: quant.QuantLinear(q, d) for d in ("cpu", dev)}
    codes = {d: quant.quantize_rows(x.to(d)) for d in layers}
    assert torch.equal(codes[dev][0].cpu(), codes["cpu"][0])
    assert torch.equal(codes[dev][1].cpu(), codes["cpu"][1])
    acc = {d: quant.int_mm(codes[d][0], layers[d]) for d in layers}
    assert torch.equal(acc[dev].cpu(), acc["cpu"])
    got = quant.qdot(x.to(dev), layers[dev]).cpu()
    ref = quant.qdot(x, layers["cpu"])
    assert got.shape == (M, N)
    assert torch.allclose(got, ref, rtol=1e-6, atol=0)


@pytest.fixture
def second(dev):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return torch.device("cuda", 1)


def _on_fresh_thread(fn):
    """fn() on a new thread whose current device is cuda:0."""
    out = {}

    def run():
        torch.cuda.set_device(0)
        out["result"] = fn()
        torch.cuda.synchronize(1)

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=300)
    assert not t.is_alive()
    return out["result"]


def test_kernels_launch_on_their_tensors_device(dev, second):
    """K1, K2 and K3 (bf16 and f32) called on cuda:1 tensors from a thread
    whose current device is cuda:0, each after its first launch on
    cuda:0: the same results as on cuda:0 (a ctypes call launches on the
    current device, and K3's shared-memory attribute is set per device)."""
    rng = np.random.default_rng(5)
    boxes = xcycwh_to_x1y1x2y2(torch.from_numpy(_boxes(rng, 2, 3000)))
    scores = torch.from_numpy(rng.uniform(0, 1, (2, 3000)).astype(np.float32))
    feats = torch.from_numpy(rng.standard_normal((2, 45, 45, 512),
                                                 dtype=np.float32))
    img_h, img_w = torch.tensor([720.0, 540.0]), torch.tensor([540.0, 720.0])
    fh, fw = feat_extent(img_h, img_w)
    rois = torch.from_numpy(_boxes(rng, 2, 300))
    x = torch.from_numpy(rng.standard_normal((2, 64, 40, 66),
                                             dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 64, 3, 3),
                                             dtype=np.float32) * 0.06)
    b = torch.from_numpy(rng.standard_normal(64, dtype=np.float32) * 0.1)
    eh, ew = torch.tensor([40.0, 31.0]), torch.tensor([66.0, 50.0])

    def calls(d):
        def run():
            with torch.no_grad():
                xd = x.to(d).contiguous(memory_format=torch.channels_last)
                return {
                    "nms": nms_mod.nms(boxes.to(d), scores.to(d), 0.7, 500),
                    "roi": roi_mod.roi_align(feats.to(d), rois.to(d),
                                             img_h.to(d), img_w.to(d),
                                             fh.to(d), fw.to(d)),
                    **{f"conv_{t}": cp.conv_relu_pool(
                        xd.to(dt), w.to(d, dt), b.to(d, dt), eh.to(d),
                        ew.to(d))
                       for t, dt in (("bf16", torch.bfloat16),
                                     ("f32", torch.float32))}}
        return run

    ref = calls(dev)()
    build.reset_launches()
    got = _on_fresh_thread(calls(second))
    assert build.launches == dict(NONE, nms=1, roi_align=1, conv_pool=2)
    for k in ref:
        for r, g in zip(*(v if isinstance(v, tuple) else (v,)
                          for v in (ref[k], got[k]))):
            assert g.device == second
            assert torch.equal(r.cpu(), g.cpu()), k


def test_two_replicas_on_one_card_equal_one(dev):
    """Two replicas on cuda:0 (each its own thread and stream) against
    the model alone on the whole batch; both replicas' launches count."""
    from densecap_tpu_torch.config import DenseCapConfig
    from densecap_tpu_torch.parallel.mesh import Replicas
    from densecap_tpu_torch.utils.checkpoint import init_params, to_torch
    from densecap_tpu_torch.utils.image import to_model_input

    cfg = DenseCapConfig(vocab_size=20, seq_length=4, image_size=96,
                         anchors=((8, 8), (16, 16), (12, 24), (24, 12)),
                         test_max_proposals=12, test_pre_nms_topk=64,
                         rnn_size=32, rnn_encoding_size=32, fc_dim=64,
                         rpn_num_filters=32, compute_dtype=torch.float32)
    model = to_torch(init_params(cfg, seed=3), cfg, dev)
    rng = np.random.default_rng(3)
    canvases = rng.integers(0, 256, (4, 96, 96, 3), dtype=np.uint8)
    hs, ws = [96.0, 72.0, 96.0, 50.0], [80.0, 96.0, 96.0, 96.0]
    ref = model.forward_test_batch(*to_model_input(canvases, hs, ws, dev))
    reps = Replicas(model, [dev, dev])
    try:
        assert reps.streams[0] != reps.streams[1]
        build.reset_launches()
        outs = reps.run(canvases, hs, ws)
        torch.cuda.synchronize()
        assert build.launches == dict(NONE, nms=4, roi_align=2)
    finally:
        reps.close()
    assert [len(o.boxes) for o in outs] == [2, 2]
    for k in ("valid", "captions"):
        assert torch.equal(torch.cat([getattr(o, k) for o in outs]),
                           getattr(ref, k))
    for k in ("boxes", "scores"):
        torch.testing.assert_close(torch.cat([getattr(o, k) for o in outs]),
                                   getattr(ref, k), rtol=1e-4, atol=1e-3)


def test_codec_h5_into_a_train_step(dev, tmp_path):
    """DenseCapLoader over an h5 the port's codec wrote, its batch through
    the train CLI's pinned copy into one Trainer step on the card: the
    canvases arrive byte-equal, the losses are finite, K2 and K2b
    launch."""
    import json

    from densecap_tpu_torch.cli.train import _to_device
    from densecap_tpu_torch.config import DenseCapConfig
    from densecap_tpu_torch.data.loader import DenseCapLoader
    from densecap_tpu_torch.parallel.train_step import Trainer
    from densecap_tpu_torch.utils import h5
    from densecap_tpu_torch.utils.checkpoint import init_params, to_torch

    rng = np.random.default_rng(5)
    n, S, L = 3, 96, 4
    images = rng.integers(0, 256, (n, 3, S, S), dtype=np.uint8)
    per_image = [2, 3, 1]
    boxes = np.array([[30, 30, 20, 24], [50, 40, 30, 20], [20, 60, 16, 30],
                      [70, 70, 24, 24], [40, 30, 40, 40], [48, 48, 30, 30]],
                     np.int32)
    first = np.cumsum([1] + per_image[:-1]).astype(np.int32)
    with h5.File(tmp_path / "d.h5", "w") as f:
        d = f.create_dataset("images", images.shape, dtype=np.uint8)
        for i in range(n):
            d[i] = images[i]
        for k in ("image_heights", "image_widths", "original_heights",
                  "original_widths"):
            f.create_dataset(k, data=np.full(n, S, np.int32))
        f.create_dataset("boxes", data=boxes)
        f.create_dataset("labels", data=rng.integers(1, 6, (6, L)).astype(
            np.int32))
        f.create_dataset("img_to_first_box", data=first)
        f.create_dataset("img_to_last_box",
                         data=(first + per_image - 1).astype(np.int32))
        f.create_dataset("split", data=np.zeros(n, np.int32))
    words = {str(i): f"w{i}" for i in range(1, 6)}
    (tmp_path / "d.json").write_text(json.dumps({
        "token_to_idx": {v: int(k) for k, v in words.items()},
        "idx_to_token": words, "filename_to_idx": {},
        "idx_to_filename": {}}))
    loader = DenseCapLoader(tmp_path / "d.h5", tmp_path / "d.json",
                            max_gt_boxes=4)
    try:
        batch = loader.get_batch(2, split=0)
    finally:
        loader.close()
    cfg = DenseCapConfig(vocab_size=5, seq_length=L, image_size=S,
                         anchors=((8, 8), (16, 16), (12, 24), (24, 12)),
                         sampler_batch_size=16, rnn_size=32,
                         rnn_encoding_size=32, fc_dim=64, rpn_num_filters=32,
                         max_gt_boxes=4, drop_prob=0.0)
    trainer = Trainer(to_torch(init_params(cfg, seed=3), cfg, dev,
                               train=True), learning_rate=1e-4)
    on_card = _to_device(batch, dev)
    assert torch.equal(on_card["image"].cpu(), torch.from_numpy(
        images[:2].transpose(0, 2, 3, 1).copy()))
    build.reset_launches()
    losses = trainer.step(on_card,
                          generator=torch.Generator(device=dev).manual_seed(1))
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(v)) for v in losses.values())
    assert build.launches["roi_align"] >= 1
    assert build.launches["roi_align_bwd"] >= 1
