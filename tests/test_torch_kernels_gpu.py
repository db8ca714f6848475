"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: they skip where there is no CUDA device (a CUDA kernel has
no CPU mode). On a machine with a card and nvcc:

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q

(`--noconftest` because the root conftest.py configures JAX.)
These are the checks of chip_smoke.py's kernel phases at smaller
shapes: NMS picks identical, RoI align within 1e-5 on unit-scale
features and its backward (K2b) within 1e-5 (d feats) and 1e-4 (d boxes)
of the plain autograd gradient's scale, the fused conv+pool (K3) in f32 within 1e-4 and in
bf16 no worse than the plain version against an f32 oracle, the greedy
decode's vocab head (K4) with the plain head's tokens outside near ties,
its first index on ties and its logprobs within 1e-4, alone (at the
LSTM's widths and at GRiT's text decoder's, K = 768 and N = 30522) and
through a whole decode, the greedy decode's LSTM cell (K5) within CELL_TOL of the
plain cell at P = 1..8000 and at widths off its tiles, and through a
whole decode (bf16 and int8 heads) no further from the plain cell than
the plain cell is from itself with its gates summed in one product, and
each wrapper counting exactly its own launches; the ViTDet attention
core (K6) within VIT_ATTN_TOL of the logits written out in f32 at the
windowed, global, unaligned and ragged grids, its output a view, and the
inputs it does not take refused; the int8 product of
`ops/quant.py` on the card identical to the CPU's; each kernel launched
on its tensors' device from a thread whose current device is another
(skipped with fewer than two cards); two model replicas on one card
(`parallel.mesh.Replicas`) equal to the model alone; the loader over
an h5 the port's codec wrote, through the train CLI's copy into one
train step on the card; and GRiT's text decoder at full width, its steps
replayed from CUDA graphs equal bit for bit to the eager steps (at 800
and 100 rows, across calls, where END stops the loop early), a call's
outputs kept through the next call, a call on another stream and the f32
decoder eager, and the benchmark control's faults reaching the replayed
steps.
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
    (256, (14, 14), "plain"),
    (512, (7, 7), "ext_1x1"),
    (512, (7, 7), "misaligned"),
], ids=["c512", "c256", "c6_scalar", "c2048_loop", "out_3x5", "out_16x16",
        "grit_prefix_14x14", "ext_1x1", "misaligned"])
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


def test_span_device_time_on_the_card(dev):
    """A span on the card times its stream with an event pair that its
    children share the device of, resolved once the stream has passed its
    end marker and never by a wait of its own: a ~50 ms sleep on the
    stream lies inside its device time, not its host time."""
    from densecap_tpu_torch.utils import profiling as prof

    was = prof.set_recording(True)
    try:
        with prof.span("outer", dev) as outer:
            with prof.span("inner") as inner:
                torch.cuda._sleep(100_000_000)
        assert outer.device_ms is None and inner.device_ms is None
        s = prof.STORE.summary("inner", parent="outer", start_ns=outer.t0)
    finally:
        prof.set_recording(was)
    assert s["count"] == 1
    assert inner.device_ms == s["device_ms"] > 20
    assert outer.device_ms >= inner.device_ms
    assert outer.host_ms < inner.device_ms / 2


# K4: the greedy decode's vocab head at the model's widths
HEAD_K, HEAD_N, HEAD_T = 512, 10001, 15


def _head_inputs(dev, P, seed, K=HEAD_K, N=HEAD_N):
    """h in the LSTM's range, W (bf16) and b giving logits of spread ~1.3,
    END's bias raised so that it wins some rows, a quarter of the rows
    already done."""
    g = torch.Generator(device=dev).manual_seed(seed)
    h = torch.rand((P, K), generator=g, device=dev) * 2 - 1
    w = ((torch.rand((K, N), generator=g, device=dev) * 2 - 1)
         * (4 / K ** 0.5)).bfloat16()
    b = (torch.rand(N, generator=g, device=dev) * 2 - 1) * 0.1
    b[-1] = 4.5
    done = torch.rand(P, generator=g, device=dev) < 0.25
    return h, w, b, done


def _clear_rows(h, w, b, tol=1e-3):
    """Rows whose plain top-2 logit gap exceeds `tol`."""
    from densecap_tpu_torch.ops.linear import dot_f32

    top = (dot_f32(h, w, torch.bfloat16) + b).topk(2, dim=1).values
    return top[:, 0] - top[:, 1] > tol


def _heads(h, w, b, done0, steps, head=None):
    """`steps` head calls at columns 4, 5, ... on one state: the plain
    version, or K4 on `head`. -> (tokens of each step, seq, lps, done)."""
    from densecap_tpu_torch.ops import greedy_head as gh

    P, N = h.shape[0], w.shape[1]
    done = done0.clone()
    seq = torch.full((P, HEAD_T), -1, dtype=torch.int32, device=h.device)
    lps = torch.full((P, HEAD_T), 7.0, device=h.device)
    toks = []
    for t in range(4, 4 + steps):
        if head is None:
            tok = gh.greedy_head_plain(h, w, b, done, seq, lps, t, N)
        else:
            tok = gh.greedy_head_cuda(head, h, done, seq, lps, t, N)
        toks.append(tok.clone())
    return toks, seq, lps, done


@pytest.mark.parametrize("P, K, N", [
    (1, HEAD_K, HEAD_N), (50, HEAD_K, HEAD_N), (1000, HEAD_K, HEAD_N),
    (8000, HEAD_K, HEAD_N), (8001, HEAD_K, HEAD_N),
    (20000, HEAD_K, HEAD_N),   # more row blocks than SMs: S = 1
    (8000, 1024, HEAD_N),      # one warpgroup a block (G = 1)
    (800, 768, 30522),         # GRiT's text decoder: 800 rows, BERT's vocab
    (300, 64, 21),             # one vocab tile
    (300, 36, 500),            # K neither a chunk nor 8 floats
])
def test_greedy_head_matches_plain(dev, P, K, N):
    """K4 against the plain head, two steps on one state (the second
    launch finds the tickets the first left): tokens equal wherever the
    plain top-2 gap exceeds 1e-3, logprobs within 1e-4, done rows END and
    0, `done` raised where END won, only the step's columns written, one
    launch a step. At the model's widths and at the plan's other
    corners."""
    from densecap_tpu_torch.ops import greedy_head as gh

    h, w, b, done0 = _head_inputs(dev, P, seed=P, K=K, N=N)
    want = _heads(h, w, b, done0, 2)
    head = gh.prepare(w, b, P)
    build.reset_launches()
    got = _heads(h, w, b, done0, 2, head)
    torch.cuda.synchronize()
    assert build.launches == dict(NONE, greedy_head=2)
    clear = _clear_rows(h, w, b)
    assert clear.float().mean() > 0.9
    for tw, tg in zip(want[0], got[0]):
        assert tg.dtype == torch.int64
        assert torch.equal(tg[clear], tw[clear])
    _, seq_w, lps_w, done_w = want
    _, seq_g, lps_g, done_g = got
    assert torch.equal(seq_g[clear], seq_w[clear])
    assert (seq_g[:, :4] == -1).all() and (seq_g[:, 6:] == -1).all()
    assert (lps_g[:, :4] == 7).all() and (lps_g[:, 6:] == 7).all()
    assert float((lps_g - lps_w)[clear].abs().max()) <= 1e-4
    assert (seq_g[:, 4:6][done0] == N).all()
    assert (lps_g[:, 4:6][done0] == 0).all()
    assert torch.equal(done_g, done0 | (got[0][0] == N) | (got[0][1] == N))
    assert torch.equal(done_g[clear], done_w[clear])
    if P >= 1000:  # END won some rows that were not done
        assert (got[0][0][~done0] == N).any()


@pytest.mark.parametrize("P", [50, 8000])
@pytest.mark.parametrize("pair", [(5, 9), (100, 300), (10, 9990)])
def test_greedy_head_first_index_on_ties(dev, P, pair):
    """Two equal columns of W with equal biases, above every other score:
    every row takes the first, within a tile (5, 9), across tiles (100,
    300) and across vocab slices (10, 9990: slices of 39-40 tiles at
    P = 8000, one tile a slice at P = 50), and its logprob is the plain
    one."""
    from densecap_tpu_torch.ops import greedy_head as gh

    h, w, b, _ = _head_inputs(dev, P, seed=7)
    j1, j2 = pair
    w[:, j2] = w[:, j1]
    b[j1] = b[j2] = 50.0
    done0 = torch.zeros(P, dtype=torch.bool, device=dev)
    want = _heads(h, w, b, done0, 1)
    got = _heads(h, w, b, done0, 1, gh.prepare(w, b, P))
    assert (got[0][0] == j1 + 1).all()
    assert torch.equal(got[0][0], want[0][0])
    assert float((got[2] - want[2]).abs().max()) <= 1e-4


def test_greedy_decode_k4_against_the_plain_head(dev, monkeypatch):
    """A whole bf16 greedy decode at the model's widths (P = 1000, the
    CLIs at batch 1; END raised so that rows finish at different steps):
    K4's tokens equal those of the same decode whose heads are the plain
    version, row by row up to the first step where the plain top-2 gap is
    under 1e-3, logprobs within 1e-4 there; one launch a step run."""
    from densecap_tpu_torch.ops.linear import dot_f32
    from densecap_tpu_torch.ops import greedy_head as gh
    from test_torch_greedy_head import make_lm, vectors

    lm = make_lm(V=HEAD_N - 1, H=HEAD_K, D=4096, seed=11,
                 end_bias=5.0).to(dev)
    x = vectors(1000, 4096, 11).to(dev)
    assert lm.head_on_card(dev)
    build.reset_launches()
    with torch.no_grad():
        seq, lps = lm.greedy_decode(x, HEAD_T)
    torch.cuda.synchronize()
    is_end = seq == HEAD_N
    assert is_end.any(1).any() and not is_end[:, 0].all()
    first = torch.where(is_end.any(1), is_end.int().argmax(1), HEAD_T)
    steps = min(int(first.max()) + 1, HEAD_T)
    assert build.launches == dict(NONE, greedy_head=steps,
                                  lstm_cell=steps + 1)

    gaps = []

    def plain(state, h, done, seq, lps, t, end):
        top = (dot_f32(h, lm.proj.w, torch.bfloat16)
               + lm.proj.b).topk(2, dim=1).values
        gaps.append(top[:, 0] - top[:, 1])
        return gh.greedy_head_plain(h, lm.proj.w, lm.proj.b, done, seq, lps,
                                    t, end)

    monkeypatch.setattr(gh, "greedy_head_cuda", plain)
    with torch.no_grad():
        seq_p, lps_p = lm.greedy_decode(x, HEAD_T)
    gaps = torch.stack(gaps, 1)
    assert gaps.shape[1] == steps
    differ = seq != seq_p
    rows = differ.any(1)
    at = differ.int().argmax(1)
    assert float(rows.float().mean()) < 0.02
    assert (gaps[rows, at[rows]] <= 1e-3).all()
    cols = torch.arange(HEAD_T, device=dev)[None]
    same = cols < torch.where(rows, at, HEAD_T)[:, None]
    assert float((lps - lps_p).abs()[same].max()) <= 1e-4


# K5: the greedy decode's LSTM cell at the model's widths. Its sums are
# those of the plain cell in another order: one f32 sum over E + H = 1024
# bf16 products where the plain cell adds two sums of 512 and then the
# bias. Each |product| is under ~0.06 here (h, c in the LSTM's range, the
# embedding +-0.5, weights +-1/sqrt(H)), so a gate's rounding differs by
# at most ~1024 x 2^-24 x its sum of |products| (< 2e-4), and in practice
# by a few ulps of the gate; h and c follow through sigmoid and tanh, whose
# slopes are at most 1. CELL_TOL bounds |K5 - plain| on h and c.
CELL_TOL = 2e-5


def _cell_lm(dev, seed=11, end_bias=0.0, quant=False):
    from test_torch_greedy_head import make_lm

    return make_lm(V=HEAD_N - 1, H=HEAD_K, D=4096, seed=seed,
                   end_bias=end_bias, quant=quant).to(dev)


@pytest.mark.parametrize("P", [1, 50, 127, 1000, 8000])
@pytest.mark.parametrize("kind", ["token", "one_token", "image"])
def test_lstm_cell_matches_plain(dev, P, kind):
    """K5 against `embed` + `lstm_step` at H = 512: a token step from a
    random state (tokens 0..V+2, so the clamp at both ends is taken; or
    one token for every row, as a decode often has), and the image step
    from zero state. h and c within CELL_TOL, the bf16 state K5 keeps for
    the next step equal to bf16(h), one launch."""
    from densecap_tpu_torch.ops import lstm_cell as lc
    from test_torch_greedy_head import vectors

    lm = _cell_lm(dev)
    g = torch.Generator(device=dev).manual_seed(P)
    cell = lc.prepare(lm.embed_w, lm.Wx, lm.Wh, lm.b, P)
    with torch.no_grad():
        if kind != "image":
            h0 = torch.rand((P, HEAD_K), generator=g, device=dev) * 2 - 1
            c0 = (torch.rand((P, HEAD_K), generator=g, device=dev) * 2 - 1) * 3
            tok = torch.randint(0, HEAD_N + 2, (P,), generator=g, device=dev)
            if kind == "one_token":
                tok = torch.full_like(tok, 4321)
            lc.load_state(cell, h0, c0)
            want = lm.lstm_step(h0, c0, lm.embed(tok))
            build.reset_launches()
            got = lc.step(cell, tok=tok)
        else:
            x = lm.encode_image(vectors(P, 4096, P).to(dev))
            zeros = torch.zeros((P, HEAD_K), device=dev)
            want = lm.lstm_step(zeros, zeros, x)
            build.reset_launches()
            got = lc.step(cell, x=x)
    torch.cuda.synchronize()
    assert build.launches == dict(NONE, lstm_cell=1)
    assert got[0] is cell.h and got[1] is cell.c and cell.cur == 1
    for w, k in zip(want, got):
        assert float((w - k).abs().max()) <= CELL_TOL
    assert torch.equal(cell.hb[1], cell.h.bfloat16())


def test_lstm_cell_pads_an_odd_width(dev):
    """K5 at widths that are not multiples of 64 (E = 40, H = 67: padded
    K chunks, a part-filled column tile, an odd row stride), two steps in
    turns: h and c within CELL_TOL of the plain cell, the padded units of
    the bf16 state left zero."""
    from densecap_tpu_torch.ops import lstm_cell as lc
    from test_torch_greedy_head import make_lm

    P, H = 300, 67
    lm = make_lm(V=50, H=H, D=40, seed=5).to(dev)
    g = torch.Generator(device=dev).manual_seed(5)
    cell = lc.prepare(lm.embed_w, lm.Wx, lm.Wh, lm.b, P)
    h = torch.rand((P, H), generator=g, device=dev) * 2 - 1
    c = torch.rand((P, H), generator=g, device=dev) * 2 - 1
    lc.load_state(cell, h, c)
    with torch.no_grad():
        for t in range(2):
            tok = torch.randint(0, 53, (P,), generator=g, device=dev)
            h, c = lm.lstm_step(h, c, lm.embed(tok))
            got = lc.step(cell, tok=tok)
            torch.cuda.synchronize()
            assert float((got[0] - h).abs().max()) <= CELL_TOL
            assert float((got[1] - c).abs().max()) <= CELL_TOL
            h, c = got[0].clone(), got[1].clone()
    assert cell.hb.shape[2] == 128 and (cell.hb[:, :, H:] == 0).all()


def _plain_decode(lm, x, monkeypatch, one_product=False):
    """A greedy decode on the card with the plain cell, K4's heads
    recording the plain top-2 gap of each step; with `one_product`, the
    cell sums its gates in one bf16 product over [x | h] and [Wx ; Wh]
    (the order of K5's sums) instead of two. -> (seq, lps, gaps)."""
    from densecap_tpu_torch.ops.linear import dot_f32
    from densecap_tpu_torch.ops import greedy_head as gh

    gaps, k4 = [], gh.greedy_head_cuda

    def head(state, h, done, seq, lps, t, end):
        top = (dot_f32(h, lm.proj.w, torch.bfloat16)
               + lm.proj.b).topk(2, dim=1).values
        gaps.append(top[:, 0] - top[:, 1])
        return k4(state, h, done, seq, lps, t, end)

    W = torch.cat([lm.Wx, lm.Wh], 0)

    def one_product_step(h, c, xx):
        gates = dot_f32(torch.cat([xx, h], 1), W, torch.bfloat16) + lm.b
        i, f, o, g = gates.chunk(4, dim=-1)
        c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c2), c2

    with monkeypatch.context() as m:
        m.setattr(lm, "cell_on_card", lambda device: False)
        m.setattr(gh, "greedy_head_cuda", head)
        if one_product:
            m.setattr(lm, "lstm_step", one_product_step)
        with torch.no_grad():
            seq, lps = lm.greedy_decode(x, HEAD_T)
    return seq, lps, torch.stack(gaps, 1) if gaps else None


def _agree(a, b, gaps):
    """Rows where two decodes' tokens differ, each first at a step whose
    top-2 gap in `gaps` is under 1e-3, and the logprobs' differences on
    the steps before a row's first difference."""
    (seq_a, lps_a), (seq_b, lps_b) = a, b
    differ = seq_a != seq_b
    rows = differ.any(1)
    at = differ.int().argmax(1)
    assert float(rows.float().mean()) < 0.02
    if gaps is not None:
        assert (gaps[rows, at[rows]] <= 1e-3).all()
    cols = torch.arange(HEAD_T, device=seq_a.device)[None]
    same = cols < torch.where(rows, at, HEAD_T)[:, None]
    return (lps_a - lps_b).abs()[same]


def test_greedy_decode_k5_against_the_plain_cell(dev, monkeypatch):
    """A whole bf16 greedy decode at the model's widths (P = 1000, the
    CLIs at batch 1; END raised so that rows finish at different steps):
    K5's tokens equal those of the same decode with the plain cell, row by
    row up to the first step where the plain top-2 gap is under 1e-3; one
    K5 launch a step run, the image's included. Logprobs: h feeds the next
    step and K4 in bf16, so where K5's h and the plain h differ by an
    f32 reordering across a bf16 rounding edge, the operand moves by a
    bf16 step and the decode carries it on (up to ~3e-3 here). That is no
    more than the plain cell moves when its own gates are summed in
    another order (one product over [x | h] where it adds two): K5's
    logprobs stay within twice that control's largest difference, and the
    typical row within 1e-6."""
    from test_torch_greedy_head import vectors

    lm = _cell_lm(dev, end_bias=5.0)
    x = vectors(1000, 4096, 11).to(dev)
    assert lm.cell_on_card(dev) and lm.head_on_card(dev)
    build.reset_launches()
    with torch.no_grad():
        k5 = lm.greedy_decode(x, HEAD_T)
    torch.cuda.synchronize()
    is_end = k5[0] == HEAD_N
    assert is_end.any(1).any() and not is_end[:, 0].all()
    first = torch.where(is_end.any(1), is_end.int().argmax(1), HEAD_T)
    steps = min(int(first.max()) + 1, HEAD_T)
    assert build.launches == dict(NONE, greedy_head=steps,
                                  lstm_cell=steps + 1)
    *plain, gaps = _plain_decode(lm, x, monkeypatch)
    *other, _ = _plain_decode(lm, x, monkeypatch, one_product=True)
    assert gaps.shape[1] == steps
    got = _agree(k5, plain, gaps)
    control = _agree(other, plain, gaps)
    assert float(got.max()) <= 2 * float(control.max()) + 1e-5
    assert float(got.median()) <= 1e-6


def test_greedy_decode_k5_on_the_int8_path(dev, monkeypatch):
    """The int8 decode keeps the plain head (`QuantLinear`) and takes K5
    for its cell: K5 launches and K4 never; against the same decode with
    the plain cell, tokens equal on all but 2% of the rows and logprobs on
    the steps before a row's first difference within twice what the plain
    cell moves when its gates are summed in one product (the int8 head
    codes h by row, so a reordering that moves h across a rounding edge
    moves a code)."""
    from test_torch_greedy_head import vectors

    lm = _cell_lm(dev, end_bias=5.0, quant=True)
    x = vectors(1000, 4096, 11).to(dev)
    assert lm.cell_on_card(dev) and not lm.head_on_card(dev)
    build.reset_launches()
    with torch.no_grad():
        k5 = lm.greedy_decode(x, HEAD_T)
    torch.cuda.synchronize()
    assert build.launches["greedy_head"] == 0
    assert build.launches["lstm_cell"] >= 2
    build.reset_launches()
    *plain, _ = _plain_decode(lm, x, monkeypatch)
    *other, _ = _plain_decode(lm, x, monkeypatch, one_product=True)
    assert build.launches == NONE
    got = _agree(k5, plain, None)
    control = _agree(other, plain, None)
    assert float(got.max()) <= 2 * float(control.max()) + 1e-5
    assert float(got.median()) <= 2 * float(control.median()) + 1e-6


def _vit_block(window, C=768, heads=12, seed=3):
    """A ViTDet-B block with random weights (N(0, 0.02) matrices and
    relative-position tables, biases and LayerNorms off their init), in
    bf16 on the card."""
    from densecap_tpu_torch.models.vitdet import Attention, Block

    g = torch.Generator().manual_seed(seed)
    S = window or 64

    def n(*shape, std=0.02):
        return (torch.randn(shape, generator=g) * std).cuda()

    cd = torch.bfloat16
    attn = Attention((n(C, 3 * C).to(cd), n(3 * C, std=0.1)),
                     (n(C, C).to(cd), n(C, std=0.1)),
                     n(2 * S - 1, C // heads).to(cd),
                     n(2 * S - 1, C // heads).to(cd), heads, cd)
    return Block((1 + n(C, std=0.1), n(C, std=0.1)), attn,
                 (1 + n(C, std=0.1), n(C, std=0.1)),
                 (n(C, 4 * C).to(cd), n(4 * C, std=0.1)),
                 (n(4 * C, C).to(cd), n(C, std=0.1)), window, cd)


def _plain_block(blk, x):
    """The block in f32 with the logits written out, image by image (the
    plain path the fused one is held to): LN1, zero-padded windows, qkv,
    `(q d^-0.5) k^T + rel_h + rel_w` with q unscaled in the relative
    terms, softmax, `@ v`, projection, LN2 and the MLP."""
    import torch.nn.functional as F

    from densecap_tpu_torch.ops.vit_attention import rel_table

    a = blk.attn
    f = {k: v.float() for k, v in (("qkv_w", a.qkv_w), ("proj_w", a.proj_w),
                                  ("fc1_w", blk.fc1_w), ("fc2_w", blk.fc2_w),
                                  ("rel_h", a.rel_h), ("rel_w", a.rel_w))}
    out = []
    for xi in x.split(1):
        _, H, W, C = xi.shape
        h = F.layer_norm(xi, (C,), blk.norm1[0], blk.norm1[1], 1e-6)
        ws = blk.window or H
        Hp, Wp = H + (-H % ws), W + (-W % ws)
        h = F.pad(h, (0, 0, 0, Wp - W, 0, Hp - H)).reshape(
            Hp // ws, ws, Wp // ws, ws, C).transpose(1, 2).reshape(
                -1, ws * ws, C)
        qkv = h @ f["qkv_w"] + a.qkv_b
        nh = a.heads
        d = C // nh
        q, k, v = qkv.reshape(-1, ws * ws, 3, nh, d).permute(2, 0, 3, 1, 4)
        logits = (q * d ** -0.5) @ k.transpose(-1, -2)
        r = q.reshape(-1, nh, ws, ws, d)
        rh = torch.einsum("bnhwc,hkc->bnhwk", r, rel_table(f["rel_h"], ws))
        rw = torch.einsum("bnhwc,wkc->bnhwk", r, rel_table(f["rel_w"], ws))
        logits = (logits.reshape(-1, nh, ws, ws, ws, ws) + rh[..., None]
                  + rw[..., None, :]).reshape(logits.shape)
        o = (torch.softmax(logits, -1) @ v).transpose(1, 2).reshape(
            -1, ws * ws, C) @ f["proj_w"] + a.proj_b
        o = o.reshape(Hp // ws, Wp // ws, ws, ws, C).transpose(1, 2).reshape(
            1, Hp, Wp, C)[:, :H, :W]
        xi = xi + o
        m = F.layer_norm(xi, (C,), blk.norm2[0], blk.norm2[1], 1e-6)
        m = F.gelu(m @ f["fc1_w"] + blk.fc1_b) @ f["fc2_w"] + blk.fc2_b
        out.append(xi + m)
    return torch.cat(out)


@pytest.mark.parametrize("window", [0, 14], ids=["global", "windowed"])
def test_vitdet_block_matches_plain(dev, window):
    """One ViTDet-B block at the published shape (B=8, a 64 x 64 grid of
    768 wide tokens, 12 heads; windows of 14 padded from 64 to 70) through
    the fused attention in bf16, against the plain f32 path with the
    logits written out. Tolerance: bf16 operands put each product ~2^-9
    off, and the fused block's difference is the relative norm of a few
    of them; its attention holds no (heads x N x N) tensor, whose bf16
    size alone (3 GiB for the global block) the step's peak stays far
    below."""
    torch.backends.cuda.matmul.allow_tf32 = False
    blk = _vit_block(window)
    x = torch.randn(8, 64, 64, 768, device=dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        got = blk(x)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    assert extra < 8 * 12 * 64 ** 4 * 2 / 2, extra
    with torch.no_grad():
        ref = _plain_block(blk, x)
    err = float((got - ref).norm() / (ref - x).norm())
    assert err < 2e-2, err


def _vit_inputs(dev, N, hh, ww, heads=12, seed=0):
    """q, k, v as the qkv product leaves them ((N, L, 3, heads, 64) bf16,
    unbound: token-major views with the heads inside) and the two tables,
    all N(0, 0.5^2): logits of a few units, as in a trained block."""
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = (torch.randn((N, hh * ww, 3, heads, 64), generator=g, device=dev)
           * 0.5).bfloat16()
    q, k, v = qkv.unbind(2)
    rh, rw = ((torch.randn((2 * s - 1, 64), generator=g, device=dev) * 0.5)
              .bfloat16() for s in (hh, ww))
    return q, k, v, rh, rw


# K6 against the logits written out in f32 (relative norm of the
# difference): o is rounded to bf16 once (2^-9 of each element) and P
# rounded to bf16 for the P v product (2^-9 of each weight, averaging over
# the keys), each ~1.5e-3 of the output's norm; the old cuDNN fold sits
# at the same level.
VIT_ATTN_TOL = 5e-3


@pytest.mark.parametrize("N, hh, ww", [(4, 14, 14), (1, 64, 64), (1, 40, 48),
                                       (1, 23, 24)],
                         ids=["windowed", "global", "unaligned", "ragged"])
def test_vit_attention_matches_plain(dev, N, hh, ww):
    """K6 at the windowed shape (one-pass: 14 x 14, 12 heads), the global
    one (tiled: 64 x 64, 12 heads, B = 1, a key tile two grid rows), an
    unaligned grid (40 x 48: tiled, each key's row and column by general
    index arithmetic) and a ragged one (23 x 24: its last key tile part
    past L), against `vit_attention.plain`, within VIT_ATTN_TOL."""
    from densecap_tpu_torch.ops import vit_attention as va

    q, k, v, rh, rw = _vit_inputs(dev, N, hh, ww)
    got = va.attention(q, k, v, rh, rw, (hh, ww))
    ref = va.plain(q, k, v, rh, rw, (hh, ww))
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    err = float((got.float() - ref).norm() / ref.norm())
    assert err < VIT_ATTN_TOL, err


def test_vit_attention_core_is_a_view_and_counts_its_launch(dev):
    """`attention_core` returns K6's token-major output as the (N, heads,
    L, d) view it promises, so the block's merge of the heads copies
    nothing; the wrapper counts one launch and no other kernel's."""
    from densecap_tpu_torch.models.vitdet import attention_core

    q, k, v, rh, rw = _vit_inputs(dev, 2, 14, 14)
    build.reset_launches()
    o = attention_core(q, k, v, rh, rw, (14, 14), torch.bfloat16)
    assert build.launches == dict(NONE, vit_attention=1)
    assert o.shape == (2, 12, 196, 64)
    merged = o.transpose(1, 2).reshape(2, 14, 14, 768)
    assert merged.data_ptr() == o.data_ptr()
    assert merged._base is not None


@pytest.mark.parametrize("case", ["float32", "head32", "grid", "strides"])
def test_vit_attention_refuses_what_k6_does_not_take(dev, case):
    """f32 operands, a head size other than 64, a grid whose tables or
    relative terms pass K6's shared memory, and q, k, v with different
    strides raise on the card; nothing falls back."""
    from densecap_tpu_torch.ops import vit_attention as va

    hw = (14, 14)
    q, k, v, rh, rw = _vit_inputs(dev, 1, *hw)
    if case == "float32":
        q, k, v = q.float(), k.float(), v.float()
    elif case == "head32":
        q, k, v = q[..., :32], k[..., :32], v[..., :32]
        rh, rw = rh[:, :32], rw[:, :32]
    elif case == "grid":
        hw = (100, 100)
        q, k, v, rh, rw = _vit_inputs(dev, 1, *hw, heads=1)
    else:
        k = k.contiguous()
    build.reset_launches()
    with pytest.raises(ValueError):
        va.attention(q, k, v, rh, rw, hw)
    assert build.launches == NONE


# GRiT's text decoder: the steps replayed from CUDA graphs against the
# eager steps, at the decoder's full widths (6 layers of 768, 12 heads,
# FFN 3072, 30 522 classes) and the cell's 196 object tokens a row. The
# attention runs eagerly on both paths; cuDNN's, which SDPA picks at these
# shapes, does not repeat its output bit for bit from one call to the next
# (two eager decodes of one cache differ), so the paths are compared with
# SDPA's math backend.
TEXTDEC_T = 15


def _math_attention():
    from torch.nn.attention import SDPBackend, sdpa_kernel

    return sdpa_kernel(SDPBackend.MATH)


def _textdec(dev, seed=5, end_bias=0.0, dtype=torch.bfloat16):
    """A text decoder with weights from `seed` (BERT's N(0, 0.02), biases
    and LayerNorms off their init), `end_bias` added to END's bias."""
    from densecap_tpu_torch.config import DenseCapConfig
    from densecap_tpu_torch.models.textdec import Layer, TextDecoder
    from densecap_tpu_torch.ops.linear import Linear

    cfg = DenseCapConfig(trunk="vitdet_b", lm="grit_textdec",
                         vocab_size=30521, test_final_max_boxes=100,
                         compute_dtype=dtype)
    C, F, N, heads = 768, 3072, 30522, 12
    g = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape, std=0.02, dt=torch.float32):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dt)

    def linear(n_in, n_out):
        return normal(n_in, n_out, dt=dtype), normal(n_out)

    def ln():
        return normal(C, std=0.1) + 1, normal(C, std=0.1)

    layers = [Layer(linear(C, 3 * C), linear(C, C), ln(), linear(C, F),
                    linear(F, C), ln(), heads, dtype) for _ in range(6)]
    w, b = linear(C, N)
    b[-1] += end_bias
    return TextDecoder(cfg, linear(256, C), ln(), normal(N, C), normal(40, C),
                       ln(), layers, Linear(w, b))


def _prefix(dev, P, seed):
    """P // 100 images' (64, 64, 256) feature maps and 100 boxes each on
    their 1024 x 768 frames: the prefill's inputs."""
    B = P // 100
    g = torch.Generator(device=dev).manual_seed(seed)
    feats = torch.randn((B, 64, 64, 256), generator=g, device=dev)
    h = torch.full((B,), 768.0, device=dev)
    w = torch.full((B,), 1024.0, device=dev)
    xy = torch.rand((B, 100, 2), generator=g, device=dev) * torch.tensor(
        [900.0, 650.0], device=dev) + 60
    wh = torch.rand((B, 100, 2), generator=g, device=dev) * 300 + 16
    return feats, torch.cat([xy, wh], -1), h, w, feat_extent(h, w)


def _decode(dec, inputs, recorded=False):
    """prefill and greedy_decode under inference mode -> (seq, lps, cache,
    the decode span's counters, its `textdec.attn` spans)."""
    from densecap_tpu_torch.utils import profiling as prof

    since = prof.STORE.added
    was = prof.set_recording(recorded)
    try:
        with torch.inference_mode():
            with prof.span("test.decode"):
                cache = dec.prefill(*inputs, TEXTDEC_T)
                seq, lps = dec.greedy_decode(cache, TEXTDEC_T)
    finally:
        prof.set_recording(was)
    torch.cuda.synchronize()
    recs = list(prof.STORE.records)[len(prof.STORE.records)
                                    - (prof.STORE.added - since):]
    span = [r for r in recs if r.name == "textdec.decode"]
    counters = {k: c for k, (c, _) in (span[0].counters or {}).items()
                } if span else {}
    return seq, lps, cache, counters, sum(r.name == "textdec.attn"
                                          for r in recs)


def _eager(dec, cache):
    """greedy_decode over a copy of `cache` made before the decode wrote
    it: a cache that is not the decoder's own runs eagerly."""
    import copy

    plain = copy.copy(cache)
    plain.k, plain.v = cache.k.clone(), cache.v.clone()
    return plain


@pytest.mark.parametrize("P", [800, 100])
def test_textdec_graph_steps_equal_the_eager_steps(dev, P):
    """Over the decoder's own cache the steps replay graphs, captured in
    the first call: tokens and logprobs equal the eager steps' over a copy
    of the same cache bit for bit, in the capturing call and in the next;
    every step counted as a graph step, one attention span a layer a
    step."""
    dec = _textdec(dev)
    inputs = _prefix(dev, P, seed=P)
    with torch.inference_mode(), _math_attention():
        cache = dec.prefill(*inputs, TEXTDEC_T)
        plain = _eager(dec, cache)
        seq, lps = dec.greedy_decode(cache, TEXTDEC_T)
        seq_e, lps_e = dec.greedy_decode(plain, TEXTDEC_T)
    st = dec._graphs
    assert st is not None and st.cache is cache
    assert sorted(st.graphs) == list(range(TEXTDEC_T))
    assert torch.equal(seq, seq_e) and torch.equal(lps, lps_e)
    with _math_attention():
        seq2, lps2, cache2, counters, attn = _decode(dec, inputs,
                                                     recorded=True)
    assert cache2 is cache
    assert torch.equal(seq2, seq_e) and torch.equal(lps2, lps_e)
    assert counters["textdec.steps"] == TEXTDEC_T
    assert counters["textdec.graph_steps"] == TEXTDEC_T
    assert counters["decode.head_steps"] == TEXTDEC_T
    assert attn == 6 * TEXTDEC_T


def test_textdec_graph_outputs_survive_the_next_call(dev):
    """Two calls on different prefixes: the first call's outputs are the
    same after the second, which equals its own eager decode; a call on
    another stream runs eagerly, over a cache of its own, and agrees."""
    dec = _textdec(dev)
    first = _decode(dec, _prefix(dev, 800, seed=1))
    kept = first[0].clone(), first[1].clone()
    inputs = _prefix(dev, 800, seed=2)
    with torch.inference_mode(), _math_attention():
        cache = dec.prefill(*inputs, TEXTDEC_T)
        plain = _eager(dec, cache)
        seq, lps = dec.greedy_decode(cache, TEXTDEC_T)
        seq_e, lps_e = dec.greedy_decode(plain, TEXTDEC_T)
    assert torch.equal(first[0], kept[0]) and torch.equal(first[1], kept[1])
    assert not torch.equal(lps, kept[1])
    assert torch.equal(seq, seq_e) and torch.equal(lps, lps_e)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side), _math_attention():
        seq_s, lps_s, cache_s, counters, _ = _decode(dec, inputs,
                                                     recorded=True)
    assert cache_s is not cache and dec._graphs.cache is cache
    assert "textdec.graph_steps" not in counters
    assert torch.equal(seq_s, seq) and torch.equal(lps_s, lps)


def test_textdec_graph_steps_stop_where_the_eager_steps_stop(dev):
    """END's bias raised so that every row ends within a few steps (at
    these weights END's logit trails the best by 1.7-2.4 in 98% of the
    rows): the replayed loop stops after the same step as the eager one,
    every step it ran a graph step, with the same outputs."""
    from densecap_tpu_torch.utils import profiling as prof

    dec = _textdec(dev, end_bias=2.4)
    inputs = _prefix(dev, 800, seed=3)
    with torch.inference_mode(), _math_attention():
        plain = _eager(dec, dec.prefill(*inputs, TEXTDEC_T))
    with _math_attention():
        seq, lps, _, counters, attn = _decode(dec, inputs, recorded=True)
    was = prof.set_recording(True)
    since = prof.STORE.added
    try:
        with torch.inference_mode(), _math_attention():
            seq_e, lps_e = dec.greedy_decode(plain, TEXTDEC_T)
    finally:
        prof.set_recording(was)
    recs = list(prof.STORE.records)[len(prof.STORE.records)
                                    - (prof.STORE.added - since):]
    eager = [r for r in recs if r.name == "textdec.decode"][0].counters
    steps = counters["textdec.steps"]
    assert 1 < steps < TEXTDEC_T
    assert steps == eager["textdec.steps"][0]
    assert counters["textdec.graph_steps"] == steps
    assert "textdec.graph_steps" not in eager
    assert attn == 6 * steps
    assert bool((seq[:, steps - 1:] == 30522).all())
    assert torch.equal(seq, seq_e) and torch.equal(lps, lps_e)


@pytest.mark.parametrize("kind", ["shift", "fp8", "prefix_layer"])
def test_textdec_faults_change_the_graph_steps(dev, kind):
    """The benchmark control's faults (`benchmark/control_grit.py`),
    applied before the decoder is built, reach the replayed steps: each
    changes the tokens or the logprobs of the sound graph path."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "benchmark" / "control_grit.py"
    spec = importlib.util.spec_from_file_location("control_grit", path)
    control = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(control)
    inputs = _prefix(dev, 800, seed=4)
    seq, lps = _decode(_textdec(dev), inputs)[:2]
    with control.FAULTS[kind]():
        dec = _textdec(dev)
        seq_f, lps_f, cache, counters, _ = _decode(dec, inputs,
                                                   recorded=True)
    assert dec._graphs.cache is cache
    assert counters["textdec.graph_steps"] == TEXTDEC_T
    assert not (torch.equal(seq_f, seq) and torch.equal(lps_f, lps))


def test_textdec_f32_on_the_card_stays_eager(dev):
    """In f32 the head is not K4 and no step replays a graph."""
    dec = _textdec(dev, dtype=torch.float32)
    seq, lps, cache, counters, attn = _decode(dec, _prefix(dev, 100, seed=6),
                                              recorded=True)
    assert dec._graphs is None
    assert "textdec.graph_steps" not in counters
    assert "decode.head_steps" not in counters
    assert counters["textdec.steps"] == TEXTDEC_T == attn // 6
