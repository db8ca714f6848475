"""Card-side check of the PyTorch port: kernels, full-width engine, HTTP,
full-width training, evaluation and offline inference.

    python3 chip_smoke.py [--before DIR]

Needs one CUDA card and the CUDA toolkit (nvcc). Phases, each printing
its result on its own line; any failure raises and exits non-zero:

  1. device: the card's name and power limit;
  2. build: the kernels of densecap_tpu_torch/ops/cuda (one nvcc per
     source, in parallel); the count of HGMMA (wgmma) instructions in the
     SASS of K3's bf16 kernel, which must not be 0, and the global
     reductions of each K2b instance;
  3. K1 (NMS) against its plain PyTorch version at the serving shapes and
     at extract_features' (1000 unsorted -> 100 at 0.4), picks required
     identical; per shape the C launch alone ("kernel_ms": on inputs the
     wrapper prepared beforehand, 20 launches in a CUDA graph, so no host
     time), one call through the wrapper ("ms"), the
     plain version, the bound from this run's IoU tests and bytes, and
     the tiles walked in the longest image;
  4. K2 (RoI align) against its plain version at the inference shape
     (8 x 1000 boxes) and the training shape (8 x 384), max abs error
     <= 1e-5; the same times and bound as K1, and F.grid_sample on the
     same positions (within 1e-4 of plain) as the library call;
  5. K3 (fused conv+ReLU+mask+pool) at trunk1's conv1_2 and conv2_2
     shapes in bf16: its max abs error against an f32 oracle no more
     than 1.25x the plain version's; in f32 within rtol 1e-4 of plain;
     kernel and plain ms and TFLOP/s at both shapes; then trunk1's bf16
     forward at B = 8 (720 px canvas, 540x720 frames) with K3 and with
     cuDNN, printed only;
  6. K2b (RoI-align backward) at the training shape against plain
     autograd, in both instances (the positions alone, as while the
     trunk is frozen, and with d feats): d feats within 1e-5 and d boxes
     within 1e-4 of the reference gradient's largest entry; per instance
     the launch alone (20 in a CUDA graph), one backward through the
     wrapper, the plain version and the bound; grid_sample's backward as
     the library call, its d feats within 1e-5. With --before DIR (a
     checkout of an earlier commit, e.g. a git archive of the parent),
     that checkout's K2b is timed alone before and after this one's, by
     scripts/torch_k2b_alone.py in its own process;
  7. the full-width engine (VGG-16, fc 4096, vocab 10 000, 720 px canvas,
     1000 proposals, bf16, random weights from seed 0): 32 concurrent
     720x540 frames at batch 8, then frames at batch 1; K1 and K2 must
     launch on this path. A 720x10 frame (feature extent 0) is answered
     with no regions, as the JAX package answers it, at batch 1 and in a
     batch of 8, and the normal frames after and beside it as before. A
     small f32 model on the card is held against the same model on the
     CPU (plain ops) as the reference. Then, when PIL can encode JPEG,
     the same engine serves HTTP POSTs;
  8. training: one step of a small f32 model (K3 on, sampler pinned,
     dropout off) on the card against the CPU; then the flagship train
     step at full width (the engine's model, 384 RoIs per image, bf16,
     B = 8, K3 on): 6 steps with the trunk frozen, the finetune flip,
     2 more. Trunk1 must not move, trunk2 only after the flip; K2, K2b
     and K3 must launch, K2b's positions-only instance only before the
     flip and its d feats instance only after;
  9. evaluation: eval_split over 20 in-memory 540x720 / 720x540 frames
     with 1-30 captioned gt boxes each, at batch 8 (a tail of 4) and at
     batch 1 with the loss pass: images/s, the mAP dict, equal mAP
     within 1e-6, finite APs; then a small f32 model's mAP and detmap on
     the card against the CPU within 1e-6 (mAP > 0 there: its 20 words
     map to 5 strings, so captions meet references);
 10. beam search: forward_test_batch with a beam of 20 at batch 1 and 8
     (ms/call, peak memory), tokens in [1, V+1], each beam score the sum
     of its logprobs within 1e-3; a tiny f32 model card vs CPU at beams
     1, 3 and 5, tokens identical;
 11. extract_features at B = 8 (100 boxes at 0.4): ms/call, shapes,
     finite valid slots;
 12. the run_model CLI (--device cuda) on 8 JPEG frames and a full-width
     checkpoint .npz: results.json with 8 entries, boxes inside each
     frame, string captions.

Phases 7 (and its thin-frame part) and 9-12 each drive their path with
every launch count set to 0 just before and read just after; K1 and K2
must launch on each.

The last lines are a JSON object describing each kernel and
{"ok": true, "device": {...}}. Every kernel carries "ms", "plain_ms",
"bound_ms" with "bound_by" (bytes or operations, against the H100 SXM
data sheet's peaks) and "library_ms" with a "library_note": for K2 and
K2b one F.grid_sample call (and its backward) on K2's clamped sample
positions, held against the plain version; null for K1 and K3, which no
single PyTorch call computes. K1, K2 and K2b also give "kernel_ms"
(K2b: with d feats; both instances, with the earlier commit's times
under --before, in "modes"). K3's entry gives the sum of its two stages
in "ms" / "plain_ms" / "bound_ms" (its cost per trunk1 forward) and each
stage under "shapes".
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import ThreadingHTTPServer

from pathlib import Path

import numpy as np
import torch

from densecap_tpu_torch.config import DenseCapConfig
from densecap_tpu_torch.eval.eval_split import eval_split
from densecap_tpu_torch.models.vgg16 import TRUNK1_CFG, Trunk, feat_extent
from densecap_tpu_torch.ops import conv_pool as cp
from densecap_tpu_torch.ops import nms as nms_mod
from densecap_tpu_torch.ops import roi_align as roi_mod
from densecap_tpu_torch.ops.boxes import xcycwh_to_x1y1x2y2
from densecap_tpu_torch.ops.cuda import build
from densecap_tpu_torch.parallel.train_step import Trainer, batched_loss
from densecap_tpu_torch.serve.engine import InferenceEngine
from densecap_tpu_torch.serve.server import make_handler
from densecap_tpu_torch.utils.checkpoint import (from_torch, init_params,
                                                 save_params, to_torch)

ROOT = Path(__file__).resolve().parent
B = 8
# NVIDIA's H100 SXM data sheet: dense bf16 peak, f32 outside the tensor
# cores, HBM3 bandwidth. A kernel's bound_ms is the larger of its bytes
# (each input read once, each output written once) over HBM_BYTES_S and
# its operations over the peak of their type.
H100_BF16_TFLOPS = 989.0
H100_F32_TFLOPS = 67.0
HBM_BYTES_S = 3.35e12
NMS_OPS_PER_PAIR = 16    # f32 operations of one pascal IoU test
ROI_TOL = 1e-5
# grid_sample (K2's library call) takes positions normalised to [-1, 1]:
# the round trip rounds a position on a 45-cell map by ~1e-5 cells, which
# moves a sample by that much times a feature difference of a few units
ROI_LIBRARY_TOL = 1e-4
CONV_POOL_RATIO = 1.25   # K3 error vs f32 oracle, at most this x plain's
CONV_POOL_F32_RTOL = 1e-4
BWD_FEATS_TOL = 1e-5     # K2b, relative to the largest reference entry
BWD_BOXES_TOL = 1e-4
# the eight image sizes (h, w) of the K2 phase, on the 720 px canvas
IMG_H = (720, 540, 720, 480, 700, 720, 360, 720)
IMG_W = (540, 720, 720, 720, 500, 333, 720, 96)


def cuda_ms(fn, runs=10, warmup=2):
    """Median milliseconds of `fn()` over `runs` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, reps=20, runs=10):
    """Median milliseconds of one `fn()` on the card alone: `reps` calls
    captured in a CUDA graph and replayed between two CUDA events, so the
    host's time to launch them is out of the window."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, runs=runs) / reps


def bound_ms(nbytes, ops, tflops):
    """(least time on the card in ms, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / (tflops * 1e12) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nms_work(order, svalid, idx, valid, k):
    """What this run's data needs of greedy NMS: the IoU tests of every
    visited valid box against the boxes kept before it (summed over the
    images), and the 64-box tiles K1 walks in the longest image. A box is
    visited up to the max_out-th keep, or to N."""
    order, sv = order.cpu().numpy(), svalid.cpu().numpy().astype(bool)
    idx, valid = idx.cpu().numpy(), valid.cpu().numpy()
    pairs = tiles = 0
    for b in range(order.shape[0]):
        pos = np.empty(order.shape[1], np.int64)
        pos[order[b]] = np.arange(order.shape[1])
        kept_pos = pos[idx[b][valid[b]]]
        kept = np.zeros(order.shape[1], np.int64)
        kept[kept_pos] = 1
        visited = (int(kept_pos.max()) + 1 if len(kept_pos) == k
                   else order.shape[1])
        before = np.cumsum(kept) - kept
        pairs += int(before[:visited][sv[b, :visited]].sum())
        tiles = max(tiles, -(-visited // 64))
    return pairs, tiles


def random_boxes(rng, n, size=720.0, clustered=False):
    """(B, n, 4) xcycwh boxes on a size x size canvas."""
    if clustered:
        centres = rng.uniform(60, size - 60, (B, 12, 2))
        pick = rng.integers(0, 12, (B, n))
        xy = np.take_along_axis(centres, pick[..., None], 1)
        xy = xy + rng.normal(0, 4, (B, n, 2))
        wh = rng.uniform(40, 90, (B, n, 2))
    else:
        xy = rng.uniform(0, size, (B, n, 2))
        wh = rng.uniform(8, 300, (B, n, 2))
    return np.concatenate([xy, wh], -1).astype(np.float32)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check runs only "
                         "on the card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[device] {name} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | count {torch.cuda.device_count()}")
    print(f"[device] nvidia-smi: {smi}")
    return name, smi


def phase_build():
    build.load()
    print(f"[build] nvcc sm_90a kernels ready in {build.build_seconds:.2f} s "
          f"({build.library_path().name})")
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(build.library_path())],
                          check=True, capture_output=True, text=True).stdout
    counts = {}
    for fn in sass.split("Function : ")[1:]:
        name = fn.split("\n", 1)[0].strip()
        if "conv_pool_bf16_kernel" in name:
            counts["C=" + re.search(r"ILi(\d+)E", name).group(1)] = len(
                re.findall(r"\bHGMMA\.", fn))
    print(f"[build] K3 bf16 kernel SASS: HGMMA (wgmma) instructions {counts}")
    if len(counts) != 2 or not all(counts.values()):
        raise AssertionError(f"K3's bf16 kernel issues no wgmma: {counts}")
    # K2b's d feats scatter: the global reductions and atomics each
    # instance compiles to (float4 instance: one vector RED per column)
    reds = {}
    for fn in sass.split("Function : ")[1:]:
        name = fn.split("\n", 1)[0].strip()
        if "roi_align_bwd_kernel" in name:
            inst = (("float4" if "float4" in name else "float")
                    + (" + d feats" if "Lb1E" in name else ""))
            ops = re.findall(r"\b((?:RED|ATOM)G?\.[\w.]+)", fn)
            reds[inst] = {op: ops.count(op) for op in sorted(set(ops))}
    print(f"[build] K2b SASS global reductions per instance: {reds}")


def nms_cases():
    """K1's shapes: (name, xcycwh boxes, scores, valid, thresh, max_out,
    presorted) as numpy, B images each, from seed 1."""
    rng = np.random.default_rng(1)
    cases = []
    # RPN shape: 6000 presorted -> 1000 at 0.7, invalid tail and holes
    scores = np.sort(rng.uniform(0, 1, (B, 6000)).astype(np.float32))[:, ::-1]
    valid = np.ones((B, 6000), bool)
    valid[:, 5500:] = False
    valid[:, rng.integers(0, 5500, 300)] = False
    cases.append(("rpn 6000->1000 @0.7 presorted", random_boxes(rng, 6000),
                  scores.copy(), valid, 0.7, 1000, True))
    # final NMS shape: 1000 unsorted -> 1000 at 0.3
    cases.append(("final 1000->1000 @0.3", random_boxes(rng, 1000),
                  rng.normal(0, 3, (B, 1000)).astype(np.float32),
                  rng.uniform(0, 1, (B, 1000)) > 0.1, 0.3, 1000, False))
    # clustered boxes with tied scores: long suppression chains
    cases.append(("clustered 6000->1000 @0.7",
                  random_boxes(rng, 6000, clustered=True),
                  np.round(rng.uniform(0, 1, (B, 6000)), 2).astype(np.float32),
                  np.ones((B, 6000), bool), 0.7, 1000, False))
    # extract_features shape: 1000 unsorted -> 100 at 0.4, valid mask
    cases.append(("extract_features 1000->100 @0.4", random_boxes(rng, 1000),
                  rng.normal(0, 3, (B, 1000)).astype(np.float32),
                  rng.uniform(0, 1, (B, 1000)) > 0.1, 0.4, 100, False))
    return cases


def phase_nms(dev):
    cases = nms_cases()
    shapes, err = [], 0.0
    for name, bx, sc, va, thr, k, pre in cases:
        boxes = xcycwh_to_x1y1x2y2(torch.from_numpy(bx).to(dev))
        scores_t = torch.from_numpy(sc).to(dev)
        valid_t = torch.from_numpy(va).to(dev)

        def run(fn):
            return fn(boxes, scores_t, thr, k, valid=valid_t, presorted=pre)

        ki, kv = run(nms_mod.nms_cuda)
        pi, pv = run(nms_mod.nms_plain)
        torch.cuda.synchronize()
        same = bool(torch.equal(ki, pi) and torch.equal(kv, pv))
        err = max(err, float((ki - pi).abs().max()))
        kept = kv.sum(1).tolist()
        # the C launch alone, on inputs the wrapper prepared beforehand
        order, sboxes, svalid, keep, count = nms_mod.prepare_cuda(
            boxes, scores_t, k, valid=valid_t, presorted=pre)
        kern_ms = graph_ms(lambda: nms_mod.launch_cuda(sboxes, svalid, thr,
                                                       keep, count))
        k_ms = cuda_ms(lambda: run(nms_mod.nms_cuda))
        p_ms = cuda_ms(lambda: run(nms_mod.nms_plain))
        pairs, tiles = nms_work(order, svalid, pi, pv, k)
        n = bx.shape[1]
        b_ms, b_by = bound_ms(B * n * (16 + 1) + B * (k + 1) * 4,
                              pairs * NMS_OPS_PER_PAIR, H100_F32_TFLOPS)
        print(f"[K1 nms] {name}: identical={same} kept/img={kept} "
              f"kernel alone {kern_ms:.4f} ms, through the wrapper "
              f"{k_ms:.4f} ms, plain {p_ms:.3f} ms; bound {b_ms:.4f} ms "
              f"({b_by}: {pairs} IoU tests, {B * n * 17 / 1e6:.2f} MB in) "
              f"= {b_ms / kern_ms:.1%} of the kernel; tile chain {tiles} "
              f"tiles in the longest image, {kern_ms / tiles * 1e3:.2f} "
              f"us per tile")
        if not same:
            raise AssertionError(f"K1 picks differ from plain in {name}")
        shapes.append({"shape": f"B={B} {name}", "kernel_ms": kern_ms,
                       "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                       "bound_by": b_by, "iou_tests": pairs, "tiles": tiles})
    head = shapes[0]
    return {"max_abs_err": err, "kernel_ms": head["kernel_ms"],
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": None,
            "library_note": "no single PyTorch call computes greedy NMS "
                            "(torchvision, whose ops.nms would, is not "
                            "installed)",
            "shapes": shapes}


def roi_library(feats, yf, xf):
    """K2's function as one F.grid_sample call, on K2's prepared positions
    (`roi_align.prepare_cuda`) -> (call(x, grid), as_k2(out) giving its
    output as (B, K, out_h, out_w, C), the NCHW view x of `feats`, grid).
    The grid holds every box of an image, (B, K * out_h, out_w, 2) with
    align_corners=True; the positions are already clamped to each image's
    extent, so the taps are K2's (a tap one past the extent gets weight
    0)."""
    Bn, Hf, Wf, C = feats.shape
    out_h, out_w = yf.shape[1], xf.shape[1]
    K = yf.shape[0] // Bn
    gy = (yf * (2.0 / (Hf - 1)) - 1.0).reshape(Bn, K, out_h, 1)
    gx = (xf * (2.0 / (Wf - 1)) - 1.0).reshape(Bn, K, 1, out_w)
    grid = torch.stack(torch.broadcast_tensors(gx, gy), -1).reshape(
        Bn, K * out_h, out_w, 2)
    inp = feats.permute(0, 3, 1, 2)  # NCHW view of the channels-last map

    def call(x, g):
        return torch.nn.functional.grid_sample(
            x, g, mode="bilinear", padding_mode="zeros", align_corners=True)

    def as_k2(out):
        return out.reshape(Bn, C, K, out_h, out_w).permute(0, 2, 3, 4, 1)

    return call, as_k2, inp, grid


def roi_bytes(feats, rois, out_hw=(7, 7)):
    """K2's bytes: the feature map and the sample positions, box index and
    extents read once, the (rois, 7, 7, C) f32 output written once."""
    C = feats.shape[-1]
    return (feats.numel() * 4 + rois * (sum(out_hw) + 3) * 4
            + rois * out_hw[0] * out_hw[1] * C * 4)


def phase_roi(dev):
    """K2 at the inference shape (8 x 1000 boxes) and the training shape
    (8 x 384), on (8, 45, 45, 512) f32."""
    rng = np.random.default_rng(2)
    feats = torch.from_numpy(
        rng.standard_normal((B, 45, 45, 512), dtype=np.float32)).to(dev)
    img_h = torch.tensor(IMG_H, dtype=torch.float32, device=dev)
    img_w = torch.tensor(IMG_W, dtype=torch.float32, device=dev)
    fh, fw = feat_extent(img_h, img_w)
    shapes, err = [], 0.0
    for k in (1000, 384):
        bx = random_boxes(rng, k)
        bx[..., 2:] *= 1.5  # some boxes reach past the image edge
        boxes = torch.from_numpy(bx).to(dev)
        args = (feats, boxes, img_h, img_w, fh, fw, 7, 7)
        got = roi_mod.roi_align_cuda(*args)
        ref = roi_mod.roi_align_plain(*args)
        e = float((got - ref).abs().max())
        del got
        # the C launch alone, on inputs the wrapper prepared beforehand
        prep = roi_mod.prepare_cuda(*args)
        lib, as_k2, inp, grid = roi_library(feats, prep[0], prep[1])
        lib_e = float((as_k2(lib(inp, grid)) - ref).abs().max())
        del ref
        out = torch.empty((B * k, 7, 7, 512), device=dev)
        kern_ms = graph_ms(lambda: roi_mod.launch_fwd(feats, *prep, out))
        del out
        k_ms = cuda_ms(lambda: roi_mod.roi_align_cuda(*args))
        p_ms = cuda_ms(lambda: roi_mod.roi_align_plain(*args))
        l_ms = cuda_ms(lambda: lib(inp, grid))
        del grid
        nbytes = roi_bytes(feats, B * k)
        # 3 lerps of 4 operations per output element
        b_ms, b_by = bound_ms(nbytes, B * k * 49 * 512 * 12, H100_F32_TFLOPS)
        print(f"[K2 roi_align] {B}x{k} boxes on (8,45,45,512) f32: max_abs_err "
              f"{e:.3e} (tol {ROI_TOL}); kernel alone {kern_ms:.4f} ms "
              f"({nbytes / kern_ms / 1e9:.2f} TB/s), through the wrapper "
              f"{k_ms:.4f} ms, plain {p_ms:.3f} ms, grid_sample {l_ms:.4f} "
              f"ms (max abs err vs plain {lib_e:.3e}, tol {ROI_LIBRARY_TOL}); "
              f"bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.0f} MB) = "
              f"{b_ms / kern_ms:.1%} of the kernel")
        if not e <= ROI_TOL:
            raise AssertionError(f"K2 max abs error {e} > {ROI_TOL}")
        if not lib_e <= ROI_LIBRARY_TOL:
            raise AssertionError(f"grid_sample differs from plain K2 by "
                                 f"{lib_e} > {ROI_LIBRARY_TOL}")
        err = max(err, e)
        shapes.append({"shape": f"{B}x{k} boxes, (8,45,45,512) f32",
                       "kernel_ms": kern_ms, "ms": k_ms, "plain_ms": p_ms,
                       "library_ms": l_ms, "bound_ms": b_ms, "bound_by": b_by})
    head = shapes[0]
    return {"max_abs_err": err, "kernel_ms": head["kernel_ms"],
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "library_note": "F.grid_sample, align_corners=True, on K2's "
                            "clamped positions as one (B, K*7, 7, 2) grid; "
                            "NCHW output",
            "shapes": shapes}



def phase_conv_pool(dev):
    """K3 at trunk1's two fused stages, ragged extents."""
    g = torch.Generator(device=dev).manual_seed(5)
    worst, shapes = 0.0, []
    for name, C, S, div in (("conv1_2+pool1", 64, 720, 1),
                            ("conv2_2+pool2", 128, 360, 2)):
        eh = torch.floor(torch.tensor(IMG_H, device=dev) / div)
        ew = torch.floor(torch.tensor(IMG_W, device=dev) / div)
        x = torch.randn((B, C, S, S), generator=g, device=dev).abs()
        x = (x * cp.extent_mask(S, S, eh, ew, x.dtype)).contiguous(
            memory_format=torch.channels_last)
        w = torch.randn((C, C, 3, 3), generator=g, device=dev) * (
            2.0 / (9 * C)) ** 0.5
        b = torch.randn((C,), generator=g, device=dev) * 0.1
        with torch.no_grad():
            xb, wb, bb = x.bfloat16(), w.bfloat16(), b.bfloat16()
            oracle = cp.conv_relu_pool_plain(xb.float(), wb.float(),
                                             bb.float(), eh, ew)
            kb = cp.conv_relu_pool_cuda(xb, wb, bb, eh, ew).float()
            pb = cp.conv_relu_pool_plain(xb, wb, bb, eh, ew).float()
            k_err = float((kb - oracle).abs().max())
            p_err = float((pb - oracle).abs().max())
            kp_err = float((kb - pb).abs().max())
            equal = float((kb == pb).float().mean())
            del oracle, kb, pb
            kf = cp.conv_relu_pool_cuda(x, w, b, eh, ew)
            pf = cp.conv_relu_pool_plain(x, w, b, eh, ew)
            f32_ok = bool(torch.allclose(kf, pf, rtol=CONV_POOL_F32_RTOL,
                                         atol=CONV_POOL_F32_RTOL))
            f32_err = float((kf - pf).abs().max())
            del kf, pf
            k_ms = cuda_ms(lambda: cp.conv_relu_pool_cuda(xb, wb, bb, eh, ew))
            p_ms = cuda_ms(lambda: cp.conv_relu_pool_plain(xb, wb, bb, eh, ew))
        tflops = 2 * 9 * C * C * B * S * S / k_ms / 1e9
        # bf16 input and pooled output once, weights and bias once
        b_ms, b_by = bound_ms(
            (B * S * S * C + B * (S // 2) ** 2 * C + 9 * C * C + C) * 2,
            2 * 9 * C * C * B * S * S, H100_BF16_TFLOPS)
        print(f"[K3 conv_pool] {name} ({B},{S},{S},{C}) bf16: max abs err vs "
              f"f32 oracle kernel {k_err:.4e} plain {p_err:.4e} (ratio "
              f"{k_err / p_err:.3f}, limit {CONV_POOL_RATIO}); f32 kernel vs "
              f"plain max abs {f32_err:.3e} within rtol {CONV_POOL_F32_RTOL}="
              f"{f32_ok}; bf16 kernel vs plain max abs {kp_err:.4e}, "
              f"{equal:.5%} bit-equal; kernel {k_ms:.3f} ms = {tflops:.1f} "
              f"TFLOP/s ({tflops / H100_BF16_TFLOPS:.1%} of the bf16 peak), "
              f"plain {p_ms:.3f} ms; bound {b_ms:.4f} ms ({b_by}) = "
              f"{b_ms / k_ms:.1%} of the kernel")
        if not (k_err <= CONV_POOL_RATIO * p_err and f32_ok):
            raise AssertionError(f"K3 disagrees with plain at {name}")
        worst = max(worst, kp_err)
        shapes.append({"shape": f"{name} ({B},{S},{S},{C}) bf16",
                       "ms": k_ms, "plain_ms": p_ms, "tflops": tflops,
                       "bound_ms": b_ms, "bound_by": b_by})
    phase_trunk1(dev)
    return {"max_abs_err": worst, "ms": sum(s["ms"] for s in shapes),
            "plain_ms": sum(s["plain_ms"] for s in shapes),
            "bound_ms": sum(s["bound_ms"] for s in shapes),
            "bound_by": shapes[0]["bound_by"], "library_ms": None,
            "library_note": "no single PyTorch call computes it: cuDNN's "
                            "conv, the bias, ReLU, the extent mask and the "
                            "max pool are separate calls ([K3 trunk1] times "
                            "trunk1 that way)",
            "shapes": shapes}


def phase_trunk1(dev):
    """Trunk1's bf16 forward with K3 and with cuDNN, for the record."""
    g = torch.Generator(device=dev).manual_seed(8)
    convs, cin = {}, 3
    for item in TRUNK1_CFG:
        if item == "M":
            continue
        name, cout = item
        wt = torch.randn((cout, cin, 3, 3), generator=g, device=dev) * (
            2.0 / (9 * cin)) ** 0.5
        convs[name] = (wt.bfloat16().contiguous(
            memory_format=torch.channels_last),
            (torch.randn((cout,), generator=g, device=dev) * 0.1).bfloat16())
        cin = cout
    trunk = Trunk(TRUNK1_CFG, convs, torch.bfloat16)
    S, h, w = FLAGSHIP.image_size, 540, 720
    x = torch.zeros((B, 3, S, S), device=dev).contiguous(
        memory_format=torch.channels_last)
    x[:, :, :h, :w] = torch.randn((B, 3, h, w), generator=g, device=dev) * 50
    eh = torch.full((B,), float(h), device=dev)
    ew = torch.full((B,), float(w), device=dev)
    with torch.no_grad():
        diff = float((trunk(x, eh, ew, fuse=True)
                      - trunk(x, eh, ew)).abs().max())
        ms = [cuda_ms(lambda f=f: trunk(x, eh, ew, fuse=f))
              for f in (False, True, True, False)]
    print(f"[K3 trunk1] bf16 forward, B={B}, {S} px canvas, {h}x{w} frames: "
          f"with K3 {ms[1]:.3f} / {ms[2]:.3f} ms, with cuDNN conv + plain "
          f"pool {ms[0]:.3f} / {ms[3]:.3f} ms; outputs max abs diff "
          f"{diff:.3e}")


def k2b_before(parent):
    """K2b alone in the checkout `parent` (scripts/torch_k2b_alone.py in
    its own process, which builds that checkout's kernels): {mode: ms}."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "torch_k2b_alone.py"),
         "--repo", str(parent)], check=True, capture_output=True, text=True,
        timeout=600).stdout
    res = json.loads(out.strip().splitlines()[-1])
    print(f"[K2b before] {res['form']} in {parent}: alone "
          f"{res['kernel_ms']['frozen']:.4f} ms frozen, "
          f"{res['kernel_ms']['d_feats']:.4f} ms with d feats")
    return res["kernel_ms"]


def phase_roi_bwd(dev, before=None):
    """K2b at the training shape: 8 x 384 boxes on (8, 45, 45, 512). With
    `before` (a checkout of an earlier commit), that commit's K2b is timed
    alone too, before and after this one's."""
    before_ms = [k2b_before(before)] if before else []
    rng = np.random.default_rng(6)
    feats = torch.from_numpy(
        rng.standard_normal((B, 45, 45, 512), dtype=np.float32)).to(dev)
    img_h = torch.tensor(IMG_H, dtype=torch.float32, device=dev)
    img_w = torch.tensor(IMG_W, dtype=torch.float32, device=dev)
    fh, fw = feat_extent(img_h, img_w)
    bx = random_boxes(rng, 384)
    bx[..., 2:] *= 1.5
    boxes = torch.from_numpy(bx).to(dev)
    gout = torch.from_numpy(
        rng.standard_normal((B, 384, 7, 7, 512), dtype=np.float32)).to(dev)

    def graph(fn, feats_grad):
        f = feats.clone().requires_grad_(feats_grad)
        b = boxes.clone().requires_grad_()
        out = fn(f, b, img_h, img_w, fh, fw)
        inputs = [f, b] if feats_grad else [b]
        return lambda: torch.autograd.grad(out, inputs, gout,
                                           retain_graph=True)

    def library_graph():
        """grid_sample's backward to the map and the grid (roi_library):
        the same scatter as K2b's d feats; its grid gradient is per sample,
        and at a position clamped to the extent's last cell it takes the
        one-sided slope toward the next cell, where autodiff of the clamped
        taps gives 0, so only d feats is compared."""
        yf, xf = roi_mod.prepare_cuda(feats, boxes, img_h, img_w, fh, fw)[:2]
        lib, _, inp, grid = roi_library(feats, yf, xf)
        x = inp.detach().clone().requires_grad_()
        g = grid.requires_grad_()
        out = lib(x, g)
        gl = gout.permute(0, 4, 1, 2, 3).reshape(out.shape)
        return lambda: torch.autograd.grad(out, [x, g], gl, retain_graph=True)

    errs = {}
    for mode, feats_grad in (("frozen", False), ("d_feats", True)):
        kg = graph(roi_mod.roi_align_cuda, feats_grad)()
        pg = graph(roi_mod.roi_align_plain, True)()
        b_abs = float((kg[-1] - pg[1]).abs().max())
        errs[mode] = {"d_boxes": (b_abs, b_abs / float(pg[1].abs().max()))}
        if feats_grad:
            f_abs = float((kg[0] - pg[0]).abs().max())
            errs[mode]["d_feats"] = (f_abs, f_abs / float(pg[0].abs().max()))
            lib_bwd = library_graph()
            lf = lib_bwd()[0].permute(0, 2, 3, 1)
            lib_err = (float((lf - pg[0]).abs().max())
                       / float(pg[0].abs().max()))
            del lf
        del kg, pg
    # the launch alone, on the forward's prepared inputs: 20 in a graph
    prep = roi_mod.prepare_cuda(feats, boxes, img_h, img_w, fh, fw)
    g2 = gout.reshape(B * 384, 7, 7, 512)
    d_yf = torch.empty_like(prep[0])
    d_xf_rows = torch.empty((B * 384, 7, 7), device=dev)
    d_feats = torch.zeros_like(feats)
    kern_ms = {mode: graph_ms(lambda: roi_mod.launch_bwd(
        g2, feats, *prep, d_yf, d_xf_rows,
        d_feats if mode == "d_feats" else None))
        for mode in ("frozen", "d_feats")}
    del d_feats
    k_ms = cuda_ms(graph(roi_mod.roi_align_cuda, True))
    p_ms = cuda_ms(graph(roi_mod.roi_align_plain, True))
    l_ms = cuda_ms(lib_bwd)
    del lib_bwd
    kc_ms = cuda_ms(graph(roi_mod.roi_align_cuda, False))
    pc_ms = cuda_ms(graph(roi_mod.roi_align_plain, False))
    if before:
        before_ms.append(k2b_before(before))
    # g and the map read once, the position gradients (and d feats)
    # written once; per element of g ~16 f32 operations for the position
    # sums, ~24 with the four scatter weights and adds
    rois = B * 384
    small = rois * (14 + 3) * 4 + rois * 14 * 4
    bounds = {"frozen": bound_ms(gout.numel() * 4 + feats.numel() * 4 + small,
                                 gout.numel() * 16, H100_F32_TFLOPS),
              "d_feats": bound_ms(gout.numel() * 4 + 2 * feats.numel() * 4
                                  + small, gout.numel() * 24,
                                  H100_F32_TFLOPS)}
    f_err = errs["d_feats"]["d_feats"][1]
    b_err = max(e["d_boxes"][1] for e in errs.values())
    print(f"[K2b roi_align_bwd] 8x384 boxes on (8,45,45,512) f32: d feats "
          f"err {f_err:.3e} (tol {BWD_FEATS_TOL}), d boxes err {b_err:.3e} "
          f"(tol {BWD_BOXES_TOL}), relative to the largest plain entry")
    for mode, wrap_ms, plain_ms in (("frozen", kc_ms, pc_ms),
                                    ("d_feats", k_ms, p_ms)):
        b_ms, b_by = bounds[mode]
        print(f"[K2b roi_align_bwd] {mode}: kernel alone "
              f"{kern_ms[mode]:.4f} ms "
              f"({(gout.numel() * 4 + feats.numel() * 4) / kern_ms[mode] / 1e9:.2f}"
              f" TB/s of g and the map), through the wrapper {wrap_ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms; bound {b_ms:.4f} ms ({b_by}) = "
              f"{b_ms / kern_ms[mode]:.1%} of the kernel alone")
    print(f"[K2b roi_align_bwd] grid_sample's backward {l_ms:.3f} ms (d feats "
          f"err {lib_err:.3e}, tol {BWD_FEATS_TOL})")
    if not (f_err <= BWD_FEATS_TOL and b_err <= BWD_BOXES_TOL):
        raise AssertionError("K2b disagrees with plain autograd")
    if not lib_err <= BWD_FEATS_TOL:
        raise AssertionError("grid_sample's d feats differ from plain")
    return {"max_abs_err": max(v[0] for e in errs.values()
                               for v in e.values()),
            "kernel_ms": kern_ms["d_feats"], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bounds["d_feats"][0],
            "bound_by": bounds["d_feats"][1], "library_ms": l_ms,
            "library_note": "backward of F.grid_sample (align_corners=True, "
                            "K2's clamped positions as one grid per image) "
                            "to the map and the grid",
            "modes": {mode: {"kernel_ms": kern_ms[mode],
                             "ms": {"frozen": kc_ms, "d_feats": k_ms}[mode],
                             "plain_ms": {"frozen": pc_ms,
                                          "d_feats": p_ms}[mode],
                             "bound_ms": bounds[mode][0],
                             "bound_by": bounds[mode][1],
                             "before_kernel_ms": [b[mode] for b in before_ms]
                             or None}
                      for mode in ("frozen", "d_feats")}}


TINY_REF = DenseCapConfig(
    vocab_size=20, seq_length=4, image_size=96,
    anchors=((8, 8), (16, 16), (12, 24), (24, 12)),
    test_max_proposals=12, test_pre_nms_topk=64, rnn_size=32,
    rnn_encoding_size=32, fc_dim=64, rpn_num_filters=32,
    compute_dtype=torch.float32)


def tiny_card_vs_cpu(dev, use_beam=0):
    """A small f32 model's forward_test_batch on the card and on the CPU:
    (valid / num / captions identical, boxes max err, scores max err)."""
    params = init_params(TINY_REF, seed=3)
    rng = np.random.default_rng(3)
    ims = (rng.standard_normal((2, 96, 96, 3)) * 30).astype(np.float32)
    hs = np.array([96, 72], np.float32)
    ws = np.array([80, 96], np.float32)
    ims[0, :, 80:] = 0  # padding past each extent is zero, as normalized
    ims[1, 72:] = 0
    outs = []
    for d in (dev, torch.device("cpu")):
        m = to_torch(params, TINY_REF, d)
        o = m.forward_test_batch(torch.from_numpy(ims).to(d),
                                 torch.from_numpy(hs).to(d),
                                 torch.from_numpy(ws).to(d),
                                 use_beam=use_beam)
        outs.append({k: v.cpu() for k, v in o._asdict().items()})
    g, c = outs
    exact = all(torch.equal(g[k], c[k]) for k in ("valid", "num", "captions"))
    return (exact, float((g["boxes"] - c["boxes"]).abs().max()),
            float((g["scores"] - c["scores"]).abs().max()))


def phase_reference(dev):
    """A small f32 model on the card against the same model on the CPU."""
    exact, box_err, score_err = tiny_card_vs_cpu(dev)
    print(f"[reference] tiny f32 model, card vs CPU plain path: valid/num/"
          f"captions identical={exact} boxes max err {box_err:.2e} scores "
          f"max err {score_err:.2e}")
    if not (exact and box_err <= 1e-3 and score_err <= 1e-3):
        raise AssertionError("card path disagrees with the CPU reference")


def check_result(r, max_boxes):
    n = len(r["boxes"])
    assert n == len(r["scores"]) == len(r["captions"]) == len(r["ids"])
    assert n <= max_boxes
    assert np.isfinite(np.asarray(r["boxes"], np.float64)).all()
    assert np.isfinite(np.asarray(r["scores"], np.float64)).all()


FLAGSHIP = DenseCapConfig(vocab_size=10000, image_size=720,
                          test_max_proposals=1000, test_pre_nms_topk=6000)


def phase_engine(dev, params, cfg=FLAGSHIP, frame_hw=(540, 720)):
    vocab = {i: f"w{i}" for i in range(1, cfg.vocab_size + 1)}
    rng = np.random.default_rng(4)
    frames = [rng.integers(0, 256, (*frame_hw, 3), dtype=np.uint8)
              for _ in range(32)]

    # raw model output at full width: shapes and finite valid slots
    eng8 = InferenceEngine(params, cfg, vocab, device=dev, batch_size=8,
                           batch_window_ms=50.0)
    eng1 = InferenceEngine(params, cfg, vocab, device=dev, batch_size=1)
    try:
        eng8.warmup()
        eng1.warmup()
        with ThreadPoolExecutor(16) as ex:  # warm batches, not timed
            list(ex.map(lambda i: eng8.process_array(frames[i]), range(16)))

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(32) as ex:
            results = list(ex.map(
                lambda i: eng8.process_array(frames[i], stream_id=str(i)),
                range(32)))
        wall = time.perf_counter() - t0
        lat = []
        for f in frames[:6]:
            t1 = time.perf_counter()
            results.append(eng1.process_array(f))
            lat.append(time.perf_counter() - t1)
        launches = dict(build.launches)
        peak = torch.cuda.max_memory_allocated()
        for r in results:
            check_result(r, eng8.max_boxes)
        print(f"[engine] batch 8: 32 concurrent frames in {wall:.3f} s = "
              f"{32 / wall:.2f} images/s")
        print(f"[engine] batch 1: p50 request latency "
              f"{statistics.median(lat[1:]) * 1e3:.1f} ms over "
              f"{len(lat) - 1} frames")
        print(f"[engine] peak device memory {peak / 2**30:.2f} GiB; "
              f"kernel launches on this path {launches}; "
              f"boxes/frame {[len(r['boxes']) for r in results[:4]]}")
        if not (launches["nms"] > 0 and launches["roi_align"] > 0):
            raise AssertionError(f"a kernel never launched: {launches}")

        with torch.inference_mode():
            S = cfg.image_size
            a, b = frame_hw
            x = torch.zeros((2, S, S, 3), device=dev)
            h = torch.tensor([float(b), float(a)], device=dev)
            w = torch.tensor([float(a), float(b)], device=dev)
            x[0, :b, :a] = torch.randn((b, a, 3), device=dev) * 50
            x[1, :a, :b] = torch.randn((a, b, 3), device=dev) * 50
            o = eng8.model.forward_test_batch(x, h, w)
        K, T = cfg.test_max_proposals, cfg.seq_length
        assert o.boxes.shape == (2, K, 4) and o.captions.shape == (2, K, T)
        assert o.scores.shape == o.valid.shape == (2, K)
        v = o.valid
        assert bool(torch.isfinite(o.scores[v]).all())
        assert bool(torch.isfinite(o.boxes[v]).all())
        print(f"[engine] raw output shapes ok, valid per image "
              f"{o.num.tolist()}, finite on valid slots")
        phase_thin(eng8, eng1, frames, results[32])
        phase_http(eng8, frames)
    finally:
        eng8.close()
        eng1.close()
    return launches


EMPTY = {"boxes": [], "scores": [], "captions": [], "ids": []}


def phase_thin(eng8, eng1, frames, ref):
    """A 720x10 frame (feature extent 0: no anchor is valid) is answered
    with no regions, as the JAX package answers it, at batch 1 and inside
    a batch of 8; the next normal frame is answered as before (`ref`:
    eng1's answer to frames[0]), so the card's context is intact."""
    thin = np.random.default_rng(12).integers(0, 256, (720, 10, 3),
                                              dtype=np.uint8)

    def drive():
        alone = eng1.process_array(thin, stream_id="thin")
        again = eng1.process_array(frames[0], stream_id="again")
        with ThreadPoolExecutor(8) as ex:
            batch = list(ex.map(
                lambda i: eng8.process_array(thin if i == 3 else frames[i],
                                             stream_id=f"mix{i}"), range(8)))
        return alone, again, batch

    (alone, again, batch), counts = read_launches(drive)
    same = (again["captions"] == ref["captions"]
            and np.allclose(again["boxes"], ref["boxes"], rtol=1e-5,
                            atol=1e-3)
            and np.allclose(again["scores"], ref["scores"], rtol=1e-5,
                            atol=1e-5))
    print(f"[thin] 720x10 frame at batch 1: {alone}; in a batch of 8: "
          f"{batch[3]}; boxes per frame of that batch "
          f"{[len(r['boxes']) for r in batch]}; frames[0] after it answered "
          f"as before={same}; launches {counts}")
    need_launches(counts, ("nms", "roi_align"), "thin-frame")
    for r in [again] + batch:
        check_result(r, eng8.max_boxes)
    if not (alone == EMPTY and batch[3] == EMPTY and same
            and all(len(r["boxes"]) for i, r in enumerate(batch) if i != 3)):
        raise AssertionError("a thin frame was not answered as the JAX "
                             "package answers it")


TINY_TRAIN = DenseCapConfig(
    vocab_size=20, seq_length=4, image_size=96,
    anchors=((8, 8), (16, 16), (12, 24), (24, 12)), rnn_size=32,
    rnn_encoding_size=32, fc_dim=64, rpn_num_filters=32,
    sampler_batch_size=16, max_gt_boxes=6, drop_prob=0.0,
    fuse_conv_pool=True, compute_dtype=torch.float32)


def make_train_batch(rng, cfg, n, hw, max_boxes):
    """n uint8 canvases with (h, w) frames at the top left, 1..max_boxes
    gt boxes inside each frame and captions of 1..seq_length tokens."""
    S, G, T, V = (cfg.image_size, cfg.max_gt_boxes, cfg.seq_length,
                  cfg.vocab_size)
    h, w = hw
    images = np.zeros((n, S, S, 3), np.uint8)
    images[:, :h, :w] = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    bw = rng.uniform(16, w / 2, (n, G))
    bh = rng.uniform(16, h / 2, (n, G))
    xc = rng.uniform(bw / 2 + 1, w - bw / 2)
    yc = rng.uniform(bh / 2 + 1, h - bh / 2)
    lengths = rng.integers(1, T + 1, (n, G))
    labels = rng.integers(1, V + 1, (n, G, T))
    labels[np.arange(T)[None, None] >= lengths[..., None]] = 0
    return {
        "image": torch.from_numpy(images),
        "height": torch.full((n,), float(h)),
        "width": torch.full((n,), float(w)),
        "gt_boxes": torch.from_numpy(
            np.stack([xc, yc, bw, bh], -1).astype(np.float32)),
        "gt_labels": torch.from_numpy(labels),
        "gt_valid": torch.from_numpy(
            np.arange(G)[None] < rng.integers(1, max_boxes + 1, (n, 1))),
    }


def to_dev(batch, dev):
    return {k: v.to(dev) for k, v in batch.items()}


def phase_train_reference(dev, lr=1e-3):
    """One train step of a small f32 model (K3 on, sampler pinned by
    ordinals, dropout off) on the card against the CPU's plain path."""
    cfg = TINY_TRAIN
    params = init_params(cfg, seed=3)
    rng = np.random.default_rng(3)
    batch = make_train_batch(rng, cfg, 2, (72, 96), 6)
    batch["height"] = torch.tensor([72.0, 96.0])
    batch["width"] = torch.tensor([96.0, 80.0])
    dbg = {"pos": torch.from_numpy(rng.permutation(8)),
           "neg": torch.from_numpy(rng.permutation(16))}
    runs = []
    for d in (dev, torch.device("cpu")):
        model = to_torch(params, cfg, d, train=True)
        trainer = Trainer(model, learning_rate=lr)
        losses = trainer.step(to_dev(batch, d), debug_sampler=to_dev(dbg, d))
        runs.append(({k: float(v) for k, v in losses.items()},
                     {n: (p.detach().cpu(), p.grad.cpu())
                      for n, p in model.named_parameters()
                      if p.grad is not None},
                     from_torch(model)))
    (lg, pg, tg), (lc, pc, tc) = runs
    loss_err = max(abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-6) for k in lc)
    # Adam's first update is about -lr * sign(g): entries with |g| near
    # eps may differ by up to 2 lr; where |g| is large they agree closely
    worst_all = worst_big = 0.0
    for n, (p_cpu, g_cpu) in pc.items():
        diff = (pg[n][0] - p_cpu).abs()
        big = g_cpu.abs() > 1e-3 * g_cpu.abs().max()
        worst_all = max(worst_all, float(diff.max()))
        worst_big = max(worst_big, float(diff[big].max()) if big.any() else 0)
    same_trunk1 = all(np.array_equal(tg["trunk1"][k]["w"], tc["trunk1"][k]["w"])
                      for k in tc["trunk1"])
    print(f"[train reference] tiny f32 model, K3 on, one step card vs CPU: "
          f"losses max rel err {loss_err:.2e} (tol 1e-4), total "
          f"{lg['total_loss']:.6f} vs {lc['total_loss']:.6f}; updated params "
          f"max diff {worst_all:.2e} (bound 2 lr = {2 * lr:.0e}), where |g| is "
          f"large {worst_big:.2e} (bound {1e-3 * lr + 1e-6:.1e}); trunk1 "
          f"unchanged on both={same_trunk1}")
    if not (loss_err <= 1e-4 and worst_all <= 2 * lr + 1e-6
            and worst_big <= 1e-3 * lr + 1e-6 and same_trunk1):
        raise AssertionError("the card's train step disagrees with the CPU")


def phase_train(dev, params, frozen_steps=6, finetune_steps=2):
    """The flagship train step at full width, bf16, B = 8, K3 on."""
    cfg = FLAGSHIP.replace(fuse_conv_pool=True)
    rng = np.random.default_rng(7)
    batches = [to_dev(make_train_batch(rng, cfg, B, (540, 720), 30), dev)
               for _ in range(frozen_steps + finetune_steps)]
    model = to_torch(params, cfg, dev, train=True)
    trainer = Trainer(model, learning_rate=1e-5)
    gen = torch.Generator(device=dev).manual_seed(0)

    def snapshot(prefix):
        return {n: p.detach().clone() for n, p in model.named_parameters()
                if n.startswith(prefix)}

    trunk1, trunk2 = snapshot("trunk1."), snapshot("trunk2.")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    times, totals = [], []
    for i, batch in enumerate(batches):
        if i == frozen_steps:
            frozen_launches = dict(build.launches)
            trunk2_still = all(torch.equal(p, trunk2[n])
                               for n, p in snapshot("trunk2.").items())
            trainer.set_finetune(True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses = trainer.step(batch, generator=gen)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        totals.append(float(losses["total_loss"]))
        print(f"[train] step {i + 1} ({'finetune' if i >= frozen_steps else 'frozen'}): "
              f"total_loss {totals[-1]:.4f} captioning "
              f"{float(losses['captioning_loss']):.4f} num_pos "
              f"{float(losses['stats/num_pos']):.1f} | {times[-1]:.1f} ms")
    launches = dict(build.launches)
    peak = torch.cuda.max_memory_allocated()
    trunk1_same = all(torch.equal(p, trunk1[n])
                      for n, p in snapshot("trunk1.").items())
    trunk2_moved = all(not torch.equal(p, trunk2[n])
                       for n, p in snapshot("trunk2.").items())
    frozen_ms = statistics.median(times[1:frozen_steps])
    finetune_ms = statistics.median(times[frozen_steps + 1:]
                                    or times[frozen_steps:])
    print(f"[train] flagship B={B} 720 px canvas, 540x720 frames, 384 RoIs "
          f"per image, bf16, K3 on: ms/step median frozen trunk "
          f"{frozen_ms:.1f} (steps 2-{frozen_steps}), after the flip "
          f"{finetune_ms:.1f}; {B * 1000 / frozen_ms:.2f} images/s frozen; "
          f"peak device memory {peak / 2**30:.2f} GiB")
    print(f"[train] kernel launches: frozen phase {frozen_launches}, "
          f"whole run {launches}; trunk1 unchanged={trunk1_same}, trunk2 "
          f"unchanged before the flip={trunk2_still}, moved after={trunk2_moved}")
    if not all(np.isfinite(totals)):
        raise AssertionError(f"non-finite training loss: {totals}")
    if not (trunk1_same and trunk2_still and trunk2_moved):
        raise AssertionError("the zones did not hold")
    # K2b: the positions-only instance while the trunk is frozen, the one
    # with d feats after the flip, one launch per backward either way
    if not (frozen_launches["roi_align_bwd"] > 0
            and frozen_launches["roi_align_bwd_feats"] == 0
            and launches["roi_align_bwd"] == frozen_launches["roi_align_bwd"]
            and all(launches[k] > 0 for k in
                    ("conv_pool", "roi_align", "roi_align_bwd_feats"))):
        raise AssertionError(f"a kernel of the train path misbehaved: "
                             f"{frozen_launches} -> {launches}")
    return launches


def phase_http(engine, frames):
    try:
        from PIL import Image
    except ImportError:
        print("[http] skipped: no JPEG codec (PIL is not installed)")
        return
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(engine))
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        for i, f in enumerate(frames[:3]):
            buf = io.BytesIO()
            Image.fromarray(f).save(buf, format="JPEG")
            payload = json.dumps({
                "image": "data:image/jpeg;base64,"
                         + base64.b64encode(buf.getvalue()).decode(),
                "stream": f"http{i}"}).encode()
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/api/infer", data=payload,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as resp:
                assert resp.status == 200
                check_result(json.loads(resp.read()), engine.max_boxes)
        print(f"[http] ran: 3 base64 JPEG POSTs answered 200 on port {port}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)


class MemoryLoader:
    """The split API of the port's DenseCapLoader over examples held in
    memory (the card machine has no h5py). Every split is the one list."""

    def __init__(self, examples, vocab):
        self.examples = examples
        self.vocab = vocab
        self.pos = 0

    def idx_to_token(self):
        return self.vocab

    def reset_iterator(self, split):
        self.pos = 0

    def split_size(self, split):
        return len(self.examples)

    def get_example(self, split=1, iterate=True):
        ex = self.examples[self.pos]
        self.pos = (self.pos + 1) % len(self.examples)
        return ex


def eval_examples(cfg, n=20):
    """n uint8 canvases of landscape and portrait 3:4 frames (540x720 and
    720x540 at 720 px; alternating) with 1-30 gt boxes and captions each,
    from a seed, as loader examples."""
    rng = np.random.default_rng(9)
    S = cfg.image_size
    halves = [make_train_batch(rng, cfg, n // 2, hw, 30)
              for hw in ((S * 3 // 4, S), (S, S * 3 // 4))]
    examples = []
    for i in range(n):
        batch, j = halves[i % 2], i // 2
        ex = {k: v[j].numpy() for k, v in batch.items()}
        ex.update(ix=i, filename=f"frame{i}.jpg", split_pos=(i, n))
        examples.append(ex)
    return examples


def read_launches(fn):
    """Run fn() with every launch count set to 0 first; (result, counts)."""
    torch.cuda.synchronize()
    build.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(build.launches)


def need_launches(counts, names, path):
    if not all(counts[k] > 0 for k in names):
        raise AssertionError(f"a kernel of the {path} path never launched: "
                             f"{counts}")


def phase_eval(dev, model, vocab):
    """eval_split over 20 in-memory frames: at batch 8 (a tail of 4) and
    at batch 1 with the training-loss pass."""
    loader = MemoryLoader(eval_examples(model.cfg), vocab)
    runs = {}
    for bs in (8, 1):
        t0 = time.perf_counter()
        res, counts = read_launches(lambda: eval_split(
            model, loader, split=1, batch_size=bs, verbose=False,
            compute_losses=bs == 1))
        wall = time.perf_counter() - t0
        ap = res["ap_results"]
        runs[bs] = ap
        aps = list(ap["ap_breakdown"].values()) + list(
            ap["det_breakdown"].values())
        loss = res["loss_results"].get("total_loss")
        print(f"[eval] batch {bs}: {loader.split_size(1)} frames in "
              f"{wall:.3f} s = {loader.split_size(1) / wall:.2f} images/s "
              f"(host clock, evaluator included"
              f"{', loss pass on' if bs == 1 else ''}); map {ap['map']:.6g} "
              f"detmap {ap['detmap']:.6g} score_method {ap['score_method']}"
              f"{f' val total_loss {loss:.4f}' if loss is not None else ''}; "
              f"launches {counts}")
        need_launches(counts, ("nms", "roi_align"), "eval")
        if not (np.isfinite(aps).all() and (loss is None
                                             or np.isfinite(loss))):
            raise AssertionError(f"non-finite eval result at batch {bs}")
    print(f"[eval] mAP batch 8 vs batch 1: {runs[8]['map']:.9g} vs "
          f"{runs[1]['map']:.9g}; detmap {runs[8]['detmap']:.9g} vs "
          f"{runs[1]['detmap']:.9g}")
    if abs(runs[8]["map"] - runs[1]["map"]) > 1e-6:
        raise AssertionError("batch-8 and batch-1 eval disagree on mAP")
    # random full-width captions never meet a reference (mAP 0), so a
    # small f32 model with a 20-word vocabulary and anchors the size of
    # the gt boxes checks mAP card vs CPU
    cfg = TINY_REF.replace(max_gt_boxes=8, test_max_proposals=50, anchors=(
        (24, 24), (40, 40), (32, 48), (48, 32)))
    tiny = MemoryLoader(eval_examples(cfg, n=8), {
        i: f"w{i % 5}" for i in range(1, cfg.vocab_size + 1)})
    aps = [eval_split(to_torch(init_params(cfg, seed=3), cfg, d), tiny,
                      batch_size=4, verbose=False)["ap_results"]
           for d in (dev, torch.device("cpu"))]
    print(f"[eval reference] tiny f32 model, 8 frames at batch 4, card vs "
          f"CPU: map {aps[0]['map']:.9g} vs {aps[1]['map']:.9g}, detmap "
          f"{aps[0]['detmap']:.9g} vs {aps[1]['detmap']:.9g}")
    if not (aps[1]["map"] > 0 and all(
            abs(aps[0][k] - aps[1][k]) <= 1e-6 for k in ("map", "detmap"))):
        raise AssertionError("the card's eval disagrees with the CPU")
    return counts


def canvases(dev, n, S):
    """n normalized S px canvases holding landscape and portrait 3:4
    frames (alternating), and their extents."""
    g = torch.Generator(device=dev).manual_seed(10)
    x = torch.zeros((n, S, S, 3), device=dev)
    h = torch.tensor([S * 3 // 4, S] * (n // 2) + [S * 3 // 4] * (n % 2),
                     dtype=torch.float32, device=dev)
    w = S * 3 // 4 + S - h
    for i in range(n):
        a, b = int(h[i]), int(w[i])
        x[i, :a, :b] = torch.randn((a, b, 3), generator=g, device=dev) * 50
    return x, h, w


def phase_beam(dev, model):
    """forward_test_batch with a beam of 20 at batch 1 and 8; the beam
    scores against their logprob sums; a tiny f32 model card vs CPU."""
    V, T = model.cfg.vocab_size, model.cfg.seq_length
    x, h, w = canvases(dev, B, model.cfg.image_size)
    launches = None
    for n in (1, B):
        args = (x[:n], h[:n], w[:n])
        torch.cuda.reset_peak_memory_stats()
        out, counts = read_launches(
            lambda: model.forward_test_batch(*args, use_beam=20))
        if launches is None:
            launches = counts
        ms = cuda_ms(lambda: model.forward_test_batch(*args, use_beam=20),
                     runs=3, warmup=1)
        peak = torch.cuda.max_memory_allocated()
        caps = out.captions
        in_range = bool(((caps >= 1) & (caps <= V + 1)).all())
        print(f"[beam] beam 20, batch {n} ({model.cfg.test_max_proposals} "
              f"proposals, vocab {V}, {T} steps): {ms:.1f} ms/call (CUDA "
              f"events, median of 3 after 1 warm-up), peak device memory "
              f"{peak / 2**30:.2f} GiB; tokens in [1, V+1]={in_range}; "
              f"launches {counts}")
        if not in_range:
            raise AssertionError("beam search emitted a token out of range")
    need_launches(launches, ("nms", "roi_align"), "beam")
    # the winning beam's score is the sum of its per-step logprobs
    _, codes, _ = model.extract_features(x[:1], h[:1], w[:1])
    with torch.inference_mode():
        _, lps, score = model.lm.beamsearch(codes[0], T, 20)
    gap = float((lps.sum(1) - score).abs().max())
    print(f"[beam] 100 regions: max |sum(logprobs) - beam score| {gap:.2e} "
          f"(tol 1e-3), scores {float(score.min()):.2f} to "
          f"{float(score.max()):.2f}")
    if not gap <= 1e-3:
        raise AssertionError("beam logprobs do not sum to the beam score")
    for beam in (1, 3, 5):
        exact, box_err, score_err = tiny_card_vs_cpu(dev, use_beam=beam)
        print(f"[beam reference] tiny f32 model, beam {beam}, card vs CPU: "
              f"valid/num/captions identical={exact} boxes max err "
              f"{box_err:.2e} scores max err {score_err:.2e}")
        if not (exact and box_err <= 1e-3 and score_err <= 1e-3):
            raise AssertionError(f"beam {beam}: card disagrees with the CPU")
    return launches


def phase_extract(dev, model):
    """extract_features at B = 8, full width: 100 boxes at 0.4."""
    x, h, w = canvases(dev, B, model.cfg.image_size)
    (boxes, codes, valid), counts = read_launches(
        lambda: model.extract_features(x, h, w))
    ms = cuda_ms(lambda: model.extract_features(x, h, w))
    ok = (boxes.shape == (B, 100, 4)
          and codes.shape == (B, 100, model.cfg.fc_dim)
          and valid.shape == (B, 100)
          and bool(torch.isfinite(boxes[valid]).all())
          and bool(torch.isfinite(codes[valid]).all())
          and bool((valid.sum(1) <= 100).all()))
    print(f"[extract_features] B={B}, 100 boxes @0.4: {ms:.3f} ms/call (CUDA "
          f"events, median of 10); valid per image {valid.sum(1).tolist()}; "
          f"shapes and finite valid slots ok={ok}; launches {counts}")
    need_launches(counts, ("nms", "roi_align"), "extract_features")
    if not ok:
        raise AssertionError("extract_features output is malformed")
    return counts


def phase_run_model(dev, params, vocab):
    """The run_model CLI on 8 JPEG frames and a full-width checkpoint."""
    from PIL import Image

    from densecap_tpu_torch.cli import run_model

    sizes = [(540, 720), (720, 540), (480, 640), (600, 800)] * 2
    rng = np.random.default_rng(11)
    work = ROOT / "build"
    work.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        tmp = Path(tmp)
        (tmp / "frames").mkdir()
        for i, (fh, fw) in enumerate(sizes):
            Image.fromarray(rng.integers(0, 256, (fh, fw, 3), dtype=np.uint8)
                            ).save(tmp / "frames" / f"f{i}.jpg")
        t0 = time.perf_counter()
        meta = json.dumps({"vocab_size": FLAGSHIP.vocab_size,
                           "seq_length": FLAGSHIP.seq_length,
                           "idx_to_token": {str(k): v
                                            for k, v in vocab.items()},
                           "config": FLAGSHIP.to_json()})
        save_params(tmp / "ck.npz", params, extra={"meta": meta})
        mb = (tmp / "ck.npz").stat().st_size / 2**20
        t1 = time.perf_counter()
        _, counts = read_launches(lambda: run_model.main([
            "--checkpoint", str(tmp / "ck.npz"), "--input_dir",
            str(tmp / "frames"), "--output_dir", str(tmp / "out"),
            "--image_size", str(FLAGSHIP.image_size), "--num_proposals",
            str(FLAGSHIP.test_max_proposals), "--device", "cuda"]))
        t2 = time.perf_counter()
        with open(tmp / "out" / "results.json") as f:
            results = json.load(f)["results"]
    ok = len(results) == len(sizes)
    for r in results:
        fh, fw = sizes[int(r["img_name"][1:-4])]
        b = np.asarray(r["boxes"], np.float64).reshape(-1, 4)
        ok = ok and bool(
            len(b) and (b[:, :2] >= 1 - 2).all()
            and (b[:, 0] + b[:, 2] - 1 <= fw + 2).all()
            and (b[:, 1] + b[:, 3] - 1 <= fh + 2).all()
            and all(isinstance(c, str) for c in r["captions"])
            and len(r["captions"]) == len(b) == len(r["scores"]))
    print(f"[run_model] CLI on 8 JPEGs, full-width checkpoint ({mb:.0f} MiB, "
          f"written in {t1 - t0:.1f} s): {t2 - t1:.1f} s for load + 8 images; "
          f"results.json entries {len(results)}, boxes per image "
          f"{[len(r['boxes']) for r in results]}, inside each frame (2 px "
          f"margin) with string captions={ok}; launches {counts}")
    need_launches(counts, ("nms", "roi_align"), "run_model")
    if not ok:
        raise AssertionError("run_model's results.json is wrong")
    return counts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--before", default=None,
                    help="a checkout of an earlier commit (e.g. a git "
                         "archive of the parent): its K2b is timed alone "
                         "beside this one's")
    args = ap.parse_args(argv)
    name, smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    k1 = phase_nms(dev)
    k2 = phase_roi(dev)
    k3 = phase_conv_pool(dev)
    k2b = phase_roi_bwd(dev, args.before)
    phase_reference(dev)
    t0 = time.perf_counter()
    params = init_params(FLAGSHIP, seed=0)
    print(f"[engine] full-width params from seed 0 in "
          f"{time.perf_counter() - t0:.1f} s")
    serve = phase_engine(dev, params)
    phase_train_reference(dev)
    train = phase_train(dev, params)
    vocab = {i: f"w{i}" for i in range(1, FLAGSHIP.vocab_size + 1)}
    model = to_torch(params, FLAGSHIP, dev)
    paths = {"serve": serve, "eval": phase_eval(dev, model, vocab),
             "beam": phase_beam(dev, model),
             "extract_features": phase_extract(dev, model)}
    del model
    torch.cuda.empty_cache()
    paths["run_model"] = phase_run_model(dev, params, vocab)
    kernels = [
        {"name": "nms", "route": "cuda",
         "source": "densecap_tpu_torch/ops/cuda/nms.cu",
         "replaces": "densecap_tpu/ops/pallas/nms_kernel.py:146",
         "launches": serve["nms"],
         "launches_by_path": {p: c["nms"] for p, c in paths.items()}, **k1},
        {"name": "roi_align", "route": "cuda",
         "source": "densecap_tpu_torch/ops/cuda/roi_align.cu",
         "replaces": "densecap_tpu/ops/pallas/roi_align_kernel.py:141",
         "launches": serve["roi_align"],
         "launches_by_path": {p: c["roi_align"] for p, c in paths.items()},
         **k2},
        {"name": "roi_align_bwd", "route": "cuda",
         "source": "densecap_tpu_torch/ops/cuda/roi_align.cu",
         "replaces": "densecap_tpu/ops/roi_align.py:63 (autodiff)",
         "launches": train["roi_align_bwd"] + train["roi_align_bwd_feats"],
         "launches_by_instance": {
             "positions (frozen trunk)": train["roi_align_bwd"],
             "positions + d feats": train["roi_align_bwd_feats"]},
         **k2b},
        {"name": "conv_pool", "route": "cuda",
         "source": "densecap_tpu_torch/ops/cuda/conv_pool.cu",
         "replaces": "densecap_tpu/ops/pallas/conv_pool_kernel.py:273",
         "launches": train["conv_pool"], **k3},
    ]
    print(f"[device] nvidia-smi: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
