"""Card-side check of the PyTorch port: kernels, full-width engine, HTTP,
full-width training (canvas buckets, the batch weight, resume, data
parallel ranks, tensor-parallel ranks, a profiler trace), evaluation,
offline inference, int8
serving, the directory daemon, the native host I/O, data-parallel
evaluation and serving over model replicas, and the reference's t7
checkpoint path.

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
     (8 x 1000 boxes) and the training shape (8 x 384), and at the
     training shape on the 544x720 bucket's 34x45 map, max abs error
     <= 1e-5; the same times and bound as K1, and F.grid_sample on the
     same positions (within 1e-4 of plain) as the library call;
  5. K3 (fused conv+ReLU+mask+pool) at trunk1's conv1_2 and conv2_2
     shapes in bf16, on the 720 px square and on the 544x720 bucket
     ((8,544,720,64), (8,272,360,128)): its max abs error against an f32
     oracle no more
     than 1.25x the plain version's; in f32 within rtol 1e-4 of plain;
     the C launch alone (20 in a CUDA graph, as K1 / K2), one call
     through the wrapper, plain ms and TFLOP/s at both shapes; then
     trunk1's bf16
     forward at B = 8 (720 px canvas, 540x720 frames) with K3 and with
     cuDNN, printed only;
  6. K2b (RoI-align backward) at the training shape, on the square's
     and the bucket's map, against plain
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
     flip and its d feats instance only after. Then:
     [train buckets] the flagship step on 540x720 frames cropped to the
     544x720 bucket against the 720x720 square, batches from
     BucketedLoader's schedule over in-memory examples, 8 steps each in
     turns (square, bucket, bucket, square): ms/step, images/s, peak
     memory; [weight] a tiny f32 step with a repeat slot of weight 0
     against the real frames alone, within [train reference]'s bounds;
     [resume] two uninterrupted tiny steps give the floor, and a run
     saved after step 1 (the .npz / .optim.pt pair under build/), loaded
     and stepped must stay within it; [distributed] a world-1 NCCL group's
     distributed step within the floor of the plain one, then two gloo
     ranks in subprocesses sharing cuda:0 (K3 on, cuDNN off; global batch
     4, a slot of weight 0, two steps with the flip between): bit-equal
     ranks that launched K3, K2 and both K2b instances, each
     step within [train reference]'s bounds of one process's on the whole
     batch from the same state; [tensor parallel] two gloo ranks on
     cuda:0 forming one model group (M = 2) at the flagship's full width
     (V+1 = 10 001 split unevenly), in f32 and in bf16: 2 frozen steps,
     the flip, 1 more; the ranks' replicated parameters bit-equal, K3,
     K2 and both K2b instances launched on each, every step within
     [train reference]'s bounds of one unsharded process's step from the
     same state (where |g| is large, bf16 within TP_BF16_LARGE_G), and
     the ranks' checkpoint resumed at world 1 within the floor of the
     unsharded save of the same state; [profile]
     torch.profiler over three
     flagship frozen steps on the square and three on the bucket (traces
     under build/profile): device time per step of each, the square's top
     8 CUDA kernels with the bucket's time for each, and StageTimer
     reports;
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
 12. [int8] W8A8 fc6 / fc7 at 8000 rows (B=8 x 1000 RoIs): torch._int_mm
     equal to a float64 product of the same codes; its second operand
     column-major (the layout QuantLinear stores) and row-major; the
     quantize, int_mm and dequant split; int8 fc6+fc7 against bf16
     (order bf16, int8, int8, bf16) with each product's bound at the
     int8 and bf16 peaks; the codes' relative error (<= 0.05); only
     torch._int_mm touches the fc6 / fc7 weights;
 13. [int8 engine] the full-width engine on quantize_for_inference
     params beside the bf16 engine, in turns: batch 8 (32 concurrent
     720x540 frames) images/s and batch 1 (50 proposals) p50;
 14. [daemon] serve.daemon.scan_once on 8 JPEGs, a truncated JPEG and a
     .txt at the daemon's defaults (480 px, 50 proposals): 8 JSONs, the
     bad files left in place;
 15. [native] whether `make -C native` built libdcio / libdcgeom here
     (the error if not; this part runs before phase 9, whose evaluator
     loads libdcgeom, so the build is not timed), then the run_model CLI
     (--device cuda) on 8 JPEG frames and a full-width checkpoint .npz
     with --native_io 1 and 0: results.json with 8 entries, boxes
     inside each frame, string captions, the same detections both ways,
     and each decode path's host seconds per image;
 16. [data parallel] (after phase 11) --data_parallel's paths with two
     replicas on cuda:0, each its own thread and stream: eval_split over
     24 eval frames and the engine on 32 concurrent 720x540 frames, at
     batch 8 with one replica and with two, in turns: images/s of each;
     eval over the replicas within 1e-6 of one replica at batch 4 (the
     shards' size), and every shard the engine's replicas ran bit-equal
     to the model alone on that shard (a request's answer depends on the
     frames that share its batch, which form by arrival);
 17. [t7] a full-width DenseCap checkpoint in the reference's t7 layout,
     written from seed 0 by this script's own writer (~0.58 GB, under
     build/, removed after): cli/convert_t7 to the shared .npz,
     load_checkpoint (the flagship config), then on the card trunk1, the
     RPN, fc6 and an LSTM step of the converted model (f32) against the
     raw torch-layout weights within 1e-4 of scale, and the batch-8
     engine on the converted model (16 frames, captions from the
     checkpoint's vocabulary); write, read, convert and load seconds.

Phases 7 (and its thin-frame part), 9-11 and 13-17 each drive their path
with every launch count set to 0 just before and read just after; K1 and
K2 must launch on each (in 16, with one replica and with two). So do
[train], [train buckets] and [tensor parallel]'s ranks, where K2, K2b
and K3 must launch.

The last lines are a JSON object describing each kernel and
{"ok": true, "device": {...}}. Every kernel carries "ms", "plain_ms",
"bound_ms" with "bound_by" (bytes or operations, against the H100 SXM
data sheet's peaks) and "library_ms" with a "library_note": for K2 and
K2b one F.grid_sample call (and its backward) on K2's clamped sample
positions, held against the plain version; null for K1 and K3, which no
single PyTorch call computes. K1, K2 and K2b also give "kernel_ms"
(K2b: with d feats; both instances, with the earlier commit's times
under --before, in "modes"; the bucket's map under "bucket"). K3's entry
gives the sum of its two square stages in "kernel_ms" / "ms" /
"plain_ms" / "bound_ms" (its cost per trunk1 forward) and each stage,
the bucket's too, under "shapes"; K2's shapes include the bucket's.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import re
import statistics
import struct
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

from densecap_tpu_torch import native_lib
from densecap_tpu_torch.config import DenseCapConfig
from densecap_tpu_torch.data.loader import BATCH_KEYS, BucketedLoader
from densecap_tpu_torch.eval.eval_split import eval_split
from densecap_tpu_torch.models.vgg16 import (TRUNK1_CFG, Linear, Recog, Trunk,
                                             feat_extent)
from densecap_tpu_torch.ops import conv_pool as cp
from densecap_tpu_torch.ops import nms as nms_mod
from densecap_tpu_torch.ops import quant
from densecap_tpu_torch.ops import roi_align as roi_mod
from densecap_tpu_torch.ops.boxes import xcycwh_to_x1y1x2y2
from densecap_tpu_torch.ops.cuda import build
from densecap_tpu_torch.parallel import distributed
from densecap_tpu_torch.parallel.mesh import gather_optimizer_state
from densecap_tpu_torch.parallel.train_step import Trainer
from densecap_tpu_torch.serve import daemon
from densecap_tpu_torch.serve.engine import InferenceEngine
from densecap_tpu_torch.serve.server import make_handler
from densecap_tpu_torch.utils import t7_reader
from densecap_tpu_torch.utils.checkpoint import (from_torch, init_params,
                                                 load_params,
                                                 load_train_state,
                                                 save_params,
                                                 save_train_state, to_torch)
from densecap_tpu_torch.utils.profiling import StageTimer, device_trace

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
# the 544x720 canvas bucket of the 720 px square (34 x 45 feature cells;
# it holds the 540x720 frames) and eight frame sizes that fit it
BUCKET = (544, 720)
BUCKET_IMG_H = (540, 540, 544, 480, 500, 544, 360, 540)
BUCKET_IMG_W = (720, 720, 720, 720, 500, 333, 720, 96)


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
    (8 x 384) on (8, 45, 45, 512) f32, and at the training shape on the
    544x720 bucket's (8, 34, 45, 512)."""
    rng = np.random.default_rng(2)
    shapes, err = [], 0.0
    for k, hw, sizes in ((1000, (45, 45), (IMG_H, IMG_W)),
                         (384, (45, 45), (IMG_H, IMG_W)),
                         (384, (34, 45), (BUCKET_IMG_H, BUCKET_IMG_W))):
        feats = torch.from_numpy(rng.standard_normal(
            (B, *hw, 512), dtype=np.float32)).to(dev)
        img_h = torch.tensor(sizes[0], dtype=torch.float32, device=dev)
        img_w = torch.tensor(sizes[1], dtype=torch.float32, device=dev)
        fh, fw = feat_extent(img_h, img_w)
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
        label = f"{B}x{k} boxes, ({B},{hw[0]},{hw[1]},512) f32"
        print(f"[K2 roi_align] {label}: max_abs_err "
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
        shapes.append({"shape": label,
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
    """K3 at trunk1's two fused stages, ragged extents: on the 720 px
    square and on the 544x720 bucket."""
    g = torch.Generator(device=dev).manual_seed(5)
    worst, shapes = 0.0, []
    Hb, Wb = BUCKET
    for name, C, H, W, div, sizes in (
            ("conv1_2+pool1", 64, 720, 720, 1, (IMG_H, IMG_W)),
            ("conv2_2+pool2", 128, 360, 360, 2, (IMG_H, IMG_W)),
            ("conv1_2+pool1 bucket", 64, Hb, Wb, 1,
             (BUCKET_IMG_H, BUCKET_IMG_W)),
            ("conv2_2+pool2 bucket", 128, Hb // 2, Wb // 2, 2,
             (BUCKET_IMG_H, BUCKET_IMG_W))):
        eh = torch.floor(torch.tensor(sizes[0], device=dev) / div)
        ew = torch.floor(torch.tensor(sizes[1], device=dev) / div)
        x = torch.randn((B, C, H, W), generator=g, device=dev).abs()
        x = (x * cp.extent_mask(H, W, eh, ew, x.dtype)).contiguous(
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
            # the C launch alone, on inputs the wrapper prepared beforehand
            prep = cp.prepare_cuda(xb, wb, bb, eh, ew)
            kern_ms = graph_ms(lambda: cp.launch_cuda(*prep))
            del prep
        tflops = 2 * 9 * C * C * B * H * W / kern_ms / 1e9
        # bf16 input and pooled output once, weights and bias once
        b_ms, b_by = bound_ms(
            (B * H * W * C + B * (H // 2) * (W // 2) * C + 9 * C * C + C) * 2,
            2 * 9 * C * C * B * H * W, H100_BF16_TFLOPS)
        label = f"{name} ({B},{H},{W},{C}) bf16"
        print(f"[K3 conv_pool] {label}: max abs err vs "
              f"f32 oracle kernel {k_err:.4e} plain {p_err:.4e} (ratio "
              f"{k_err / p_err:.3f}, limit {CONV_POOL_RATIO}); f32 kernel vs "
              f"plain max abs {f32_err:.3e} within rtol {CONV_POOL_F32_RTOL}="
              f"{f32_ok}; bf16 kernel vs plain max abs {kp_err:.4e}, "
              f"{equal:.5%} bit-equal; kernel alone {kern_ms:.4f} ms = "
              f"{tflops:.1f} TFLOP/s ({tflops / H100_BF16_TFLOPS:.1%} of the "
              f"bf16 peak), through the wrapper {k_ms:.3f} ms, plain "
              f"{p_ms:.3f} ms; bound {b_ms:.4f} ms ({b_by}) = "
              f"{b_ms / kern_ms:.1%} of the kernel alone")
        if not (k_err <= CONV_POOL_RATIO * p_err and f32_ok):
            raise AssertionError(f"K3 disagrees with plain at {name}")
        worst = max(worst, kp_err)
        shapes.append({"shape": label,
                       "kernel_ms": kern_ms, "ms": k_ms, "plain_ms": p_ms,
                       "tflops": tflops,
                       "bound_ms": b_ms, "bound_by": b_by})
    phase_trunk1(dev)
    square = shapes[:2]  # the sums: one square trunk1 forward
    return {"max_abs_err": worst,
            "kernel_ms": sum(s["kernel_ms"] for s in square),
            "ms": sum(s["ms"] for s in square),
            "plain_ms": sum(s["plain_ms"] for s in square),
            "bound_ms": sum(s["bound_ms"] for s in square),
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
    """K2b at the training shape, 8 x 384 boxes, on (8, 45, 45, 512) and
    on the 544x720 bucket's (8, 34, 45, 512). With `before` (a checkout
    of an earlier commit), that commit's K2b is timed alone too, before
    and after this one's square case."""
    before_ms = [k2b_before(before)] if before else []
    out = roi_bwd_case(dev, (45, 45), (IMG_H, IMG_W), seed=6)
    if before:
        before_ms.append(k2b_before(before))
    for mode in out["modes"]:
        out["modes"][mode]["before_kernel_ms"] = [b[mode] for b in before_ms
                                                  ] or None
    out["bucket"] = roi_bwd_case(dev, (34, 45), (BUCKET_IMG_H, BUCKET_IMG_W),
                                 seed=17)
    return out


def roi_bwd_case(dev, hw, sizes, seed):
    """K2b on (8, *hw, 512) f32, 384 boxes per frame of `sizes` (heights,
    widths), in both instances against plain autograd; the times and
    bounds of each, and grid_sample's backward."""
    rng = np.random.default_rng(seed)
    feats = torch.from_numpy(
        rng.standard_normal((B, *hw, 512), dtype=np.float32)).to(dev)
    img_h = torch.tensor(sizes[0], dtype=torch.float32, device=dev)
    img_w = torch.tensor(sizes[1], dtype=torch.float32, device=dev)
    fh, fw = feat_extent(img_h, img_w)
    bx = random_boxes(rng, 384)
    bx[..., 2:] *= 1.5
    boxes = torch.from_numpy(bx).to(dev)
    gout = torch.from_numpy(
        rng.standard_normal((B, 384, 7, 7, 512), dtype=np.float32)).to(dev)
    label = f"{B}x384 boxes on ({B},{hw[0]},{hw[1]},512) f32"

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
    wrap_ms = {"d_feats": cuda_ms(graph(roi_mod.roi_align_cuda, True)),
               "frozen": cuda_ms(graph(roi_mod.roi_align_cuda, False))}
    plain_ms = {"d_feats": cuda_ms(graph(roi_mod.roi_align_plain, True)),
                "frozen": cuda_ms(graph(roi_mod.roi_align_plain, False))}
    l_ms = cuda_ms(lib_bwd)
    del lib_bwd
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
    print(f"[K2b roi_align_bwd] {label}: d feats "
          f"err {f_err:.3e} (tol {BWD_FEATS_TOL}), d boxes err {b_err:.3e} "
          f"(tol {BWD_BOXES_TOL}), relative to the largest plain entry")
    for mode in ("frozen", "d_feats"):
        b_ms, b_by = bounds[mode]
        print(f"[K2b roi_align_bwd] {label}, {mode}: kernel alone "
              f"{kern_ms[mode]:.4f} ms "
              f"({(gout.numel() * 4 + feats.numel() * 4) / kern_ms[mode] / 1e9:.2f}"
              f" TB/s of g and the map), through the wrapper "
              f"{wrap_ms[mode]:.3f} ms, plain {plain_ms[mode]:.3f} ms; bound "
              f"{b_ms:.4f} ms ({b_by}) = {b_ms / kern_ms[mode]:.1%} of the "
              f"kernel alone")
    print(f"[K2b roi_align_bwd] {label}: grid_sample's backward {l_ms:.3f} ms "
          f"(d feats err {lib_err:.3e}, tol {BWD_FEATS_TOL})")
    if not (f_err <= BWD_FEATS_TOL and b_err <= BWD_BOXES_TOL):
        raise AssertionError(f"K2b disagrees with plain autograd ({label})")
    if not lib_err <= BWD_FEATS_TOL:
        raise AssertionError(f"grid_sample's d feats differ from plain "
                             f"({label})")
    return {"shape": label,
            "max_abs_err": max(v[0] for e in errs.values()
                               for v in e.values()),
            "kernel_ms": kern_ms["d_feats"], "ms": wrap_ms["d_feats"],
            "plain_ms": plain_ms["d_feats"],
            "bound_ms": bounds["d_feats"][0],
            "bound_by": bounds["d_feats"][1], "library_ms": l_ms,
            "library_note": "backward of F.grid_sample (align_corners=True, "
                            "K2's clamped positions as one grid per image) "
                            "to the map and the grid",
            "modes": {mode: {"kernel_ms": kern_ms[mode],
                             "ms": wrap_ms[mode], "plain_ms": plain_ms[mode],
                             "bound_ms": bounds[mode][0],
                             "bound_by": bounds[mode][1]}
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


def reference_batch(n=2):
    """n 72x96 uint8 frames for TINY_TRAIN, the first two resized to
    72x96 and 96x80, and the sampler's debug ordinals (seed 3)."""
    rng = np.random.default_rng(3)
    batch = make_train_batch(rng, TINY_TRAIN, n, (72, 96), 6)
    batch["height"][:2] = torch.tensor([72.0, 96.0])
    batch["width"][:2] = torch.tensor([96.0, 80.0])
    dbg = {"pos": torch.from_numpy(rng.permutation(8)),
           "neg": torch.from_numpy(rng.permutation(16))}
    return batch, dbg


def one_step(trainer, batch, dev, **kw):
    """trainer.step on `batch` moved to dev -> (losses as floats,
    {name: (parameter, gradient)} on the CPU)."""
    losses = trainer.step(to_dev(batch, dev), **kw)
    return ({k: float(v) for k, v in losses.items()},
            {n: (p.detach().to("cpu", copy=True),
                 p.grad.detach().to("cpu", copy=True))
             for n, p in trainer.model.named_parameters()
             if p.grad is not None})


def step_diff(run, ref):
    """Two `one_step` results: (the losses' largest relative error, the
    updated parameters' largest difference, and that where |g| of `ref`
    is large, above 1e-3 of its parameter's largest)."""
    (lr_, pr), (lf, pf) = run, ref
    loss_err = max(abs(lr_[k] - lf[k]) / max(abs(lf[k]), 1e-6) for k in lf)
    worst_all = worst_big = 0.0
    for n, (p_ref, g_ref) in pf.items():
        diff = (pr[n][0] - p_ref).abs()
        big = g_ref.abs() > 1e-3 * g_ref.abs().max()
        worst_all = max(worst_all, float(diff.max()))
        worst_big = max(worst_big, float(diff[big].max()) if big.any() else 0)
    return loss_err, worst_all, worst_big


def large_g_bound(lr):
    """[train reference]'s bound where |g| is large: 1e-3 lr + 1e-6."""
    return 1e-3 * lr + 1e-6


def within_reference(errs, lr, large=None):
    """The [train reference] bounds: losses rtol 1e-4; Adam's first update
    is about -lr * sign(g), so entries with |g| near eps may differ by up
    to 2 lr, and where |g| is large they agree to `large` (default
    large_g_bound(lr))."""
    loss_err, worst_all, worst_big = errs
    large = large_g_bound(lr) if large is None else large
    return (loss_err <= 1e-4 and worst_all <= 2 * lr + 1e-6
            and worst_big <= large)


def describe(errs, lr, large=None):
    large = large_g_bound(lr) if large is None else large
    return (f"losses max rel err {errs[0]:.2e} (tol 1e-4); updated params max "
            f"diff {errs[1]:.2e} (bound 2 lr = {2 * lr:.0e}), where |g| is "
            f"large {errs[2]:.2e} (bound {large:.2e})")


def phase_train_reference(dev, lr=1e-3):
    """One train step of a small f32 model (K3 on, sampler pinned by
    ordinals, dropout off) on the card against the CPU's plain path."""
    cfg = TINY_TRAIN
    params = init_params(cfg, seed=3)
    batch, dbg = reference_batch()
    runs, trunk1 = [], []
    for d in (dev, torch.device("cpu")):
        trainer = Trainer(to_torch(params, cfg, d, train=True),
                          learning_rate=lr)
        runs.append(one_step(trainer, batch, d, debug_sampler=to_dev(dbg, d)))
        trunk1.append(from_torch(trainer.model)["trunk1"])
    errs = step_diff(*runs)
    same_trunk1 = all(np.array_equal(trunk1[0][k]["w"], trunk1[1][k]["w"])
                      for k in trunk1[1])
    print(f"[train reference] tiny f32 model, K3 on, one step card vs CPU: "
          f"{describe(errs, lr)}; total {runs[0][0]['total_loss']:.6f} vs "
          f"{runs[1][0]['total_loss']:.6f}; trunk1 unchanged on "
          f"both={same_trunk1}")
    if not (within_reference(errs, lr) and same_trunk1):
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


def loader_batch(batch, dev):
    """A BucketedLoader batch (numpy) as the train step's device tensors."""
    out = {k: torch.from_numpy(np.asarray(batch[k])).to(dev)
           for k in (*BATCH_KEYS, "weight")}
    out["gt_labels"] = out["gt_labels"].long()
    return out


def phase_train_buckets(dev, params, steps=8):
    """The flagship train step (bf16, B = 8, K3 on, trunk frozen) on
    540x720 frames, cropped to the 544x720 bucket against the 720x720
    square, in turns: square, bucket, bucket, square, `steps` steps each.
    The batches come from BucketedLoader's schedule over in-memory
    examples."""
    cfg = FLAGSHIP.replace(fuse_conv_pool=True)
    mem = MemoryLoader(eval_examples(cfg, n=2 * B, sizes=((540, 720),),
                                     seed=19), vocab=None)
    loaders = {"square": BucketedLoader(mem, [], B),
               "bucket": BucketedLoader(mem, [BUCKET], B)}
    trainer = Trainer(to_torch(params, cfg, dev, train=True),
                      learning_rate=1e-5)
    gen = torch.Generator(device=dev).manual_seed(0)

    def run(kind, n):
        times, shapes, totals = [], set(), []
        for _ in range(n):
            bucket, batch = loaders[kind].next_batch()
            shapes.add(bucket)
            batch = loader_batch(batch, dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            losses = trainer.step(batch, generator=gen)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
            totals.append(float(losses["total_loss"]))
        return times, shapes, totals

    for kind in loaders:  # warm-up: cuDNN's choices at each shape
        run(kind, 1)
    ms = {k: [] for k in loaders}
    peak = {k: 0 for k in loaders}
    seen = {k: set() for k in loaders}
    totals, counts = [], None
    for kind in ("square", "bucket", "bucket", "square"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if kind == "bucket" and counts is None:
            (t, shp, tot), counts = read_launches(lambda: run("bucket", steps))
        else:
            t, shp, tot = run(kind, steps)
        peak[kind] = max(peak[kind], torch.cuda.max_memory_allocated())
        ms[kind].append(t)
        seen[kind] |= shp
        totals += tot
    med = {k: statistics.median(sum(v, [])) for k, v in ms.items()}
    share = BUCKET[0] * BUCKET[1] / cfg.image_size ** 2
    for kind in loaders:
        print(f"[train buckets] {kind} {sorted(seen[kind])}: ms/step median "
              f"{med[kind]:.2f} (runs {', '.join(f'{statistics.median(t):.2f}' for t in ms[kind])}; "
              f"min {min(sum(ms[kind], [])):.2f}, max "
              f"{max(sum(ms[kind], [])):.2f}), {B * 1000 / med[kind]:.2f} "
              f"images/s, peak device memory {peak[kind] / 2**30:.2f} GiB")
    print(f"[train buckets] flagship B={B}, 540x720 frames, bf16, K3 on, "
          f"trunk frozen, order square, bucket, bucket, square, {steps} steps "
          f"each: bucket / square ms/step {med['bucket'] / med['square']:.3f} "
          f"(the bucket holds {share:.1%} of the square's pixels); "
          f"launches on the bucket path {counts}")
    if seen != {"square": {(cfg.image_size,) * 2}, "bucket": {BUCKET}}:
        raise AssertionError(f"the schedule gave other canvases: {seen}")
    if not all(np.isfinite(totals)):
        raise AssertionError(f"non-finite training loss: {totals}")
    need_launches(counts, ("conv_pool", "roi_align", "roi_align_bwd"),
                  "train buckets")
    return counts, {"ms_per_step": med, "runs_ms": ms, "peak_bytes": peak,
                    "pixel_share": share}


def phase_weight(dev, lr=1e-3):
    """A tiny f32 step (K3 on, sampler pinned, dropout off) where a third
    slot of weight 0 repeats the first frame, against the two real frames
    alone."""
    cfg = TINY_TRAIN
    params = init_params(cfg, seed=3)
    batch, dbg = reference_batch()
    padded = {k: torch.cat([v, v[:1]]) for k, v in batch.items()}
    padded["weight"] = torch.tensor([1.0, 1.0, 0.0])
    runs = [one_step(Trainer(to_torch(params, cfg, dev, train=True),
                             learning_rate=lr), b, dev,
                     debug_sampler=to_dev(dbg, dev)) for b in (padded, batch)]
    errs = step_diff(*runs)
    print(f"[weight] tiny f32 step with a repeat slot of weight 0 against "
          f"the real frames alone: {describe(errs, lr)}; num_pos "
          f"{runs[0][0]['stats/num_pos']:.1f} vs {runs[1][0]['stats/num_pos']:.1f}")
    if not within_reference(errs, lr):
        raise AssertionError("a slot of weight 0 changed the update")


def params_of(trainer):
    return {n: p.detach().clone() for n, p in trainer.model.named_parameters()}


def max_diff(a, b):
    return max(float((a[n] - b[n]).abs().max()) for n in a)


def phase_resume(dev, lr=1e-3):
    """TINY_TRAIN, two steps: the floor is the largest parameter
    difference between two identical uninterrupted runs (cuDNN's weight
    gradient may be nondeterministic); a run saved after its first step
    (the .npz / .optim.pt pair under build/) and resumed must take the
    second step within that floor of the uninterrupted one. Returns the
    floor."""
    cfg = TINY_TRAIN
    params = init_params(cfg, seed=3)
    batch = to_dev(reference_batch()[0], dev)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    work = ROOT / "build"
    work.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        prefix = str(Path(tmp) / "resume")
        ends = []
        for save in (False, True):
            t = Trainer(to_torch(params, cfg, dev, train=True),
                        learning_rate=lr)
            t.step(batch, generator=gen(1))
            if save:
                save_train_state(prefix, t, 1, json.dumps({}))
            t.step(batch, generator=gen(2))
            ends.append(params_of(t))
        floor = max_diff(*ends)
        model, state = load_train_state(prefix, cfg, dev)
        resumed = Trainer(model, learning_rate=lr)
        resumed.load_state_dict(state)
        resumed.step(batch, generator=gen(2))
    err = max_diff(params_of(resumed), ends[1])
    print(f"[resume] tiny f32, two steps: floor (two uninterrupted runs) "
          f"{floor:.3e}; saved after step 1, loaded, step 2: {err:.3e} from "
          f"the uninterrupted run (iter {state['iter']}, count "
          f"{resumed.count})")
    if not (err <= floor and state["iter"] == 1 and resumed.count == 2):
        raise AssertionError("the resumed step left the uninterrupted one")
    return floor


def dist_batch():
    """A global batch of 4 for TINY_TRAIN: three frames and a repeat of
    the first at weight 0, and the sampler's debug ordinals."""
    batch, dbg = reference_batch(3)
    batch = {k: torch.cat([v, v[:1]]) for k, v in batch.items()}
    batch["weight"] = torch.tensor([1.0, 1.0, 1.0, 0.0])
    return batch, dbg


def dist_trainer(dev, lr, snapshot=None):
    """A Trainer over TINY_TRAIN's seed-3 parameters, or over those of a
    `dist_step` snapshot with its optimizer state (distributed when the
    process group is up)."""
    model = to_torch(init_params(TINY_TRAIN, seed=3), TINY_TRAIN, dev,
                     train=True)
    if snapshot is not None:
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(snapshot["params"][n])
    trainer = Trainer(model, learning_rate=lr)
    if snapshot is not None:
        trainer.load_state_dict(snapshot["state"])
    return trainer


def dist_step(trainer, batch, dbg, i, dev):
    """Step i (the finetune flip before step 1) -> a snapshot on the CPU:
    parameters, optimizer state, losses and the step's gradients."""
    if i == 1:
        trainer.set_finetune(True)
    run = one_step(trainer, batch, dev, debug_sampler=to_dev(dbg, dev))
    state = trainer.state_dict()
    # a copy: the packed state's entries are the optimizer's own dicts
    state["optimizer"]["state"] = {
        i: {k: v.detach().cpu().clone() for k, v in st.items()}
        for i, st in state["optimizer"]["state"].items()}
    return {"params": {n: p.to("cpu", copy=True)
                       for n, p in params_of(trainer).items()},
            "state": state, "losses": run[0], "run": run}


def dist_worker(rank, init, out, lr=1e-3):
    """One of two gloo ranks sharing cuda:0 (a subprocess of
    phase_distributed): two steps on its half of dist_batch."""
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.enabled = False  # see phase_distributed
    distributed.initialize(init_method=init, num_processes=2, process_id=rank,
                           device=dev, backend="gloo")
    try:
        batch, dbg = dist_batch()
        local = {k: v[2 * rank:2 * rank + 2] for k, v in batch.items()}
        trainer = dist_trainer(dev, lr)
        assert trainer.distributed
        build.reset_launches()
        steps = [dist_step(trainer, local, dbg, i, dev) for i in range(2)]
        torch.save({"steps": steps, "launches": dict(build.launches)}, out)
    finally:
        distributed.shutdown()


def run_ranks(flag, tmp, timeout, *extra):
    """Two ranks of this script (`flag` r: --dist_rank or --tp_rank, then
    `extra` arguments) in subprocesses that meet at a gloo store in
    `tmp` -> what each saved (on the CPU). Raises with the output of a
    rank that failed."""
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), flag, str(r),
         "--dist_init", f"file://{tmp}/gloo", "--dist_out",
         f"{tmp}/rank{r}", *extra], cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"a gloo rank failed:\n{out[-4000:]}")
    return [torch.load(f"{tmp}/rank{r}", map_location="cpu",
                       weights_only=True) for r in (0, 1)]


def phase_distributed(dev, floor, lr=1e-3):
    """A world-1 NCCL group (distributed.initialize) whose distributed
    step must equal the plain Trainer's within the [resume] floor; then
    two gloo ranks in subprocesses sharing cuda:0, a global batch of 4
    with a slot of weight 0, two steps with the flip between: the ranks
    bit-equal, and each step within the [train reference] bounds of one
    process's step on the whole batch from the same state. (NCCL refuses
    two ranks on one GPU.) The ranks and that process run without cuDNN:
    cuDNN picks its conv algorithm by the batch's size, and the sampler
    thresholds the IoU of the RPN's proposals, so a rounding difference
    there can swap a sampled box; PyTorch's own conv computes each image
    alone, the same in a batch of 2 and of 4. Trunk1's fused stages still
    run K3 (on the NCHW maps that conv writes), and the ranks must have
    launched K3, K2 and K2b."""
    batch, dbg = dist_batch()
    work = ROOT / "build"
    work.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        # [resume]'s model: the plain Trainer is built before the group is
        # up, the distributed one inside it
        trainers = [Trainer(to_torch(init_params(TINY_TRAIN, seed=3),
                                     TINY_TRAIN, dev, train=True),
                            learning_rate=lr)]
        distributed.initialize(init_method=f"file://{tmp}/nccl",
                               num_processes=1, process_id=0, device=dev)
        try:
            backend = torch.distributed.get_backend()
            trainers.append(Trainer(to_torch(init_params(TINY_TRAIN, seed=3),
                                             TINY_TRAIN, dev, train=True),
                                    learning_rate=lr))
            ends = []
            for t in trainers:
                t.step(to_dev(batch, dev), debug_sampler=to_dev(dbg, dev))
                ends.append(params_of(t))
        finally:
            distributed.shutdown()
        err = max_diff(*ends)
        print(f"[distributed] world-1 {backend} group: the distributed step "
              f"against the plain Trainer's, max parameter diff {err:.3e} "
              f"(floor {floor:.3e})")
        if not (backend == "nccl" and trainers[1].distributed
                and not trainers[0].distributed and err <= floor):
            raise AssertionError("the world-1 distributed step differs")

        t0 = time.perf_counter()
        saved = run_ranks("--dist_rank", tmp, 300)
    ranks = [s["steps"] for s in saved]
    for s in saved:
        need_launches(s["launches"], ("conv_pool", "roi_align",
                                      "roi_align_bwd", "roi_align_bwd_feats"),
                      "distributed")
    wall = time.perf_counter() - t0
    equal = all(a["losses"] == b["losses"] and all(
        torch.equal(p, b["params"][n]) for n, p in a["params"].items())
        for a, b in zip(*ranks))
    worst = [0.0, 0.0, 0.0]
    with torch.backends.cudnn.flags(enabled=False):
        for i, got in enumerate(ranks[0]):
            ref = dist_step(dist_trainer(dev, lr, ranks[0][i - 1] if i
                                         else None), batch, dbg, i, dev)
            errs = step_diff(got["run"], ref["run"])
            worst = [max(a, b) for a, b in zip(worst, errs)]
    print(f"[distributed] two gloo ranks on cuda:0, global batch 4 (one slot "
          f"of weight 0), two steps, the flip between ({wall:.1f} s with the "
          f"processes' start; rank 0's launches {saved[0]['launches']}): "
          f"ranks bit-equal={equal}; each step against one "
          f"process on the whole batch from the same state: "
          f"{describe(worst, lr)}")
    if not (equal and within_reference(worst, lr)):
        raise AssertionError("the gloo ranks disagree")


TP_LR = 1e-5
TP_FROZEN = 2  # [tensor parallel]: frozen steps, then the flip and one more
TP_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# Where |g| is large, the largest parameter difference allowed between a
# [tensor parallel] step and one unsharded process's. f32: the [train
# reference] bound. bf16: a sum split over the group's columns rounds
# otherwise before its bf16 cast, and the second Adam step turns that
# into updates up to TP_BF16_LARGE_G apart; see PERF.md (PR 10) for the
# sound run's reading and a broken control's, between which it lies.
TP_BF16_LARGE_G = 3e-6
TP_LARGE_G = {"float32": large_g_bound(TP_LR), "bfloat16": TP_BF16_LARGE_G}


def tp_config(dtype):
    return FLAGSHIP.replace(fuse_conv_pool=True,
                            compute_dtype=TP_DTYPES[dtype])


def tp_batches(cfg, dev):
    """The [tensor parallel] steps' batches: B = 8 540x720 frames each
    (seed 23), on dev."""
    rng = np.random.default_rng(23)
    return [to_dev(make_train_batch(rng, cfg, B, (540, 720), 30), dev)
            for _ in range(TP_FROZEN + 1)]


def replicated_equal(trainer):
    """Whether this rank's replicated parameters equal rank 1's bit for
    bit (a broadcast of one flattened buffer: both ranks call it)."""
    mine = torch.cat([p.detach().reshape(-1)
                      for n, p in trainer.model.named_parameters()
                      if n not in trainer.shards])
    theirs = mine.clone()
    torch.distributed.broadcast(theirs, 1)
    return bool(torch.equal(mine, theirs))


def tp_worker(rank, init, out, dtype):
    """One of two gloo ranks sharing cuda:0 in one model group, M = 2 (a
    subprocess of phase_tensor_parallel): the flagship train step at full
    width in `dtype` on the same batches, TP_FROZEN frozen steps, the
    flip, one more. After each step: whether the replicated parameters
    equal the peer's, and the pair (`save_train_state`, gathered; rank 0
    writes) as <dir>/tp<i>, the last one's parameters only. After the
    first, this rank's own shards and Adam state as they are, for an
    unsharded save of the same state."""
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False  # as phase_device sets them
    torch.backends.cuda.matmul.allow_tf32 = False
    distributed.initialize(init_method=init, num_processes=2, process_id=rank,
                           device=dev, backend="gloo", model_parallel=2)
    work = Path(out).parent
    try:
        cfg = tp_config(dtype)
        batches = tp_batches(cfg, dev)
        trainer = Trainer(to_torch(init_params(cfg, seed=0), cfg, dev,
                                   train=True), learning_rate=TP_LR)
        assert len(trainer.shards) == 6
        gen = torch.Generator(device=dev).manual_seed(0)
        rec = {"ms": [], "losses": [], "gen": [], "equal": []}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        for i, batch in enumerate(batches):
            if i == TP_FROZEN:
                trainer.set_finetune(True)
            rec["gen"].append(gen.get_state())
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            losses = trainer.step(batch, generator=gen)
            end.record()
            end.synchronize()
            rec["ms"].append(start.elapsed_time(end))
            rec["losses"].append({k: float(v) for k, v in losses.items()})
            rec["launches"] = dict(build.launches)
            rec["equal"].append(replicated_equal(trainer))
            prefix = str(work / f"tp{i}")
            if i < TP_FROZEN:
                save_train_state(prefix, trainer, i + 1, "{}")
            else:
                tree = from_torch(trainer.model)
                if rank == 0:
                    save_params(prefix + ".npz", tree)
                del tree
            if i == 0:
                opt = trainer.opt.state_dict()
                torch.save({
                    "params": {n: p.detach().cpu() for n, p in
                               trainer.model.named_parameters()
                               if rank == 0 or n in trainer.shards},
                    "optimizer": dict(opt, state={
                        j: {k: v.cpu() for k, v in st.items()}
                        for j, st in opt["state"].items()}),
                    "names": trainer.names}, f"{out}.shards")
        rec["peak_bytes"] = torch.cuda.max_memory_allocated()
        torch.save(rec, out)
    finally:
        distributed.shutdown()


def resumed_trainer(prefix, cfg, dev):
    model, state = load_train_state(prefix, cfg, dev)
    trainer = Trainer(model, learning_rate=TP_LR)
    trainer.load_state_dict(state)
    return trainer


def cpu_params(path, cfg):
    """An .npz's parameters by the training model's names, on the CPU."""
    model = to_torch(load_params(path)[0], cfg, "cpu", train=True)
    return {n: p.detach() for n, p in model.named_parameters()}


def worst_large_g(run, ref):
    """The parameter where two `one_step` results differ most where |g|
    of `ref` is large (step_diff's third number): (name, diff, that
    entry's |g| over its parameter's largest)."""
    worst = ("", 0.0, 0.0)
    for n, (p_ref, g_ref) in ref[1].items():
        g = g_ref.abs()
        big = g > 1e-3 * g.max()
        if not big.any():
            continue
        diff = torch.where(big, (run[1][n][0] - p_ref).abs(), 0.0).flatten()
        k = int(diff.argmax())
        if float(diff[k]) > worst[1]:
            worst = (n, float(diff[k]), float(g.flatten()[k] / g.max()))
    return worst


def unsharded_save(tmp, cfg, dev, params):
    """The pair of one unsharded Trainer holding the state the ranks
    held after their first step, joined on the host from each rank's own
    shards and Adam state (`mesh.gather_optimizer_state`), written by the
    world-1 `save_train_state` -> its prefix."""
    shards = [torch.load(f"{tmp}/rank{r}.shards", weights_only=True)
              for r in (0, 1)]
    trainer = Trainer(to_torch(params, cfg, dev, train=True),
                      learning_rate=TP_LR)
    with torch.no_grad():
        for n, p in trainer.model.named_parameters():
            parts = [s["params"][n] for s in shards if n in s["params"]]
            p.copy_(torch.cat(parts, -1) if len(parts) > 1 else parts[0])
    trainer.load_state_dict({
        "optimizer": gather_optimizer_state(
            [s["optimizer"] for s in shards], shards[0]["names"]),
        "count": 1, "finetune_cnn": False})
    prefix = f"{tmp}/unsharded"
    save_train_state(prefix, trainer, 1, "{}")
    return prefix


def tp_run(dev, params, dtype):
    """The two ranks at `dtype` (tp_worker), then each of their steps
    from the same state in one unsharded process, and the second step
    from their first pair and from the unsharded save of the same state.
    -> (the ranks' records, each step's step_diff, the resumed steps'
    difference, its floor)."""
    cfg = tp_config(dtype)
    work = ROOT / "build"
    work.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        t0 = time.perf_counter()
        saved = run_ranks("--tp_rank", tmp, 900, "--tp_dtype", dtype)
        wall = time.perf_counter() - t0
        for s in saved:
            need_launches(s["launches"], ("conv_pool", "roi_align",
                                          "roi_align_bwd",
                                          "roi_align_bwd_feats"),
                          "tensor parallel")
        for r, s in enumerate(saved):
            print(f"[tensor parallel] {dtype} rank {r} (gloo, cuda:0, "
                  f"M = 2; {wall:.1f} s with the processes' start): ms per "
                  f"step {', '.join(f'{t:.1f}' for t in s['ms'])}; peak "
                  f"device memory {s['peak_bytes'] / 2**30:.2f} GiB; "
                  f"replicated parameters equal to rank 1's after each "
                  f"step {s['equal']}; launches {s['launches']}")
        batches = tp_batches(cfg, dev)
        errs, after_first = [], None
        for i, batch in enumerate(batches):
            trainer = (resumed_trainer(f"{tmp}/tp{i - 1}", cfg, dev) if i
                       else Trainer(to_torch(params, cfg, dev, train=True),
                                    learning_rate=TP_LR))
            if i == TP_FROZEN:
                trainer.set_finetune(True)
            gen = torch.Generator(device=dev)
            gen.set_state(saved[0]["gen"][i])
            ref = one_step(trainer, batch, dev, generator=gen)
            del trainer
            got = (saved[0]["losses"][i],
                   {n: (p, None) for n, p in
                    cpu_params(f"{tmp}/tp{i}.npz", cfg).items()})
            errs.append(step_diff(got, ref))
            name, diff, share = worst_large_g(got, ref)
            print(f"[tensor parallel] {dtype} step {i + 1} "
                  f"({'finetune' if i >= TP_FROZEN else 'frozen'}) against "
                  f"one unsharded process from the same state: "
                  f"{describe(errs[-1], TP_LR, TP_LARGE_G[dtype])} (at "
                  f"{name}, |g| "
                  f"{share:.1e} of its largest); total_loss "
                  f"{saved[0]['losses'][i]['total_loss']:.6f} vs "
                  f"{ref[0]['total_loss']:.6f}")
            if i == 1:
                after_first = {n: p for n, (p, _) in ref[1].items()}
            del ref, got
        # the second step from the ranks' first pair, again (the floor),
        # and from the unsharded save of the same state
        ends = []
        for prefix in (f"{tmp}/tp0", unsharded_save(tmp, cfg, dev, params)):
            trainer = resumed_trainer(prefix, cfg, dev)
            gen = torch.Generator(device=dev)
            gen.set_state(saved[0]["gen"][1])
            ends.append({n: p for n, (p, _) in
                         one_step(trainer, batches[1], dev,
                                  generator=gen)[1].items()})
            del trainer
    floor = max_diff(ends[0], after_first)
    err = max_diff(ends[1], after_first)
    print(f"[tensor parallel] {dtype}: the ranks' pair after step 1 resumed "
          f"at world 1, step 2 from it against from the unsharded save of "
          f"the same state: max parameter diff {err:.3e} (floor, two loads "
          f"of the ranks' pair: {floor:.3e})")
    return saved, errs, err, floor, wall


def phase_tensor_parallel(dev, params):
    """Tensor parallelism (`--model_parallel`): two gloo ranks in
    subprocesses sharing cuda:0 (NCCL refuses two ranks on one GPU) form
    one model group, M = 2, data axis 1, at the flagship's full width
    (V+1 = 10 001 columns split 5001 + 5000, B = 8 540x720 frames, K3 on,
    dropout 0.5, lr 1e-5): TP_FROZEN frozen steps, the flip, one more
    (tp_worker), first in f32 and then in bf16. Each step is held to one
    unsharded process's step on the same batch from the same state (the
    pair the ranks wrote before it, the same generator state). Checks, in
    both dtypes: the ranks' replicated parameters bit-equal after every
    step and their losses equal; each rank launched K3, K2 and both K2b
    instances; every step within the [train reference] bounds, where |g|
    is large within TP_LARGE_G of its dtype; the pair the ranks wrote
    after their first step, loaded into a world-1 Trainer, takes the next
    step within the floor of two such loads (0 on a frozen step:
    bit-equal) of one resumed from the unsharded save of the same state.
    gloo moves every collective through the host, so the ranks' ms/step
    show correctness, not speed. Returns the bf16 run's rank 0 launches
    and a summary."""
    summary, ok = {}, True
    for dtype in TP_DTYPES:
        saved, errs, err, resume_floor, wall = tp_run(dev, params, dtype)
        torch.cuda.empty_cache()
        equal = (all(all(s["equal"]) for s in saved)
                 and saved[0]["losses"] == saved[1]["losses"])
        within = all(within_reference(e, TP_LR, TP_LARGE_G[dtype])
                     for e in errs)
        print(f"[tensor parallel] {dtype}: ranks bit-equal={equal}; every "
              f"step within the [train reference] bounds of one process "
              f"(where |g| is large {TP_LARGE_G[dtype]:.2e})={within}; "
              f"resumed step {err:.3e} (floor {resume_floor:.3e})")
        ok &= equal and within and err <= resume_floor
        summary[dtype] = {"ms_per_step": [s["ms"] for s in saved],
                          "peak_bytes": [s["peak_bytes"] for s in saved],
                          "step_errs": errs, "resume_err": err,
                          "resume_floor": resume_floor, "wall_s": wall}
    if not ok:
        raise AssertionError("[tensor parallel] the model group disagrees "
                             "with one unsharded process")
    return saved[0]["launches"], summary


def device_kernels(prof):
    """{kernel or copy name: (device us, calls)} of a torch.profiler run,
    without user annotations (their spans cover the kernels inside)."""
    out = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            us, n = out.get(e.name, (0.0, 0))
            out[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    return out


def phase_profile(dev, params, steps=3):
    """torch.profiler over `steps` flagship frozen train steps on the
    720x720 square and `steps` on the 544x720 bucket (traces under
    build/profile): device time per step of each, the square's top 8
    CUDA kernels by time with the bucket's time for the same kernel, and
    a StageTimer report of each."""
    cfg = FLAGSHIP.replace(fuse_conv_pool=True)
    rng = np.random.default_rng(18)
    batches = [make_train_batch(rng, cfg, B, (540, 720), 30)
               for _ in range(steps + 1)]
    trainer = Trainer(to_torch(params, cfg, dev, train=True),
                      learning_rate=1e-5)
    gen = torch.Generator(device=dev).manual_seed(0)
    runs = {}
    for kind, (bh, bw) in (("square", (cfg.image_size,) * 2),
                           ("bucket", BUCKET)):
        crop = [dict(b, image=b["image"][:, :bh, :bw].contiguous())
                for b in batches]
        trainer.step(to_dev(crop[0], dev), generator=gen)  # warm-up
        timer = StageTimer()
        trace_dir = ROOT / "build" / "profile" / kind
        with device_trace(str(trace_dir), cuda=True) as prof:
            for b in crop[1:]:
                with timer.stage("data"):
                    b = to_dev(b, dev)
                    torch.cuda.synchronize()
                with timer.stage("step"):
                    trainer.step(b, generator=gen)
                    torch.cuda.synchronize()
        kern = device_kernels(prof)
        device_ms = sum(us for us, _ in kern.values()) / 1e3 / steps
        wall_ms = timer.times["step"] * 1e3 / steps
        runs[kind] = {"kernels": kern, "device_ms_per_step": device_ms,
                      "step_ms": wall_ms, "report": timer.report(),
                      "traces": sorted(p.name for p in
                                       trace_dir.glob("*.pt.trace.json"))}
        print(f"[profile] {kind} {bh}x{bw}: {steps} flagship frozen train "
              f"steps (B={B}, 540x720 frames, bf16, K3 on) under "
              f"torch.profiler: {len(kern)} CUDA kernels and copies, "
              f"{device_ms:.2f} ms device time per step of {wall_ms:.2f} ms "
              f"wall (busy {device_ms / wall_ms:.1%}); {timer.report()}; "
              f"trace {runs[kind]['traces']}")
    sq, bk = runs["square"]["kernels"], runs["bucket"]["kernels"]
    top = []
    for name, (us, n) in sorted(sq.items(), key=lambda kv: -kv[1][0])[:8]:
        ms, b_ms = us / 1e3 / steps, bk.get(name, (0.0, 0))[0] / 1e3 / steps
        top.append({"kernel": name[:120], "ms_per_step": ms,
                    "calls_per_step": n / steps, "bucket_ms_per_step": b_ms})
        print(f"[profile]   {ms:7.3f} ms/step (bucket {b_ms:7.3f}) "
              f"{n / steps:6.1f} calls "
              f"{ms / runs['square']['device_ms_per_step']:6.1%}  "
              f"{name[:100]}")
    if not all(r["kernels"] and r["traces"] for r in runs.values()):
        raise AssertionError("torch.profiler recorded no CUDA kernel")
    return {"top": top, **{k: {f: r[f] for f in ("device_ms_per_step",
                                                 "step_ms", "report")}
                           for k, r in runs.items()}}


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
    memory (the card machine has no h5py), with the metadata protocol
    that BucketedLoader schedules from. Every split is the one list."""

    def __init__(self, examples, vocab):
        self.examples = examples
        self.vocab = vocab
        self.pos = 0
        self.canvas = examples[0]["image"].shape[0]

    def example_meta(self, split, ri):
        ex = self.examples[ri]
        return int(ex["height"]), int(ex["width"])

    def get_example_at(self, split, ri):
        return self.examples[ri]

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


def eval_examples(cfg, n=20, sizes=None, seed=9):
    """n uint8 canvases with 1-30 gt boxes and captions each, from a
    seed, as loader examples: frames of `sizes` in turn, by default
    landscape and portrait 3:4 (540x720 and 720x540 at 720 px)."""
    rng = np.random.default_rng(seed)
    S = cfg.image_size
    sizes = sizes or ((S * 3 // 4, S), (S, S * 3 // 4))
    parts = [make_train_batch(rng, cfg, -(-n // len(sizes)), hw, 30)
             for hw in sizes]
    examples = []
    for i in range(n):
        batch, j = parts[i % len(sizes)], i // len(sizes)
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


def same_answer(x, y):
    """Two engines' answers to one frame agree: captions equal, boxes
    within rtol 1e-4 / atol 1e-3 (the JAX mesh engine's test)."""
    return (x["captions"] == y["captions"]
            and np.allclose(x["boxes"], y["boxes"], rtol=1e-4, atol=1e-3))


# The runs of [data parallel]: replicas on cuda:0 and the batch size. Two
# replicas at batch 8 run shards of 4, and a forward at 4 images may take
# other cuDNN / cuBLAS kernels than one at 8 (on an H100 the detmap over
# 20 eval frames moved from 0.00380301 at batch 8 to 0.00380823 over the
# shards), so eval over the replicas is held to one replica at batch 4,
# the same forwards; batch 8 on one replica is the speed baseline.
DP_RUNS = {"1x8": (1, 8), "2x8": (2, 8), "1x4": (1, 4)}
DP_ORDER = ("1x8", "2x8", "2x8", "1x8")


def phase_data_parallel(dev, model, params, vocab):
    """--data_parallel's paths with two replicas on the one card (each its
    own thread and stream): eval_split over 24 eval frames (every shard 4
    frames) and the engine on 32 concurrent 720x540 frames, at batch 8
    with one replica and with two, in turns. Eval over the replicas must
    give one replica's map and detmap at batch 4. The engine's batches
    form by arrival, and a request's answer depends on which frames share
    its batch (bf16 rounding, at full width with random weights), so
    every shard the replicas ran is recomputed by the model alone and
    must be bit-equal; the per-request agreement is printed. Two replicas
    on one card share its host and device; the rates are written down,
    not claimed."""
    loader = MemoryLoader(eval_examples(model.cfg, n=24), vocab)
    n = loader.split_size(1)
    aps, eval_rate, counts = {}, {}, {}
    for tag in DP_ORDER + ("1x4",):
        reps, bs = DP_RUNS[tag]
        t0 = time.perf_counter()
        res, c = read_launches(lambda: eval_split(
            model, loader, split=1, batch_size=bs, verbose=False,
            compute_losses=False, devices=[dev] * reps))
        eval_rate.setdefault(tag, []).append(n / (time.perf_counter() - t0))
        aps[tag] = res["ap_results"]
        counts.setdefault(tag, c)
        need_launches(c, ("nms", "roi_align"), f"eval data parallel ({tag})")
    print(f"[data parallel] eval_split, {n} frames, images/s (host clock, "
          f"evaluator included; replicas x batch, order "
          f"{DP_ORDER + ('1x4',)}): "
          f"{ {k: [round(v, 2) for v in r] for k, r in eval_rate.items()} }; "
          f"map / detmap "
          f"{ {k: (a['map'], a['detmap']) for k, a in aps.items()} }; "
          f"launches {counts['1x8']} / {counts['2x8']}")
    if not all(abs(aps["1x4"][k] - aps["2x8"][k]) <= 1e-6
               for k in ("map", "detmap")):
        raise AssertionError("eval over two replicas disagrees with one "
                             "replica at the shards' batch")

    rng = np.random.default_rng(4)
    frames = [rng.integers(0, 256, (540, 720, 3), dtype=np.uint8)
              for _ in range(32)]
    engines = {tag: InferenceEngine(params, model.cfg, vocab, device=dev,
                                    batch_size=DP_RUNS[tag][1],
                                    batch_window_ms=50.0,
                                    devices=[dev] * DP_RUNS[tag][0])
               for tag in ("1x8", "2x8")}
    eng = engines["2x8"]
    shards = []

    def recorded(m, x, hs, ws):
        """The engine's pack, keeping each shard's inputs and output."""
        out = InferenceEngine._pack(m, x, hs, ws)
        shards.append((x.cpu(), hs.cpu(), ws.cpu(), out.cpu()))
        return out

    try:
        assert eng.replicas is not None
        for e in engines.values():
            e.warmup()
            timed_batch(e, frames[:16])
        rate, answers, engine_counts = {}, {}, {}
        for tag in DP_ORDER:
            (wall, results), c = read_launches(
                lambda: timed_batch(engines[tag], frames))
            rate.setdefault(tag, []).append(len(frames) / wall)
            answers.setdefault(tag, []).append(results)
            engine_counts.setdefault(tag, c)
            need_launches(c, ("nms", "roi_align"),
                          f"engine data parallel ({tag})")
        eng._pack = recorded
        _, results = timed_batch(eng, frames)
        answers["2x8"].append(results)
        with torch.inference_mode():
            exact = [torch.equal(InferenceEngine._pack(
                eng.model, x.to(dev), h.to(dev), w.to(dev)).cpu(), out)
                for x, h, w, out in shards]
    finally:
        for e in engines.values():
            e.close()
    for r in answers["2x8"][-1]:
        check_result(r, eng.max_boxes)
    agree = {k: sum(map(same_answer, a, b)) for k, (a, b) in {
        "1x8 run 2 vs run 1": answers["1x8"],
        "2x8 vs 1x8": (answers["1x8"][0], answers["2x8"][0])}.items()}
    print(f"[data parallel] engine, 32 concurrent 720x540 frames, images/s "
          f"(replicas x batch, order {DP_ORDER}): "
          f"{ {k: [round(v, 2) for v in r] for k, r in rate.items()} }; "
          f"shards the replicas ran, bit-equal to the model alone on the "
          f"same shard: {sum(exact)} of {len(exact)}; requests answered "
          f"alike (captions equal, boxes rtol 1e-4 atol 1e-3): {agree} of "
          f"{len(frames)}; launches {engine_counts['1x8']} / "
          f"{engine_counts['2x8']}")
    if not (exact and all(exact)
            and sum(len(x) for x, *_ in shards) >= len(frames)):
        raise AssertionError("a replica's shard differs from the model's "
                             "own answer on it")
    return counts["2x8"], engine_counts["2x8"], {
        "eval_images_per_s": eval_rate, "engine_images_per_s": rate,
        "engine_requests_alike": agree,
        "engine_shards_exact": [sum(exact), len(exact)],
        "eval_map_detmap": {k: (a["map"], a["detmap"])
                            for k, a in aps.items()}}


class T7Writer:
    """Torch7's binary serialization, the subset a DenseCap checkpoint
    uses (numbers, booleans, strings, tables from dicts and lists, float32
    tensors, torch objects), streamed to a file: the inverse of
    `utils.t7_reader`."""

    def __init__(self, f):
        self.f = f
        self.memo = 0

    def _i32(self, v):
        self.f.write(struct.pack("<i", v))

    def _i64(self, v):
        self.f.write(struct.pack("<q", v))

    def _str(self, s):
        raw = s.encode()
        self._i32(len(raw))
        self.f.write(raw)

    def _torch(self, cls):
        self._i32(t7_reader.TYPE_TORCH)
        self.memo += 1
        self._i32(self.memo)
        self._str("V 1")
        self._str(cls)

    def write(self, obj):
        if isinstance(obj, bool):
            self._i32(t7_reader.TYPE_BOOLEAN)
            self._i32(int(obj))
        elif isinstance(obj, (int, float)):
            self._i32(t7_reader.TYPE_NUMBER)
            self.f.write(struct.pack("<d", float(obj)))
        elif isinstance(obj, str):
            self._i32(t7_reader.TYPE_STRING)
            self._str(obj)
        elif isinstance(obj, (dict, list)):
            items = (obj.items() if isinstance(obj, dict)
                     else enumerate(obj, start=1))
            self._i32(t7_reader.TYPE_TABLE)
            self.memo += 1
            self._i32(self.memo)
            self._i32(len(obj))
            for k, v in items:
                self.write(k)
                self.write(v)
        elif isinstance(obj, np.ndarray):
            arr = np.ascontiguousarray(obj, np.float32)
            self._torch("torch.FloatTensor")
            self._i32(arr.ndim)
            for v in arr.shape:
                self._i64(v)
            for v in arr.strides:
                self._i64(v // 4)
            self._i64(1)  # 1-based storage offset
            self._torch("torch.FloatStorage")
            self._i64(arr.size)
            self.f.write(arr.data)
        elif isinstance(obj, t7_reader.TorchObject):
            self._torch(obj.torch_class)
            self.write(obj.fields)
        else:
            raise TypeError(f"T7Writer: cannot write {type(obj)}")


VGG16_CONVS = (("conv1_1", 3, 64), ("conv1_2", 64, 64), ("conv2_1", 64, 128),
               ("conv2_2", 128, 128), ("conv3_1", 128, 256),
               ("conv3_2", 256, 256), ("conv3_3", 256, 256),
               ("conv4_1", 256, 512), ("conv4_2", 512, 512),
               ("conv4_3", 512, 512), ("conv5_1", 512, 512),
               ("conv5_2", 512, 512), ("conv5_3", 512, 512))


def reference_t7(cfg, seed=0):
    """A full-width DenseCap checkpoint in the reference's module layout
    (DenseCapModel, LocalizationLayer's RPN, LanguageModel with a
    torch-rnn LSTM), weights from `seed`: (checkpoint object, {name:
    torch-layout array})."""
    rng = np.random.default_rng(seed)
    raw = {}

    def obj(cls, **fields):
        return t7_reader.TorchObject(cls, fields)

    def seq(*mods):
        return obj("nn.Sequential", modules=list(mods))

    def normal(shape, std):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    def conv(name, cin, cout, k, std):
        raw[name + ".weight"] = normal((cout, cin, k, k), std)
        raw[name + ".bias"] = normal(cout, 0.01)
        return obj("cudnn.SpatialConvolution", weight=raw[name + ".weight"],
                   bias=raw[name + ".bias"], kW=k, kH=k, nInputPlane=cin,
                   nOutputPlane=cout)

    def linear(name, cin, cout, std):
        raw[name + ".weight"] = normal((cout, cin), std)
        raw[name + ".bias"] = normal(cout, 0.01)
        return obj("nn.Linear", weight=raw[name + ".weight"],
                   bias=raw[name + ".bias"])

    def vgg(names):
        mods = []
        for name, cin, cout in VGG16_CONVS:
            if name in names:
                mods += [conv(name, cin, cout, 3, (2 / (9 * cin)) ** 0.5),
                         obj("cudnn.ReLU")]
                if name in ("conv1_2", "conv2_2", "conv3_3", "conv4_3"):
                    mods.append(obj("cudnn.SpatialMaxPooling", kW=2, kH=2))
        return seq(*mods)

    k, nf, F, V = (cfg.num_anchors, cfg.rpn_num_filters, cfg.fc_dim,
                   cfg.vocab_size)
    W, H = cfg.rnn_encoding_size, cfg.rnn_size
    names = [n for n, _, _ in VGG16_CONVS]
    rpn = seq(conv("rpn_conv", 512, nf, 3, 0.01), obj("cudnn.ReLU"),
              obj("nn.ConcatTable", modules=[
                  seq(conv("rpn_box", nf, 4 * k, 1, 0.01),
                      obj("nn.RegularizeLayer"), obj("nn.ReshapeBoxFeatures")),
                  seq(conv("rpn_score", nf, 2 * k, 1, 0.01),
                      obj("nn.ReshapeBoxFeatures"))]),
              obj("nn.FlattenTable"))
    raw["lm_lookup.weight"] = normal((V + 2, W), 0.1)
    raw["lm_lstm.weight"] = normal((W + H, 4 * H), (1 / H) ** 0.5)
    raw["lm_lstm.bias"] = normal(4 * H, 0.1)
    lm = obj("nn.LanguageModel",
             image_encoder=seq(linear("lm_image_encoder", F, W,
                                      (1 / F) ** 0.5),
                               obj("nn.ReLU"), obj("nn.View")),
             lookup_table=obj("nn.LookupTable",
                              weight=raw["lm_lookup.weight"]),
             rnn=seq(obj("nn.LSTM", weight=raw["lm_lstm.weight"],
                         bias=raw["lm_lstm.bias"]),
                     obj("nn.View"), linear("lm_proj", H, V + 1,
                                            (1 / H) ** 0.5),
                     obj("nn.View")),
             idx_to_token={i: f"w{i}" for i in range(1, V + 1)})
    model = obj("DenseCapModel", nets={
        "conv_net1": vgg(names[:4]), "conv_net2": vgg(names[4:]),
        "recog_base": seq(obj("nn.View"),
                          linear("fc6", 7 * 7 * 512, F, (2 / 25088) ** 0.5),
                          obj("cudnn.ReLU"), obj("nn.Dropout"),
                          linear("fc7", F, F, (2 / F) ** 0.5),
                          obj("cudnn.ReLU"), obj("nn.Dropout")),
        "localization_layer": obj("nn.LocalizationLayer", nets={"rpn": rpn}),
        "objectness_branch": linear("objectness", F, 1, 0.01),
        "box_reg_branch": linear("box_reg", F, 4, 0.001),
        "language_model": lm})
    return {"model": model, "iter": 0}, raw


def max_rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def t7_checks(dev, params, cfg, raw):
    """The converted weights on the card, in f32, against the reference's
    computations over the raw torch-layout weights: trunk1 (conv1_1 ..
    pool2) against F.conv2d chains, the RPN against its convs and the
    ReshapeBoxFeatures order, fc6 against the NCHW-flattened product, and
    one LSTM step against torch-rnn's fused (i, f, o, g) cell. -> max
    error of each, relative to the reference's largest entry."""
    import torch.nn.functional as F

    m = to_torch(params, cfg.replace(compute_dtype=torch.float32), dev)
    g = torch.Generator(device=dev).manual_seed(0)
    r = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
    errs = {}
    with torch.inference_mode():
        x = torch.randn((2, 3, 64, 64), generator=g, device=dev) * 50
        full = torch.full((2,), 64.0, device=dev)
        got = m.trunk1(x.contiguous(memory_format=torch.channels_last),
                       full, full)
        ref = x
        for name in ("conv1_1", "conv1_2", "M", "conv2_1", "conv2_2", "M"):
            ref = (F.max_pool2d(ref, 2, 2) if name == "M" else torch.relu(
                F.conv2d(ref, r[name + ".weight"], r[name + ".bias"],
                         padding=1)))
        errs["trunk1"] = max_rel(got, ref)

        feats = torch.randn((1, 512, 20, 24), generator=g, device=dev)
        out = m.rpn(feats, cfg.anchor_tensor(dev), cfg.field_centers)
        hid = torch.relu(F.conv2d(feats, r["rpn_conv.weight"],
                                  r["rpn_conv.bias"], padding=1))
        k = cfg.num_anchors
        for name, got in (("rpn_box", out.trans), ("rpn_score", out.scores)):
            y = F.conv2d(hid, r[name + ".weight"], r[name + ".bias"])[0]
            D = y.shape[0] // k  # (D * k, H, W) -> (k * H * W, D), k-major
            ref = y.reshape(k, D, 20, 24).permute(0, 2, 3, 1).reshape(-1, D)
            errs[name] = max_rel(got[0], ref)

        roi = torch.randn((16, 7, 7, 512), generator=g, device=dev)
        got = m.recog.fc6(roi.reshape(16, -1), torch.float32)
        ref = (roi.permute(0, 3, 1, 2).reshape(16, -1) @ r["fc6.weight"].T
               + r["fc6.bias"])
        errs["fc6"] = max_rel(got, ref)

        W = cfg.rnn_encoding_size
        xt, h, c = (torch.randn((16, n), generator=g, device=dev)
                    for n in (W, cfg.rnn_size, cfg.rnn_size))
        h2, c2 = m.lm.lstm_step(h, c, xt)
        gates = (xt @ r["lm_lstm.weight"][:W] + h @ r["lm_lstm.weight"][W:]
                 + r["lm_lstm.bias"])
        i, f, o, gg = gates.chunk(4, dim=-1)
        c_ref = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        h_ref = torch.sigmoid(o) * torch.tanh(c_ref)
        errs["lstm_step"] = max(max_rel(h2, h_ref), max_rel(c2, c_ref))
    del m
    torch.cuda.empty_cache()
    return errs


def phase_t7(dev):
    """The reference's checkpoint path at full width: a DenseCap t7 written
    from seed 0 (VGG-16, fc 4096, RPN 256 filters, LSTM 512, vocab
    10 000, ~0.58 GB), `cli/convert_t7.main` to the shared .npz,
    `load_checkpoint`, the converted weights held to the raw ones on the
    card, and the engine at the flagship geometry on the converted
    model, K1 and K2 counted."""
    from densecap_tpu_torch.cli import convert_t7
    from densecap_tpu_torch.utils.checkpoint import load_checkpoint

    work = ROOT / "build"
    work.mkdir(exist_ok=True)
    secs = {}
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        t7 = Path(tmp) / "densecap.t7"
        t0 = time.perf_counter()
        obj, raw = reference_t7(FLAGSHIP, seed=0)
        with open(t7, "wb") as f:
            T7Writer(f).write(obj)
        del obj
        secs["write"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = t7_reader.load(str(t7))
        secs["read"] = time.perf_counter() - t0
        n_floats = sum(v.size for v in t7_reader.extract_full_densecap_weights(
            loaded).values())
        del loaded
        t0 = time.perf_counter()
        convert_t7.main(["--t7", str(t7), "--output",
                         str(Path(tmp) / "p.npz")])
        secs["convert"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        params, meta, cfg = load_checkpoint(str(Path(tmp) / "p.npz"))
        secs["load"] = time.perf_counter() - t0
        gb = t7.stat().st_size / 1e9
    print(f"[t7] wrote a full-width reference-layout t7 ({n_floats} floats, "
          f"{gb:.3f} GB) in {secs['write']:.2f} s, read it in "
          f"{secs['read']:.2f} s, convert_t7 (read, extract, convert, save "
          f".npz) {secs['convert']:.2f} s, load_checkpoint "
          f"{secs['load']:.2f} s (host clock)")
    if cfg != FLAGSHIP:
        raise AssertionError(f"the converted config is not the flagship's: "
                             f"{cfg}")
    errs = t7_checks(dev, params, cfg, raw)
    print(f"[t7] converted weights on the card against the raw torch-layout "
          f"ones (f32, max error relative to the reference's largest "
          f"entry, tol 1e-4): {errs}")
    if not all(e <= 1e-4 for e in errs.values()):
        raise AssertionError(f"a converted layer disagrees with the raw "
                             f"weights: {errs}")
    del raw
    vocab = meta["idx_to_token"]
    rng = np.random.default_rng(15)
    frames = [rng.integers(0, 256, (540, 720, 3), dtype=np.uint8)
              for _ in range(16)]
    engine = InferenceEngine(params, cfg, vocab, device=dev, batch_size=8,
                             batch_window_ms=50.0)
    try:
        engine.warmup()
        (wall, results), counts = read_launches(
            lambda: timed_batch(engine, frames))
    finally:
        engine.close()
    words = set(vocab.values())
    for r in results:
        check_result(r, engine.max_boxes)
    ok = (all(len(r["boxes"]) for r in results)
          and all(set(c.split()) <= words for r in results
                  for c in r["captions"]))
    print(f"[t7] engine on the converted model, batch 8, 16 concurrent "
          f"720x540 frames: {len(frames) / wall:.2f} images/s; boxes per "
          f"frame {[len(r['boxes']) for r in results[:8]]}; captions from "
          f"the checkpoint's vocabulary={ok}; launches {counts}")
    need_launches(counts, ("nms", "roi_align"), "t7 engine")
    if not ok:
        raise AssertionError("the converted model's answers are malformed")
    return counts, secs


def phase_run_model(dev, params, vocab, native):
    """The run_model CLI on 8 JPEG frames and a full-width checkpoint, with
    the native JPEG pipeline (--native_io 1, the default; PIL when
    `native` says libdcio did not build) and with --native_io 0: the same
    detections, and each decode path's host time per image."""
    from densecap_tpu_torch.cli import run_model

    sizes = [(540, 720), (720, 540), (480, 640), (600, 800)] * 2
    work = ROOT / "build"
    work.mkdir(exist_ok=True)
    runs, counts, wall = {}, {}, {}
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        tmp = Path(tmp)
        write_jpegs(tmp / "frames", sizes, seed=11)
        t0 = time.perf_counter()
        meta = json.dumps({"vocab_size": FLAGSHIP.vocab_size,
                           "seq_length": FLAGSHIP.seq_length,
                           "idx_to_token": {str(k): v
                                            for k, v in vocab.items()},
                           "config": FLAGSHIP.to_json()})
        save_params(tmp / "ck.npz", params, extra={"meta": meta})
        mb = (tmp / "ck.npz").stat().st_size / 2**20
        t1 = time.perf_counter()
        for flag in ("1", "0"):
            t2 = time.perf_counter()
            _, counts[flag] = read_launches(lambda: run_model.main([
                "--checkpoint", str(tmp / "ck.npz"), "--input_dir",
                str(tmp / "frames"), "--output_dir", str(tmp / flag),
                "--image_size", str(FLAGSHIP.image_size), "--num_proposals",
                str(FLAGSHIP.test_max_proposals), "--native_io", flag,
                "--device", dev.type]))
            wall[flag] = time.perf_counter() - t2
            with open(tmp / flag / "results.json") as f:
                runs[flag] = json.load(f)["results"]
        paths = sorted(str(p) for p in (tmp / "frames").iterdir())
        decode_s = {}
        for name, frames in (("pil", run_model.pil_frames),
                             ("native", run_model.native_frames)):
            if name == "native" and native.get("dcio") != "built":
                continue
            t2 = time.perf_counter()
            n = len(list(frames(paths, FLAGSHIP.image_size)))
            decode_s[name] = (time.perf_counter() - t2) / n
    results = runs["1"]
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
    same = [r["img_name"] for r in runs["0"]] == [
        r["img_name"] for r in results] and all(
        a["captions"] == b["captions"]
        and np.allclose(a["boxes"], b["boxes"], rtol=1e-5, atol=1e-3)
        and np.allclose(a["scores"], b["scores"], rtol=1e-5, atol=1e-5)
        for a, b in zip(results, runs["0"]))
    decoder = ("native decode" if native.get("dcio") == "built"
               else "PIL: libdcio unavailable")
    print(f"[run_model] CLI on 8 JPEGs, full-width checkpoint ({mb:.0f} MiB, "
          f"written in {t1 - t0:.1f} s): {wall['1']:.1f} s for load + 8 "
          f"images with --native_io 1 ({decoder}), {wall['0']:.1f} s with "
          f"--native_io 0; results.json entries {len(results)}, boxes per "
          f"image {[len(r['boxes']) for r in results]}, inside each frame "
          f"(2 px margin) with string captions={ok}; "
          f"launches {counts['1']} / {counts['0']}")
    print(f"[native] run_model --native_io 1 against 0: same detections="
          f"{same}; host decode + canvas seconds per image "
          f"{ {k: round(v, 6) for k, v in decode_s.items()} } (8 JPEGs, "
          f"540x720 to 600x800, into the {FLAGSHIP.image_size} px canvas)")
    for flag in counts:
        need_launches(counts[flag], ("nms", "roi_align"),
                      f"run_model --native_io {flag}")
    if not (ok and same):
        raise AssertionError("run_model's results.json is wrong")
    return counts["1"], counts["0"], decode_s


INT8_TOPS = 1979.0  # H100 SXM data sheet: dense int8 tensor-core peak
FC_SHAPES = {"fc6": 7 * 7 * 512, "fc7": 4096}  # K of each layer; N = 4096


class ProductCount(torch.overrides.TorchFunctionMode):
    """Records each matrix product's function and operand shapes."""

    PRODUCTS = {"mm", "matmul", "__matmul__", "_int_mm", "addmm", "bmm",
                "linear"}

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in self.PRODUCTS:
            self.calls.append((name, tuple(tuple(a.shape) for a in args
                                           if isinstance(a, torch.Tensor))))
        return func(*args, **(kwargs or {}))


def as_ms(v):
    return f"{v:.4f} ms" if isinstance(v, float) else str(v)


def fc_products(calls):
    """The products among `calls` whose operand is an fc6 / fc7 weight."""
    weights = {(k, 4096) for k in FC_SHAPES.values()}
    return [name for name, shapes in calls if weights & set(shapes)]


def phase_int8(dev, params):
    """int8 W8A8 fc6 / fc7 at the flagship shapes (B x 1000 RoIs = 8000
    rows): torch._int_mm held exactly to a float64 product of the same
    codes, both layouts of its second operand, the quantize / product /
    dequant split, and int8 fc6+fc7 against bf16 on the same features."""
    M = B * FLAGSHIP.test_max_proposals
    g = torch.Generator(device=dev).manual_seed(13)
    # RoI features as K2 leaves them (ReLU'd maps), in the compute dtype
    x = torch.randn((M, FC_SHAPES["fc6"]), generator=g, device=dev).abs_()
    x = x.bfloat16()
    rec = params["recog"]
    qlayers = {n: quant.QuantLinear(quant.quantize_linear(rec[n]), dev)
               for n in FC_SHAPES}
    blayers = {n: Linear(torch.from_numpy(rec[n]["w"]).to(dev, torch.bfloat16),
                         torch.from_numpy(rec[n]["b"]).to(dev))
               for n in FC_SHAPES}
    out = {"rows": M}
    with torch.inference_mode():
        q6 = qlayers["fc6"]
        x_q, sx = quant.quantize_rows(x)
        acc = quant.int_mm(x_q, q6)
        ref = x_q.double() @ q6.w_qt.t().double()  # integer sums: exact
        exact = bool(torch.equal(acc.double(), ref))
        del ref
        # the second operand column-major (QuantLinear's layout) or row-major
        col = q6.w_qt.t()
        row = col.contiguous()
        try:
            row_same = bool(torch.equal(torch._int_mm(x_q, row), acc))
            layout_ms = {"row-major": cuda_ms(lambda: torch._int_mm(x_q, row))}
        except RuntimeError as e:
            row_same, layout_ms = None, {"row-major": f"refused: {e}"}
        layout_ms["column-major"] = cuda_ms(lambda: torch._int_mm(x_q, col))
        del row
        split = {"quantize": cuda_ms(lambda: quant.quantize_rows(x)),
                 "int_mm": layout_ms["column-major"],
                 "dequant": cuda_ms(lambda: quant.dequantize(acc, sx, q6))}
        h7 = torch.relu(quant.dequantize(acc, sx, q6)).bfloat16()
        x7_q, sx7 = quant.quantize_rows(h7)
        split["fc7 quantize"] = cuda_ms(lambda: quant.quantize_rows(h7))
        split["fc7 int_mm"] = cuda_ms(
            lambda: quant.int_mm(x7_q, qlayers["fc7"]))
        del acc, x_q, h7, x7_q
        feats = x.view(M, 7, 7, 512)
        recog = {"bf16": Recog(blayers["fc6"], blayers["fc7"], torch.bfloat16),
                 "int8": Recog(qlayers["fc6"], qlayers["fc7"], torch.bfloat16)}
        codes, fc_calls = {}, {}
        for k, r in recog.items():
            with ProductCount() as tape:
                codes[k] = r(feats)
            fc_calls[k] = fc_products(tape.calls)
        rel = float((codes["int8"] - codes["bf16"]).norm()
                    / codes["bf16"].norm())
        del codes
        ms = {k: [] for k in recog}
        for k in ("bf16", "int8", "int8", "bf16"):
            ms[k].append(cuda_ms(lambda: recog[k](feats)))
    bounds = {}
    for n, K in FC_SHAPES.items():
        ops = 2 * M * K * 4096
        bounds[f"{n} int8"] = bound_ms(M * K + K * 4096 + M * 4096 * 4, ops,
                                       INT8_TOPS)
        bounds[f"{n} bf16"] = bound_ms(M * K * 2 + K * 4096 * 2 + M * 4096 * 4,
                                       ops, H100_BF16_TFLOPS)
    # the quantize pass: bf16 in, int8 codes and f32 scales out
    bounds["fc6 quantize"] = bound_ms(M * FC_SHAPES["fc6"] * 3 + M * 4, 0, 1)
    bounds["fc6 dequant"] = bound_ms(M * 4096 * 8, 0, 1)
    print(f"[int8] fc6 {M}x{FC_SHAPES['fc6']}x4096: torch._int_mm equal to a "
          f"float64 product of the same codes={exact}; second operand "
          f"column-major {layout_ms['column-major']:.4f} ms, row-major "
          f"{as_ms(layout_ms['row-major'])} (same result={row_same}); bound "
          f"{bounds['fc6 int8'][0]:.4f} ms "
          f"({bounds['fc6 int8'][1]}, {INT8_TOPS:.0f} TOPS) against bf16's "
          f"{bounds['fc6 bf16'][0]:.4f} ms ({H100_BF16_TFLOPS:.0f} TFLOP/s)")
    print(f"[int8] split per fc6 call (CUDA events, median of 10): quantize "
          f"{split['quantize']:.4f} ms (bound {bounds['fc6 quantize'][0]:.4f},"
          f" bytes), int_mm {split['int_mm']:.4f} ms, dequant "
          f"{split['dequant']:.4f} ms (bound {bounds['fc6 dequant'][0]:.4f}); "
          f"fc7: quantize {split['fc7 quantize']:.4f} ms, int_mm "
          f"{split['fc7 int_mm']:.4f} ms (bound {bounds['fc7 int8'][0]:.4f})")
    print(f"[int8] fc6+fc7 (Recog, {M} rows): int8 {ms['int8'][0]:.3f} / "
          f"{ms['int8'][1]:.3f} ms, bf16 dot_f32 {ms['bf16'][0]:.3f} / "
          f"{ms['bf16'][1]:.3f} ms (order bf16, int8, int8, bf16); product "
          f"bounds int8 {bounds['fc6 int8'][0] + bounds['fc7 int8'][0]:.4f} "
          f"ms, bf16 {bounds['fc6 bf16'][0] + bounds['fc7 bf16'][0]:.4f} ms; "
          f"codes' relative error int8 vs bf16 {rel:.3e}; products on the "
          f"fc6 / fc7 weights: {fc_calls}")
    if not exact:
        raise AssertionError("torch._int_mm differs from the exact product")
    if fc_calls["int8"] != ["_int_mm"] * 2:
        raise AssertionError(f"an int8 layer ran a float product: {fc_calls}")
    if not rel <= 0.05:
        raise AssertionError(f"int8 codes differ from bf16 by {rel:.3e}")
    out.update(exact=exact, layout_ms=layout_ms, split_ms=split,
               fc_ms=ms, rel_err=rel,
               bounds_ms={k: v[0] for k, v in bounds.items()})
    return out


def timed_batch(engine, frames):
    """Seconds for len(frames) concurrent requests through `engine`."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(frames)) as ex:
        results = list(ex.map(
            lambda i: engine.process_array(frames[i], stream_id=str(i)),
            range(len(frames))))
    return time.perf_counter() - t0, results


def p50_ms(engine, frames):
    """Median ms of one request at a time over frames[1:] (frames[0]
    warms)."""
    lat = []
    for f in frames:
        t0 = time.perf_counter()
        check_result(engine.process_array(f), engine.max_boxes)
        lat.append(time.perf_counter() - t0)
    return statistics.median(lat[1:]) * 1e3


def phase_engine_int8(dev, params, vocab):
    """The full-width engine on quantize_for_inference params beside the
    bf16 engine, in turns: batch 8 (32 concurrent 720x540 frames, 1000
    proposals) and batch 1 (50 proposals, the demo setting)."""
    qparams = quant.quantize_for_inference(params)
    rng = np.random.default_rng(4)
    frames = [rng.integers(0, 256, (540, 720, 3), dtype=np.uint8)
              for _ in range(32)]
    kinds = {"bf16": params, "int8": qparams}
    order = ("bf16", "int8", "int8", "bf16")
    eng8 = {k: InferenceEngine(p, FLAGSHIP, vocab, device=dev, batch_size=8,
                               batch_window_ms=50.0) for k, p in kinds.items()}
    try:
        assert isinstance(eng8["int8"].model.recog.fc6, quant.QuantLinear)
        for e in eng8.values():
            e.warmup()
            timed_batch(e, frames[:16])
        rate = {k: [] for k in kinds}
        counts = None
        for k in order:
            (wall, results), c = read_launches(
                lambda: timed_batch(eng8[k], frames))
            rate[k].append(len(frames) / wall)
            for r in results:
                check_result(r, eng8[k].max_boxes)
            if k == "int8" and counts is None:
                counts = c
        # the full path's products on the fc6 / fc7 weights, one batch
        x, h, w = canvases(dev, B, FLAGSHIP.image_size)
        fc_calls = {}
        for k, e in eng8.items():
            with ProductCount() as tape:
                e.model.forward_test_batch(x, h, w)
            fc_calls[k] = fc_products(tape.calls)
        del x
    finally:
        for e in eng8.values():
            e.close()
    cfg50 = FLAGSHIP.replace(test_max_proposals=50)
    eng1 = {k: InferenceEngine(p, cfg50, vocab, device=dev, batch_size=1)
            for k, p in kinds.items()}
    for e in eng1.values():
        e.warmup()
    p50 = {k: [] for k in kinds}
    for k in order:
        p50[k].append(p50_ms(eng1[k], frames[:11]))
    (_, c1) = read_launches(lambda: p50_ms(eng1["int8"], frames[:3]))
    print(f"[int8 engine] batch 8, 32 concurrent 720x540 frames, "
          f"{FLAGSHIP.test_max_proposals} proposals: int8 "
          f"{rate['int8'][0]:.2f} / {rate['int8'][1]:.2f} "
          f"images/s, bf16 {rate['bf16'][0]:.2f} / {rate['bf16'][1]:.2f} "
          f"(order bf16, int8, int8, bf16); launches on the int8 path "
          f"{counts}")
    print(f"[int8 engine] batch 1, 50 proposals: p50 int8 {p50['int8'][0]:.1f}"
          f" / {p50['int8'][1]:.1f} ms, bf16 {p50['bf16'][0]:.1f} / "
          f"{p50['bf16'][1]:.1f} ms over 10 frames each; launches {c1}; "
          f"products on the fc6 / fc7 weights per batch forward {fc_calls}")
    need_launches(counts, ("nms", "roi_align"), "int8 engine")
    need_launches(c1, ("nms", "roi_align"), "int8 engine at batch 1")
    if fc_calls["int8"] != ["_int_mm"] * 2:
        raise AssertionError(f"an int8 layer ran a float product: {fc_calls}")
    return counts, {"images_per_s": rate, "p50_ms": p50}


def write_jpegs(folder, sizes, seed):
    from PIL import Image

    rng = np.random.default_rng(seed)
    folder.mkdir()
    for i, (fh, fw) in enumerate(sizes):
        Image.fromarray(rng.integers(0, 256, (fh, fw, 3), dtype=np.uint8)
                        ).save(folder / f"f{i}.jpg")


def phase_daemon(dev, params, vocab):
    """serve.daemon's scan_once on 8 JPEGs (plus a truncated JPEG and a
    .txt) with the full-width model at the daemon's defaults (480 px, 50
    proposals, 50 boxes)."""
    defaults = daemon.build_argparser().parse_args(["--checkpoint", ""])
    cfg = FLAGSHIP.replace(image_size=defaults.image_size,
                           test_max_proposals=defaults.num_proposals)
    engine = InferenceEngine(params, cfg, vocab, device=dev,
                             max_boxes=defaults.max_boxes)
    engine.warmup()
    work = ROOT / "build"
    work.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        src, dst = Path(tmp) / "in", Path(tmp) / "out"
        write_jpegs(src, [(540, 720), (720, 540), (480, 640), (600, 800)] * 2,
                    seed=14)
        full = (src / "f0.jpg").read_bytes()
        (src / "partial.jpg").write_bytes(full[:len(full) // 3])
        (src / "notes.txt").write_text("not an image")
        dst.mkdir()
        t0 = time.perf_counter()
        handled, counts = read_launches(
            lambda: daemon.scan_once(engine, str(src), str(dst)))
        wall = time.perf_counter() - t0
        left = sorted(p.name for p in src.iterdir())
        outs = sorted(p.name for p in dst.iterdir())
        results = [json.loads((dst / n).read_text()) for n in outs]
    for r in results:
        check_result(r, defaults.max_boxes)
    ok = (handled == 8 and left == ["notes.txt", "partial.jpg"]
          and outs == [f"f{i}.json" for i in range(8)])
    print(f"[daemon] scan_once at {defaults.image_size} px, "
          f"{defaults.num_proposals} proposals: {handled} JPEGs answered in "
          f"{wall:.2f} s ({wall / max(handled, 1) * 1e3:.1f} ms each, host "
          f"clock, decode and JSON included); left in place {left}; outputs "
          f"{len(outs)} JSONs, no .tmp="
          f"{not any(n.endswith('.tmp') for n in outs)}"
          f"; boxes per frame {[len(r['boxes']) for r in results]}; "
          f"launches {counts}")
    need_launches(counts, ("nms", "roi_align"), "daemon")
    if not ok:
        raise AssertionError("the daemon broke its file contract")
    return counts


def phase_native():
    """Whether `make -C native` built each native library here."""
    status = {}
    for name in ("dcio", "dcgeom"):
        ok = native_lib.is_available(name)
        status[name] = "built" if ok else native_lib.build_error.get(name)
        print(f"[native] lib{name}.so: "
              f"{'loaded' if ok else 'unavailable: ' + str(status[name])}")
    return status


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--before", default=None,
                    help="a checkout of an earlier commit (e.g. a git "
                         "archive of the parent): its K2b is timed alone "
                         "beside this one's")
    # one rank of the [distributed] phase's gloo pair (its subprocesses)
    ap.add_argument("--dist_rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    # one rank of the [tensor parallel] phase's gloo pair
    ap.add_argument("--tp_rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--tp_dtype", choices=TP_DTYPES, help=argparse.SUPPRESS)
    ap.add_argument("--dist_init", help=argparse.SUPPRESS)
    ap.add_argument("--dist_out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.dist_rank is not None:
        dist_worker(args.dist_rank, args.dist_init, args.dist_out)
        return
    if args.tp_rank is not None:
        tp_worker(args.tp_rank, args.dist_init, args.dist_out,
                  args.tp_dtype)
        return
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
    bucket_counts, buckets = phase_train_buckets(dev, params)
    phase_weight(dev)
    floor = phase_resume(dev)
    phase_distributed(dev, floor)
    tp_counts, tp = phase_tensor_parallel(dev, params)
    torch.cuda.empty_cache()
    profile = phase_profile(dev, params)
    torch.cuda.empty_cache()
    vocab = {i: f"w{i}" for i in range(1, FLAGSHIP.vocab_size + 1)}
    # set-up: `make -C native` runs here, not inside a timed phase (the
    # evaluator loads libdcgeom at its first image)
    native = phase_native()
    model = to_torch(params, FLAGSHIP, dev)
    paths = {"serve": serve, "eval": phase_eval(dev, model, vocab),
             "beam": phase_beam(dev, model),
             "extract_features": phase_extract(dev, model)}
    (paths["eval data parallel"], paths["engine data parallel"],
     data_parallel) = phase_data_parallel(dev, model, params, vocab)
    del model
    torch.cuda.empty_cache()
    int8 = phase_int8(dev, params)
    torch.cuda.empty_cache()
    paths["int8 engine"], int8["engine"] = phase_engine_int8(dev, params,
                                                             vocab)
    paths["daemon"] = phase_daemon(dev, params, vocab)
    (paths["run_model --native_io 1"], paths["run_model --native_io 0"],
     decode_s) = phase_run_model(dev, params, vocab, native)
    del params
    paths["t7 engine"], t7_secs = phase_t7(dev)
    print(f"[train buckets] summary {json.dumps(buckets)}")
    print(f"[profile] summary {json.dumps(profile)}")
    print(f"[tensor parallel] summary {json.dumps(tp)}")
    print(f"[int8] summary {json.dumps(int8)}")
    print("[native] summary " + json.dumps(
        {"libraries": native, "decode_s_per_image": decode_s}))
    print(f"[data parallel] summary {json.dumps(data_parallel)}")
    print(f"[t7] summary {json.dumps({'host_s': t7_secs})}")
    paths["train"] = train
    paths["train buckets"] = bucket_counts
    paths["tensor parallel"] = tp_counts
    train_paths = ("train", "train buckets", "tensor parallel")
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
         "launches_by_path": {
             p: paths[p]["roi_align_bwd"] + paths[p]["roi_align_bwd_feats"]
             for p in train_paths},
         **k2b},
        {"name": "conv_pool", "route": "cuda",
         "source": "densecap_tpu_torch/ops/cuda/conv_pool.cu",
         "replaces": "densecap_tpu/ops/pallas/conv_pool_kernel.py:273",
         "launches": train["conv_pool"],
         "launches_by_path": {p: paths[p]["conv_pool"]
                              for p in train_paths},
         **k3},
    ]
    print(f"[device] nvidia-smi: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
