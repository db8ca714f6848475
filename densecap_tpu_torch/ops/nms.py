"""Exact greedy NMS with a fixed number of output slots, batched.

Twin of `densecap_tpu/ops/nms.py:nms` over a batch `(B, N, 4)`:

  * `nms_plain`: a PyTorch transliteration of the JAX tiled sweep (each
    tile pulls suppression from a buffer of the survivors found so far,
    then settles itself by a greedy fixpoint). The CPU path and the
    reference the CUDA kernel is held against.
  * `nms_cuda`: kernel K1 (`cuda/nms.cu`).
  * `nms`: a CPU tensor takes the plain version, a CUDA tensor the kernel.

Contract (ops/nms.py:69-99): boxes x1y1x2y2, pascal +1 IoU, a box is
suppressed by a kept higher-scored box when IoU > thresh; invalid boxes
neither keep nor suppress. Returns `idx` (B, K) int32 indices into the
input in decreasing score order, padded slots 0, and `valid` (B, K) bool.
Without `presorted` the scores are masked with -1e38 and sorted stably
(ties in input order); with it the caller guarantees that order.
"""

from __future__ import annotations

import torch

from .boxes import iou_pascal
from .cuda import build

NEG_INF = -1e38


def _sort(boxes, scores, valid, presorted):
    B, N = boxes.shape[:2]
    if valid is None:
        valid = torch.ones((B, N), dtype=torch.bool, device=boxes.device)
    if presorted:
        order = torch.arange(N, device=boxes.device).expand(B, N)
        return order, boxes.float().contiguous(), valid.contiguous()
    masked = torch.where(valid, scores, NEG_INF)
    order = torch.sort(-masked, dim=1, stable=True).indices
    sboxes = boxes.gather(1, order[..., None].expand(B, N, 4)).float()
    svalid = masked.gather(1, order) > NEG_INF / 2
    return order, sboxes, svalid


def _emit(order, alive, max_out):
    """First `max_out` alive positions (in sorted order) -> (idx, valid)."""
    B, Np = alive.shape
    N = order.shape[1]
    K = int(max_out)
    rank = alive.cumsum(1) - 1
    slot = torch.where(alive & (rank < K), rank, K)
    src = torch.zeros((B, Np), dtype=torch.long, device=alive.device)
    src[:, :N] = order
    idx = torch.zeros((B, K + 1), dtype=torch.long, device=alive.device)
    idx.scatter_(1, slot, src)  # slot K collects the dropped writes
    total = alive.sum(1).clamp(max=K)
    out_valid = torch.arange(K, device=alive.device)[None] < total[:, None]
    return idx[:, :K].to(torch.int32), out_valid


def nms_plain(boxes, scores, iou_thresh, max_out, valid=None,
              presorted=False, tile_size=256):
    """Plain PyTorch greedy NMS (see module docstring)."""
    B, N = boxes.shape[:2]
    T, K = int(tile_size), int(max_out)
    dev = boxes.device
    order, sboxes, svalid = _sort(boxes, scores, valid, presorted)
    Np = -(-N // T) * T
    if Np > N:
        sboxes = torch.cat(
            [sboxes, sboxes.new_zeros((B, Np - N, 4))], dim=1)
        svalid = torch.cat(
            [svalid, svalid.new_zeros((B, Np - N))], dim=1)
    thr = torch.tensor(iou_thresh, dtype=torch.float32, device=dev)

    # Survivor buffer: while it holds fewer than K boxes every suppressor
    # is in it; once it holds K the emitted set is final. Slot BUF takes
    # the appends that fall past its end.
    BUF = K + T
    buf = sboxes.new_zeros((B, BUF + 1, 4))
    cnt = torch.zeros((B,), dtype=torch.long, device=dev)
    alive = svalid.clone()
    r = torch.arange(T, device=dev)
    earlier = r[:, None] < r[None, :]
    slots = torch.arange(BUF, device=dev)
    for start in range(0, Np, T):
        # every image has K finalized survivors: later tiles cannot
        # change what is emitted (the JAX sweep's exact early stop)
        if start and bool((cnt >= K).all()):
            break
        tb = sboxes[:, start:start + T]
        vin = svalid[:, start:start + T]
        live = slots[None] < cnt[:, None]
        pulled = ((iou_pascal(tb, buf[:, :BUF]) > thr)
                  & live[:, None, :]).any(2)
        alive_in = vin & ~pulled

        # within-tile greedy fixpoint: after step s the first s boxes of
        # the tile are final, so it settles within T steps
        sup_tt = (iou_pascal(tb, tb) > thr) & earlier     # [j, i]: j kills i
        prev = alive_in
        cur = alive_in & ~(sup_tt & alive_in[:, :, None]).any(1)
        for _ in range(T):
            if not bool((cur != prev).any()):
                break
            prev = cur
            cur = alive_in & ~(sup_tt & cur[:, :, None]).any(1)

        alive[:, start:start + T] = cur
        pos = torch.where(cur, cnt[:, None] + cur.cumsum(1) - 1, BUF)
        buf.scatter_(1, pos.clamp(max=BUF)[..., None].expand(B, T, 4), tb)
        cnt = (cnt + cur.sum(1)).clamp(max=BUF)
    return _emit(order, alive, K)


# The kernel keeps each survivor (box and area, 20 bytes) in shared
# memory: max_out of them must fit in the 227 KiB a block may use, less
# 4 KiB for its tile buffers. N has no limit: tiles stream from memory.
MAX_OUT = (227 * 1024 - 4 * 1024) // 20


def prepare_cuda(boxes, scores, max_out, valid=None, presorted=False):
    """The wrapper's work before K1: checks, the stable score sort and the
    kernel's outputs. -> (order, sboxes, svalid uint8, keep, count)."""
    if not boxes.is_cuda:
        raise ValueError("nms_cuda takes CUDA tensors")
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (B, N, 4), got {tuple(boxes.shape)}")
    B = boxes.shape[0]
    K = int(max_out)
    if K > MAX_OUT:
        raise ValueError(f"nms_cuda: max_out={K} exceeds the kernel's "
                         f"shared memory (at most {MAX_OUT})")
    order, sboxes, svalid = _sort(boxes, scores, valid, presorted)
    sboxes = sboxes.contiguous()
    svalid = svalid.to(torch.uint8).contiguous()
    if sboxes.data_ptr() % 16:
        raise ValueError("nms_cuda: boxes must be 16-byte aligned")
    keep = torch.empty((B, K), dtype=torch.int32, device=boxes.device)
    count = torch.empty((B,), dtype=torch.int32, device=boxes.device)
    return order, sboxes, svalid, keep, count


def launch_cuda(sboxes, svalid, iou_thresh, keep, count):
    """One launch of K1 on prepared tensors (`prepare_cuda`); not counted.
    It launches on the tensors' device (a ctypes call launches on the
    calling thread's current device)."""
    B, N = svalid.shape
    lib = build.load()
    with torch.cuda.device(sboxes.device):
        rc = lib.dc_nms(
            sboxes.data_ptr(), svalid.data_ptr(), B, N, keep.shape[1],
            float(iou_thresh), keep.data_ptr(), count.data_ptr(),
            torch.cuda.current_stream(sboxes.device).cuda_stream)
    build.check(rc, "nms")


def nms_cuda(boxes, scores, iou_thresh, max_out, valid=None,
             presorted=False):
    """Kernel K1 on CUDA tensors; same contract as `nms_plain`."""
    order, sboxes, svalid, keep, count = prepare_cuda(
        boxes, scores, max_out, valid=valid, presorted=presorted)
    B, N = svalid.shape
    K = keep.shape[1]
    dev = boxes.device
    if N == 0 or K == 0:
        return (torch.zeros((B, K), dtype=torch.int32, device=dev),
                torch.zeros((B, K), dtype=torch.bool, device=dev))
    launch_cuda(sboxes, svalid, iou_thresh, keep, count)
    build.count_launch("nms")
    slot_ok = torch.arange(K, device=dev)[None] < count[:, None]
    idx = torch.where(slot_ok, order.gather(1, keep.long()), 0)
    return idx.to(torch.int32), slot_ok


def nms(boxes, scores, iou_thresh, max_out, valid=None, presorted=False):
    """Greedy NMS over a batch: the kernel on CUDA, the plain sweep on CPU."""
    if boxes.is_cuda:
        return nms_cuda(boxes, scores, iou_thresh, max_out, valid=valid,
                        presorted=presorted)
    if boxes.device.type != "cpu":
        raise ValueError(f"nms: no implementation for {boxes.device}")
    return nms_plain(boxes, scores, iou_thresh, max_out, valid=valid,
                     presorted=presorted)
