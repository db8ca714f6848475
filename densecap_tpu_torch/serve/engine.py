"""Serving engine: the port's model behind a request pipeline.

Twin of `densecap_tpu/serve/engine.py`. Requests ship raw uint8 BGR
canvases; the mean subtraction and padding mask run on the device. With
`batch_size > 1` concurrent requests are micro-batched by a two-thread
pipeline: the dispatcher assembles a batch, runs the model on its
thread's current stream and records a CUDA event; the completer waits
on that event and makes one device-to-host copy for the whole batch.
With `devices` (more than one) the dispatcher instead splits each batch
over replicas of the model (`parallel.mesh.Replicas`, a thread and a
stream each); the completer waits for every replica's event and makes
one device-to-host copy per replica's shard. Box identities are tracked
per client stream by a numpy TemporalSmoother.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from ..parallel.mesh import Replicas
from ..utils.checkpoint import to_torch
from ..utils.image import preprocess_for_model_uint8, to_model_input
from ..utils.text import decode_sequence


def _iou_cwh_np(boxes1, boxes2):
    """Pairwise IoU, (B1, 4) x (B2, 4) xcycwh -> (B1, B2), in numpy.

    The continuous convention of densecap_tpu.ops.boxes.iou_cwh: corners at
    xc +/- w/2, no +1, identical boxes give 1.
    """
    a1 = boxes1[:, 2] * boxes1[:, 3]
    a2 = boxes2[:, 2] * boxes2[:, 3]
    lo1, hi1 = boxes1[:, :2] - boxes1[:, 2:] / 2, boxes1[:, :2] + boxes1[:, 2:] / 2
    lo2, hi2 = boxes2[:, :2] - boxes2[:, 2:] / 2, boxes2[:, :2] + boxes2[:, 2:] / 2
    lo = np.maximum(lo1[:, None, :], lo2[None, :, :])
    hi = np.minimum(hi1[:, None, :], hi2[None, :, :])
    wh = np.maximum(hi - lo, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = a1[:, None] + a2[None, :] - inter
    return inter / np.maximum(union, 1e-12)


class TemporalSmoother:
    """IoU-based box identity tracking across frames: each new box takes
    the id of its best match (IoU > thresh) among the previous frame's
    boxes, greedily by IoU; unmatched boxes get fresh ids."""

    def __init__(self, iou_thresh=0.5):
        self.iou_thresh = iou_thresh
        self.prev_boxes = None
        self.prev_ids = None
        self.next_id = 0

    def assign_ids(self, boxes):
        n = len(boxes)
        ids = np.full(n, -1, dtype=np.int64)
        if self.prev_boxes is not None and len(self.prev_boxes) and n:
            ious = _iou_cwh_np(np.asarray(boxes, np.float64),
                               np.asarray(self.prev_boxes, np.float64))
            taken = set()
            for f in np.argsort(-ious, axis=None):
                i, j = divmod(int(f), ious.shape[1])
                if ious[i, j] <= self.iou_thresh:
                    break
                if ids[i] == -1 and j not in taken:
                    ids[i] = self.prev_ids[j]
                    taken.add(j)
        for i in range(n):
            if ids[i] == -1:
                ids[i] = self.next_id
                self.next_id += 1
        self.prev_boxes = boxes.copy() if n else np.zeros((0, 4))
        self.prev_ids = ids
        return ids


class InferenceEngine:
    """The port's serving engine on an explicit `device`.

    `params` is a numpy parameter tree (`utils.checkpoint.load_params` or
    `init_params`). `batch_size == 1` runs each request on the caller's
    thread; `batch_size > 1` micro-batches concurrent requests, padding a
    short batch with repeats of its last frame. `devices` (a list, e.g.
    `parallel.mesh.data_devices`; used in micro-batch mode only, as the
    JAX engine uses its mesh) shards each batch contiguously over one
    replica per device; `batch_size` must be a multiple of its length.
    Call `close()` to stop the pipeline threads.
    """

    def __init__(self, params, cfg, idx_to_token, *, device, max_boxes=50,
                 smoothing=True, batch_size=1, batch_window_ms=5.0,
                 request_timeout_s=60.0, max_streams=64, devices=None):
        if (devices is not None and batch_size > 1
                and batch_size % len(devices)):
            raise ValueError(f"batch_size {batch_size} must be a multiple of "
                             f"the {len(devices)} data-parallel devices")
        self.device = torch.device(device)
        self.model = to_torch(params, cfg, self.device)
        self.replicas = (Replicas(self.model, devices)
                         if devices is not None and len(devices) > 1
                         and batch_size > 1 else None)
        self.cfg = cfg
        self.idx_to_token = idx_to_token
        self.max_boxes = max_boxes
        self.smoothing = bool(smoothing)
        self.max_streams = int(max_streams)
        self._smoothers: "dict[str, TemporalSmoother]" = {}
        self._smoother_lock = threading.Lock()
        self.lock = threading.Lock()
        self.batch_size = int(batch_size)
        self.batch_window = batch_window_ms / 1000.0
        self.request_timeout = float(request_timeout_s)
        self._threads = []
        if self.batch_size > 1:
            self._q = queue.Queue()
            # bounds the batches in flight (device memory, backpressure)
            self._inflight = queue.Queue(maxsize=2)
            for target in (self._dispatch_loop, self._complete_loop):
                t = threading.Thread(target=target, daemon=True)
                t.start()
                self._threads.append(t)

    def close(self):
        """Stop the pipeline threads (batch_size > 1) and the replicas';
        idempotent."""
        if self._threads:
            self._q.put(None)
            for t in self._threads:
                t.join(timeout=60)
            self._threads = []
        if self.replicas is not None:
            self.replicas.close()

    def warmup(self):
        """Run one blank frame through the whole path (builds the CUDA
        kernels on first use). The request timeout is lifted meanwhile."""
        S = self.cfg.image_size
        saved = self.request_timeout
        self.request_timeout = max(saved, 1800.0)
        try:
            self.process_array(np.zeros((S, S, 3), np.uint8),
                               stream_id="__warmup__")
        finally:
            self.request_timeout = saved

    def _run(self, canvases, hs, ws):
        """Model on one batch -> one packed (B, K, 4 + 1 + T + 1) f32
        device tensor: boxes, score, tokens, valid."""
        return self._pack(self.model, *to_model_input(canvases, hs, ws,
                                                      self.device))

    @staticmethod
    def _pack(model, x, hs, ws):
        out = model.forward_test_batch(x, hs, ws)
        # tokens <= V + 1 are exact in f32
        return torch.cat([out.boxes, out.scores[..., None],
                          out.captions.float(),
                          out.valid[..., None].float()], dim=-1)

    @staticmethod
    def _unpack(row):
        T = row.shape[-1] - 6
        return (row[:, :4], row[:, 4], row[:, 5:5 + T].astype(np.int32),
                row[:, 5 + T] > 0.5)

    # ---- micro-batching ---------------------------------------------------
    def _dispatch_loop(self):
        """Stage 1: assemble a micro-batch, run it and record its event, or
        queue its shards on the replicas. A failed batch delivers its
        exception to every waiting request."""
        B = self.batch_size
        while True:
            first = self._q.get()
            if first is None:
                self._inflight.put(None)
                return
            reqs = [first]
            deadline = time.monotonic() + self.batch_window
            stop = False
            while len(reqs) < B:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    r = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if r is None:
                    stop = True
                    break
                reqs.append(r)
            pad = B - len(reqs)
            canvases = [r["canvas"] for r in reqs] + [reqs[-1]["canvas"]] * pad
            hs = [r["h"] for r in reqs] + [reqs[-1]["h"]] * pad
            ws = [r["w"] for r in reqs] + [reqs[-1]["w"]] * pad
            try:
                if self.replicas is not None:
                    shards = self.replicas.submit(canvases, hs, ws,
                                                  fn=self._pack)
                else:
                    packed = self._run(canvases, hs, ws)
                    event = None
                    if packed.is_cuda:
                        event = torch.cuda.Event()
                        event.record(torch.cuda.current_stream(packed.device))
                    shards = [Future()]
                    shards[0].set_result((packed, event))
            except Exception as e:  # noqa: BLE001 — deliver, don't die
                for r in reqs:
                    r["error"] = e
                    r["event"].set()
            else:
                self._inflight.put((reqs, shards))
            if stop:
                self._inflight.put(None)
                return

    def _complete_loop(self):
        """Stage 2: wait for the oldest batch (every shard's event), copy
        each shard to the host once, and wake its requests."""
        while True:
            item = self._inflight.get()
            if item is None:
                return
            reqs, shards = item
            try:
                parts = []
                for shard in shards:
                    packed, event = shard.result()
                    if event is not None:
                        event.synchronize()
                    parts.append(packed.cpu().numpy())
                host = np.concatenate(parts)
            except Exception as e:  # noqa: BLE001 — deliver, don't die
                for r in reqs:
                    r["error"] = e
                    r["event"].set()
                continue
            for i, r in enumerate(reqs):
                r["result"] = self._unpack(host[i])
                r["event"].set()

    def _infer(self, canvas, h, w):
        """Run the model; returns (boxes, scores, captions, valid) numpy.

        Raises TimeoutError if the pipeline does not answer within
        request_timeout_s and re-raises pipeline-side exceptions."""
        if self.batch_size > 1:
            req = {"canvas": canvas, "h": h, "w": w,
                   "event": threading.Event()}
            self._q.put(req)
            if not req["event"].wait(timeout=self.request_timeout):
                raise TimeoutError(
                    f"inference request timed out after "
                    f"{self.request_timeout:.0f}s")
            if "error" in req:
                raise RuntimeError(
                    f"batched inference failed: {req['error']!r}"
                ) from req["error"]
            return req["result"]
        with self.lock:
            host = self._run([canvas], [h], [w]).cpu().numpy()
        return self._unpack(host[0])

    def _assign_ids(self, boxes, stream_id):
        """Per-stream smoothing with LRU eviction past max_streams."""
        if not self.smoothing:
            return np.arange(len(boxes))
        key = "" if stream_id is None else str(stream_id)
        with self._smoother_lock:
            sm = self._smoothers.pop(key, None)
            if sm is None:
                sm = TemporalSmoother()
                while len(self._smoothers) >= self.max_streams:
                    self._smoothers.pop(next(iter(self._smoothers)))
            self._smoothers[key] = sm  # re-insert: most recently used
            return sm.assign_ids(boxes)

    def process_array(self, rgb, stream_id=None):
        """(H, W, 3) uint8 RGB -> dict of boxes / scores / captions / ids,
        boxes in the original image's xywh coordinates."""
        canvas, h, w, scale = preprocess_for_model_uint8(
            rgb, self.cfg.image_size)
        all_boxes, all_scores, all_caps, valid = self._infer(canvas, h, w)
        boxes = all_boxes[valid][: self.max_boxes]
        scores = all_scores[valid][: self.max_boxes]
        captions = decode_sequence(all_caps[valid][: self.max_boxes],
                                   self.idx_to_token, self.cfg.vocab_size)
        ids = self._assign_ids(boxes, stream_id)

        xywh = np.zeros_like(boxes)
        xywh[:, 0] = (boxes[:, 0] - (boxes[:, 2] - 1) / 2 - 1) / scale + 1
        xywh[:, 1] = (boxes[:, 1] - (boxes[:, 3] - 1) / 2 - 1) / scale + 1
        xywh[:, 2] = boxes[:, 2] / scale
        xywh[:, 3] = boxes[:, 3] / scale
        return {
            "boxes": xywh.tolist(),
            "scores": scores.tolist(),
            "captions": captions,
            "ids": ids.tolist(),
        }
