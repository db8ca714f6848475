"""Host -> card feed latency of the port's train-step batch.

Twin of scripts/transfer_latency_probe.py, in torch terms: where does a
step's feed time go? On the train batch of B=8 720x544 canvases (raw
uint8, then float32) with 128 gt slots of 15 tokens, each row reports
the host time until the call returns and until the card has the data
(`torch.cuda.synchronize()`), averaged over `--iters` after one warm-up:

  a) per-tensor `.to(dev)` from pageable memory;
  b) per-tensor copies from memory pinned beforehand, `non_blocking=True`;
  c) the train CLI's own copy (`cli/train.py` `_to_device`: each tensor
     pinned at the call, then copied without blocking);
  d) one packed buffer pinned beforehand, one copy, typed views on the
     card;
  e) a scalar `.to(dev)` (the floor of a copy);
  f) a scalar `.item()` fetch from the card (the floor of a read-back).

    python scripts/torch_transfer_latency_probe.py [--iters 30]
        [--device cuda|cpu]

On the CPU every time reads "not measured". Last line: one JSON object
with every row, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_tool_common as tc  # noqa: E402
from densecap_tpu_torch.cli.train import _to_device  # noqa: E402

B, S, W, G, T = 8, 720, 544, 128, 15


def make_batch(raw=True, B=B, S=S, W=W, G=G, T=T):
    """The JAX probe's batch, byte-equal (the same draws in order)."""
    rng = np.random.RandomState(0)
    img = rng.randint(0, 255, (B, S, W, 3)).astype(
        np.uint8 if raw else np.float32)
    return {
        "image": img,
        "height": np.full((B,), S, np.int32),
        "width": np.full((B,), W, np.int32),
        "gt_boxes": rng.rand(B, G, 4).astype(np.float32) * 500,
        "gt_labels": rng.randint(1, 100, (B, G, T)).astype(np.int32),
        "gt_valid": np.ones((B, G), bool),
        "weight": np.ones((B,), np.float32),
    }


def timeit(label, fn, dev, iters):
    """Mean ms until fn returns and until the card has finished."""
    fn()  # warm
    tc.sync(dev)
    t_call = t_ready = 0.0
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        t_call += time.perf_counter() - t0
        tc.sync(dev)
        t_ready += time.perf_counter() - t0
    row = {"call_ms": tc.measured(1e3 * t_call / iters, dev),
           "ready_ms": tc.measured(1e3 * t_ready / iters, dev)}
    text = ", ".join(f"{k} {v if isinstance(v, str) else f'{v:.3f}'}"
                     for k, v in row.items())
    print(f"{label:52s} {text}", flush=True)
    return row


def packed(batch, pin):
    """One uint8 buffer holding every array's bytes, and the (key, offset,
    dtype, shape) to view them back."""
    layout, off = [], 0
    for k, v in batch.items():
        off = -(-off // 8) * 8  # 8-byte aligned views
        layout.append((k, off, v.dtype, v.shape))
        off += v.nbytes
    buf = torch.empty(off, dtype=torch.uint8, pin_memory=pin)
    arr = buf.numpy()
    for (k, o, dt, shape) in layout:
        arr[o:o + batch[k].nbytes] = batch[k].reshape(-1).view(np.uint8)
    return buf, layout


def views(dbuf, layout):
    tdt = {np.dtype(np.uint8): torch.uint8, np.dtype(np.int32): torch.int32,
           np.dtype(np.float32): torch.float32, np.dtype(bool): torch.bool}
    out = {}
    for k, o, dt, shape in layout:
        n = int(np.prod(shape)) * np.dtype(dt).itemsize
        out[k] = dbuf[o:o + n].view(tdt[np.dtype(dt)]).view(shape)
    return out


def probe(batch, dev, iters):
    cuda = dev.type == "cuda"
    nbytes = sum(v.nbytes for v in batch.values())
    host = {k: torch.from_numpy(v) for k, v in batch.items()}
    pinned = {k: (v.pin_memory() if cuda else v) for k, v in host.items()}
    buf, layout = packed(batch, cuda)
    rows = {"mb_per_batch": nbytes / 1e6}
    rows["a"] = timeit("a) per-tensor .to(dev), pageable",
                       lambda: {k: v.to(dev) for k, v in host.items()},
                       dev, iters)
    rows["b"] = timeit("b) per-tensor pinned, non_blocking",
                       lambda: {k: v.to(dev, non_blocking=cuda)
                                for k, v in pinned.items()}, dev, iters)
    rows["c"] = timeit("c) the train CLI's _to_device (pin at the call)",
                       lambda: _to_device(batch, dev), dev, iters)
    rows["d"] = timeit(f"d) one packed pinned buffer ({buf.numel() / 1e6:.1f}"
                       " MB) + views",
                       lambda: views(buf.to(dev, non_blocking=cuda), layout),
                       dev, iters)
    one = torch.tensor(1.0)
    rows["e"] = timeit("e) scalar .to(dev) (copy floor)",
                       lambda: one.to(dev), dev, iters)
    z = torch.zeros(8, device=dev)
    rows["f"] = timeit("f) scalar .item() fetch (read-back floor)",
                       lambda: z.sum().item(), dev, iters)
    return rows


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--batch", type=int, default=B)
    ap.add_argument("--image_size", type=int, default=S)
    ap.add_argument("--canvas_w", type=int, default=W)
    ap.add_argument("--max_gt_boxes", type=int, default=G)
    ap.add_argument("--seq_length", type=int, default=T)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    dev = tc.card(args.device)
    device = tc.print_device(dev)
    res = {}
    for raw in (True, False):
        batch = make_batch(raw, args.batch, args.image_size, args.canvas_w,
                           args.max_gt_boxes, args.seq_length)
        print(f"--- raw={raw}: {sum(v.nbytes for v in batch.values()) / 1e6:.1f}"
              " MB/batch", flush=True)
        res["raw_uint8" if raw else "float32"] = probe(batch, dev, args.iters)
    return tc.emit({"check": "transfer_latency_probe", "device": device,
                    "batch": args.batch,
                    "canvas": [args.image_size, args.canvas_w],
                    "iters": args.iters, **res})


if __name__ == "__main__":
    main()
