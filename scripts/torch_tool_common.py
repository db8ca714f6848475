"""What the port's measurement scripts share: the device rules, the card's
description, CUDA-event timing, the model-size flags, random inputs and
the table of the program's spans.

Device rules: a script runs on `cuda` unless the caller passes `--device
cpu`; without a card it stops (`card`), and it never falls back to the
CPU. On the CPU it runs the same code at whatever size it is given, but
every device metric (a time, a rate, an MFU, a peak memory) reads
`NOT_MEASURED`. Host-clock readings of host-only work (the evaluator's
phases) stay numbers.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

from densecap_tpu_torch.config import DenseCapConfig  # noqa: E402
from densecap_tpu_torch.ops.cuda import build  # noqa: E402
from densecap_tpu_torch.utils import profiling  # noqa: E402

NOT_MEASURED = "not measured"
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def card(device):
    """torch.device(device). A CUDA device must exist, and the kernels are
    built here, so a build failure stops the run before it measures."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {device}: no CUDA card here (pass "
                             "--device cpu to run on the CPU, unmeasured)")
        build.load()
    return dev


def device_info(dev):
    """{"name", "power_limit_w"} as `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` gives them (the limit with its unit); on the CPU
    the name "cpu" and no limit."""
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit_w": NOT_MEASURED}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(dev.index or 0)],
        capture_output=True, text=True)
    name, _, limit = smi.stdout.strip().partition(",")
    return {"name": name.strip() or torch.cuda.get_device_name(dev),
            "power_limit_w": limit.strip() or smi.stderr.strip()}


def print_device(dev):
    info = device_info(dev)
    print(f"device: {json.dumps(info)}", flush=True)
    return info


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measured(value, dev):
    """`value` on a card, else NOT_MEASURED."""
    return value if dev.type == "cuda" else NOT_MEASURED


def ms_per_call(fn, n, dev, warmup=1):
    """ms per call of `n` back-to-back calls of fn, CUDA events around the
    n after `warmup` calls (NOT_MEASURED on the CPU, where the calls still
    run)."""
    for _ in range(warmup):
        fn()
    if dev.type != "cuda":
        for _ in range(n):
            fn()
        return NOT_MEASURED
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def call_ms(fn, n, dev, warmup=1):
    """The ms of each of `n` calls, CUDA events around each one (each
    call ends before the next starts), after `warmup` calls; NOT_MEASURED
    on the CPU."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        if dev.type != "cuda":
            fn()
            continue
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times if dev.type == "cuda" else NOT_MEASURED


def median(times):
    return times if isinstance(times, str) else statistics.median(times)


def reset_peak(dev):
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def peak_gib(dev):
    return measured(torch.cuda.max_memory_allocated(dev) / 2**30
                    if dev.type == "cuda" else None, dev)


def rate(n, ms):
    """n items over ms -> items/s (NOT_MEASURED passes through)."""
    return ms if isinstance(ms, str) else n / ms * 1e3


def add_model_flags(ap, vocab_size=10000, image_size=720, proposals=1000,
                    dtype="bfloat16"):
    """The model's sizes: the flagship's by default. Depth is VGG-16's and
    is not a flag; the tests pass narrow widths."""
    ap.add_argument("--vocab_size", type=int, default=vocab_size)
    ap.add_argument("--seq_length", type=int, default=15)
    ap.add_argument("--image_size", type=int, default=image_size)
    ap.add_argument("--proposals", type=int, default=proposals,
                    help="test_max_proposals")
    ap.add_argument("--fc_dim", type=int, default=4096)
    ap.add_argument("--rnn_size", type=int, default=512,
                    help="LSTM width (and its input encoding's)")
    ap.add_argument("--rpn_num_filters", type=int, default=256)
    ap.add_argument("--dtype", default=dtype, choices=sorted(DTYPES))
    ap.add_argument("--device", default="cuda")


def model_config(args, **kw):
    return DenseCapConfig(
        vocab_size=args.vocab_size, seq_length=args.seq_length,
        image_size=args.image_size, test_max_proposals=args.proposals,
        fc_dim=args.fc_dim, rnn_size=args.rnn_size,
        rnn_encoding_size=args.rnn_size,
        rpn_num_filters=args.rpn_num_filters,
        compute_dtype=DTYPES[args.dtype]).replace(**kw)


def lengths_to_end(captions, end_token):
    """(N, T) tokens -> N lengths counted to the first END (T if none)."""
    is_end = captions == end_token
    return np.where(is_end.any(1), is_end.argmax(1), captions.shape[1])


def random_canvases(shape, seed):
    """Random normalized canvases of `shape` (..., H, W, 3): seeded
    standard normals times 30, as the JAX scripts' inputs."""
    return (np.random.RandomState(seed).standard_normal(shape)
            .astype(np.float32) * np.float32(30.0))


def train_batch(cfg, B, H, W, content_w, dev, valid_gt=20):
    """The JAX profilers' train batch: seeded canvases, every image H x
    content_w, `cfg.max_gt_boxes` slots of one gt box (100, 100, 50, 60)
    of which the first `valid_gt` are valid, captions of ones."""
    G, L = cfg.max_gt_boxes, cfg.seq_length
    batch = {
        "image": torch.from_numpy(random_canvases((B, H, W, 3), 2)),
        "height": torch.full((B,), float(H)),
        "width": torch.full((B,), float(content_w)),
        "gt_boxes": torch.tensor([100.0, 100.0, 50.0, 60.0]).repeat(B, G, 1),
        "gt_labels": torch.ones((B, G, L), dtype=torch.long),
        "gt_valid": (torch.arange(G) < valid_gt).repeat(B, 1),
    }
    return {k: v.to(dev) for k, v in batch.items()}


def launches_of(fn):
    """Run fn() with every launch count at 0 first: (result, counts)."""
    build.reset_launches()
    out = fn()
    return out, dict(build.launches)


def emit(obj):
    """The last line: one JSON object."""
    print(json.dumps(obj), flush=True)
    return obj


def span_rows(start_ns, end_ns):
    """Every span the program recorded in [start_ns, end_ns]
    (perf_counter_ns), one row per (parent, name), in the order the
    program opened them: {"key": "parent/name" (the name alone at a
    root), "name", "parent", "depth", "count", "host_ms", "device_ms",
    "counters"}, the means per span of `profiling.STORE.summary`."""
    store = profiling.STORE
    rows, seen = [], set()
    for rec in sorted(store.spans(start_ns=start_ns, end_ns=end_ns),
                      key=lambda r: r.t0):
        parent = rec.parent_name
        if (parent, rec.name) in seen:
            continue
        seen.add((parent, rec.name))
        depth, up = 0, rec.parent
        while up is not None:
            depth, up = depth + 1, up.parent
        rows.append({"key": rec.name if parent is None
                     else f"{parent}/{rec.name}",
                     "name": rec.name, "parent": parent, "depth": depth,
                     **store.summary(rec.name, parent=parent,
                                     start_ns=start_ns, end_ns=end_ns)})
    return rows


def children_sum(rows, root):
    """{"host_ms", "device_ms"}: the sums over the rows directly under the
    root row `root`."""
    kids = [r for r in rows if r["depth"] == 1 and r["parent"] == root]
    return {k: sum(r[k] for r in kids) for k in ("host_ms", "device_ms")}


def print_span_rows(rows, dev):
    """The rows as a table indented by depth, then each root's children's
    sum against the root; times read NOT_MEASURED off a card. -> the
    table for the JSON line, keyed as the rows."""
    def ms(x):
        x = measured(x, dev)
        return f"{x:>12s}" if isinstance(x, str) else f"{x:12.3f}"

    table = {}
    print(f"{'span':32s} {'device ms':>12s} {'host ms':>12s}  spans",
          flush=True)
    for r in rows:
        counters = {k: {"n": c["n"], "host_ms": measured(c["host_ms"], dev)}
                    for k, c in r["counters"].items()}
        shown = "".join(f"; {k} {c['n']:g}" + (
            f" ({c['host_ms']:.3f} ms host)" if dev.type == "cuda"
            and c["host_ms"] else "") for k, c in counters.items())
        print(f"{'  ' * r['depth'] + r['name']:32s} {ms(r['device_ms'])} "
              f"{ms(r['host_ms'])}  {r['count']}{shown}", flush=True)
        table[r["key"]] = {"device_ms": measured(r["device_ms"], dev),
                           "host_ms": measured(r["host_ms"], dev),
                           "count": r["count"], "counters": counters}
    for r in rows:
        if r["depth"] == 0 and any(x["parent"] == r["name"] for x in rows):
            kids = children_sum(rows, r["name"])
            print(f"children of {r['name']}: device {ms(kids['device_ms'])}"
                  f" of {ms(r['device_ms'])} ms, host "
                  f"{ms(kids['host_ms'])} of {ms(r['host_ms'])} ms",
                  flush=True)
    return table


def recorded(fn):
    """fn() with the program's spans recording and every launch count at
    0 first: (result, the rows of the spans it opened, launches)."""
    was = profiling.set_recording(True)
    start = time.perf_counter_ns()
    try:
        out, counts = launches_of(fn)
    finally:
        profiling.set_recording(was)
    return out, span_rows(start, time.perf_counter_ns()), counts

