"""Card-side check of the PyTorch port: kernels, full-width engine, HTTP.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc). Phases, each printing
its result on its own line; any failure raises and exits non-zero:

  1. device: the card's name and power limit;
  2. build: the NMS and RoI-align kernels from densecap_tpu_torch/ops/cuda;
  3. K1 (NMS) against its plain PyTorch version at the serving shapes,
     picks required identical;
  4. K2 (RoI align) against its plain version, max abs error <= 1e-5;
  5. the full-width engine (VGG-16, fc 4096, vocab 10 000, 720 px canvas,
     1000 proposals, bf16, random weights from seed 0): 32 concurrent
     720x540 frames at batch 8, then frames at batch 1; both kernels
     must launch on this path. A small f32 model on the card is held
     against the same model on the CPU (plain ops) as the reference.
     Then, when PIL can encode JPEG, the same engine serves HTTP POSTs.

The last lines are a JSON object describing each kernel and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import base64
import io
import json
import statistics
import subprocess
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import ThreadingHTTPServer

import numpy as np
import torch

from densecap_tpu_torch.config import DenseCapConfig
from densecap_tpu_torch.models.vgg16 import feat_extent
from densecap_tpu_torch.ops import nms as nms_mod
from densecap_tpu_torch.ops import roi_align as roi_mod
from densecap_tpu_torch.ops.boxes import xcycwh_to_x1y1x2y2
from densecap_tpu_torch.ops.cuda import build
from densecap_tpu_torch.serve.engine import InferenceEngine
from densecap_tpu_torch.serve.server import make_handler
from densecap_tpu_torch.utils.checkpoint import init_params, to_torch

B = 8
ROI_TOL = 1e-5


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


def phase_nms(dev):
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
    first, err = None, 0.0
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
        k_ms = cuda_ms(lambda: run(nms_mod.nms_cuda))
        p_ms = cuda_ms(lambda: run(nms_mod.nms_plain))
        print(f"[K1 nms] {name}: identical={same} kept/img={kept} "
              f"kernel {k_ms:.3f} ms plain {p_ms:.3f} ms")
        if not same:
            raise AssertionError(f"K1 picks differ from plain in {name}")
        if first is None:
            first = (k_ms, p_ms)
    return {"max_abs_err": err, "ms": first[0], "plain_ms": first[1]}


def phase_roi(dev):
    rng = np.random.default_rng(2)
    feats = torch.from_numpy(
        rng.standard_normal((B, 45, 45, 512), dtype=np.float32)).to(dev)
    img_h = torch.tensor([720, 540, 720, 480, 700, 720, 360, 720],
                         dtype=torch.float32, device=dev)
    img_w = torch.tensor([540, 720, 720, 720, 500, 333, 720, 96],
                         dtype=torch.float32, device=dev)
    fh, fw = feat_extent(img_h, img_w)
    bx = random_boxes(rng, 1000)
    bx[..., 2:] *= 1.5  # some boxes reach past the image edge
    boxes = torch.from_numpy(bx).to(dev)
    args = (feats, boxes, img_h, img_w, fh, fw, 7, 7)
    got = roi_mod.roi_align_cuda(*args)
    ref = roi_mod.roi_align_plain(*args)
    err = float((got - ref).abs().max())
    k_ms = cuda_ms(lambda: roi_mod.roi_align_cuda(*args))
    p_ms = cuda_ms(lambda: roi_mod.roi_align_plain(*args))
    print(f"[K2 roi_align] 8x1000 boxes on (8,45,45,512) f32: max_abs_err "
          f"{err:.3e} (tol {ROI_TOL}) kernel {k_ms:.3f} ms plain "
          f"{p_ms:.3f} ms")
    if not err <= ROI_TOL:
        raise AssertionError(f"K2 max abs error {err} > {ROI_TOL}")
    return {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms}


def phase_reference(dev):
    """A small f32 model on the card against the same model on the CPU."""
    cfg = DenseCapConfig(
        vocab_size=20, seq_length=4, image_size=96,
        anchors=((8, 8), (16, 16), (12, 24), (24, 12)),
        test_max_proposals=12, test_pre_nms_topk=64, rnn_size=32,
        rnn_encoding_size=32, fc_dim=64, rpn_num_filters=32,
        compute_dtype=torch.float32)
    params = init_params(cfg, seed=3)
    rng = np.random.default_rng(3)
    ims = (rng.standard_normal((2, 96, 96, 3)) * 30).astype(np.float32)
    hs = np.array([96, 72], np.float32)
    ws = np.array([80, 96], np.float32)
    ims[0, :, 80:] = 0  # padding past each extent is zero, as normalized
    ims[1, 72:] = 0
    outs = []
    for d in (dev, torch.device("cpu")):
        m = to_torch(params, cfg, d)
        o = m.forward_test_batch(torch.from_numpy(ims).to(d),
                                 torch.from_numpy(hs).to(d),
                                 torch.from_numpy(ws).to(d))
        outs.append({k: v.cpu() for k, v in o._asdict().items()})
    g, c = outs
    exact = all(torch.equal(g[k], c[k]) for k in ("valid", "num", "captions"))
    box_err = float((g["boxes"] - c["boxes"]).abs().max())
    score_err = float((g["scores"] - c["scores"]).abs().max())
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


def phase_engine(dev, cfg=FLAGSHIP, frame_hw=(540, 720)):
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0)
    vocab = {i: f"w{i}" for i in range(1, cfg.vocab_size + 1)}
    print(f"[engine] full-width params from seed 0 in "
          f"{time.perf_counter() - t0:.1f} s (compute {cfg.compute_dtype})")
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
        if not all(launches[k] > 0 for k in launches):
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
        phase_http(eng8, frames)
    finally:
        eng8.close()
        eng1.close()
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


def main():
    name, smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    k1 = phase_nms(dev)
    k2 = phase_roi(dev)
    phase_reference(dev)
    launches = phase_engine(dev)
    kernels = [
        {"name": "nms", "route": "cuda",
         "source": "densecap_tpu_torch/ops/cuda/nms.cu",
         "replaces": "densecap_tpu/ops/pallas/nms_kernel.py:146",
         "launches": launches["nms"], **k1},
        {"name": "roi_align", "route": "cuda",
         "source": "densecap_tpu_torch/ops/cuda/roi_align.cu",
         "replaces": "densecap_tpu/ops/pallas/roi_align_kernel.py:141",
         "launches": launches["roi_align"], **k2},
    ]
    print(f"[device] nvidia-smi: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
