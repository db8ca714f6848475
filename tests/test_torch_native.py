"""The port's native host runtime (`densecap_tpu_torch/native_lib.py`, the
twin of `tests/test_native.py`'s subject) and its three callers.

  * `assign` and `merge_boxes` through libdcgeom against the port's numpy;
  * `decode_jpeg_bytes` bit-identical to PIL (the same libjpeg), None on
    bytes that are not a JPEG; the server decodes a JPEG body there and a
    PNG with PIL;
  * a `load_batch` canvas (f32, normalized on the host) through
    `to_model_input` equals the PIL uint8 canvas normalized there;
  * `run_model --native_io 1` against `--native_io 0` and against the JAX
    `run_model --native_io 1`; `--native_io 1` with the library missing
    takes the PIL path and gives the same results;
  * the evaluator's mAP with libdcgeom and with its numpy path;
  * a failing `make` leaves the library unavailable, with its error;
  * four processes loading from one empty build directory at once all
    load (one builds, under the lock; none opens a half-written file);
  * a library of another ABI version in the build directory is left
    alone: the expected version builds beside it and loads.

Every test that needs a library skips when `native/Makefile` cannot
build it here.
"""

import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from densecap_tpu.cli import run_model as jax_run
from densecap_tpu_torch import native_lib
from densecap_tpu_torch.cli import run_model
from densecap_tpu_torch.config import VGG_MEAN_BGR
from densecap_tpu_torch.eval.evaluator import DenseCaptioningEvaluator
from densecap_tpu_torch.ops.boxes import merge_boxes
from densecap_tpu_torch.utils.image import (preprocess_for_model_uint8,
                                            to_model_input)
from test_torch_cli_eval import COMMON, _results, _same_results
from test_torch_cli_eval import setup  # noqa: F401  (the module fixture)


def _need(name):
    if not native_lib.is_available(name):
        pytest.skip(f"lib{name}.so does not build here: "
                    f"{native_lib.build_error.get(name)}")


def _random_boxes(rng, n):
    xy = rng.uniform(1, 100, (n, 2))
    wh = rng.uniform(1, 60, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_assign_matches_numpy():
    _need("dcgeom")
    rng = np.random.default_rng(0)
    for nd, nt in ((40, 12), (7, 1), (5, 30)):
        det, gt = _random_boxes(rng, nd), _random_boxes(rng, nt)
        det[1] = det[0]  # a second taker of the same gt box
        ov, asg, ok = native_lib.assign(det, gt)
        jmax, ov_np, ok_np = DenseCaptioningEvaluator._assign(
            det.astype(np.float64), gt.astype(np.float64), native=False)
        np.testing.assert_array_equal(asg, jmax)
        np.testing.assert_array_equal(ok, ok_np)
        np.testing.assert_allclose(ov, ov_np, rtol=1e-6, atol=1e-7)
    det = np.float32([[10, 10, 20, 20], [11, 11, 21, 21],
                      [100, 100, 110, 110]])
    ov, asg, ok = native_lib.assign(det, np.float32([[10, 10, 20, 20]]))
    assert ok.tolist() == [1, 0, 0] and asg.tolist() == [0, 0, -1]
    assert ov[0] == pytest.approx(1.0) and ov[2] == 0.0


def test_merge_boxes_matches_numpy():
    _need("dcgeom")
    rng = np.random.default_rng(1)
    cases = [np.float64([[1, 1, 10, 10], [1, 1, 10, 11], [50, 50, 60, 60],
                         [51, 50, 60, 60], [100, 100, 105, 105]])]
    for n in (1, 9, 40):
        base = _random_boxes(rng, n)
        cases.append(np.concatenate([base, base + rng.uniform(
            -2, 2, base.shape).astype(np.float32)]))
    for boxes in cases:
        got = native_lib.merge_boxes(boxes, 0.7)
        ref = merge_boxes(boxes, 0.7)
        assert [g.tolist() for g in got] == [g.tolist() for g in ref]


def test_decode_jpeg_bytes():
    _need("dcio")
    yy, xx = np.mgrid[0:40, 0:50]
    rgb = np.stack([(yy * 5) % 256, (xx * 4) % 256,
                    ((yy + xx) * 3) % 256], -1).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="JPEG", quality=95)
    dec = native_lib.decode_jpeg_bytes(buf.getvalue())
    assert dec is not None and dec.shape == (40, 50, 3)
    pil = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
    np.testing.assert_array_equal(dec, pil)
    assert native_lib.decode_jpeg_bytes(b"not a jpeg") is None


def test_server_decode_native_jpeg_pil_png(monkeypatch):
    _need("dcio")
    from PIL import UnidentifiedImageError

    from densecap_tpu_torch.serve import server

    rgb = np.random.default_rng(5).integers(0, 256, (30, 40, 3),
                                            dtype=np.uint8)
    enc = {}
    for fmt in ("JPEG", "PNG"):
        buf = io.BytesIO()
        Image.fromarray(rgb).save(buf, format=fmt)
        enc[fmt] = buf.getvalue()
    calls = []
    decode = native_lib.decode_jpeg_bytes
    monkeypatch.setattr(native_lib, "decode_jpeg_bytes",
                        lambda data: calls.append(len(data)) or decode(data))
    jpg = server._decode_image(enc["JPEG"])
    np.testing.assert_array_equal(jpg, decode(enc["JPEG"]))
    np.testing.assert_array_equal(server._decode_image(enc["PNG"]), rgb)
    assert calls == [len(enc["JPEG"]), len(enc["PNG"])]  # PNG: PIL after
    with pytest.raises(UnidentifiedImageError):
        server._decode_image(b"not an image")


def test_load_batch_canvas_equals_uint8_path(tmp_path):
    _need("dcio")
    rng = np.random.default_rng(2)
    paths = []
    for i, hw in enumerate([(60, 90), (90, 60), (64, 64), (200, 30)]):
        paths.append(str(tmp_path / f"{i}.jpg"))
        Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(
            paths[-1], quality=92)
    paths.append(str(tmp_path / "missing.jpg"))
    canv, hts, wds, ohts, owds, ok = native_lib.load_batch(
        paths, 64, VGG_MEAN_BGR, num_threads=2)
    assert ok == 4 and canv.dtype == np.float32
    assert hts[4] == wds[4] == ohts[4] == 0 and not canv[4].any()
    for j, path in enumerate(paths[:4]):
        with Image.open(path) as im:
            rgb = np.asarray(im.convert("RGB"))
        u8, h, w, scale = preprocess_for_model_uint8(rgb, 64)
        assert (h, w) == (hts[j], wds[j])
        assert (ohts[j], owds[j]) == rgb.shape[:2]
        assert scale == 64 / float(max(ohts[j], owds[j]))
        f32_in = to_model_input([canv[j]], [h], [w], "cpu")
        u8_in = to_model_input([u8], [h], [w], "cpu")
        for a, b in zip(f32_in, u8_in):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_run_model_native_io_matches_pil_and_jax(setup, tmp_path, capsys,
                                                 monkeypatch):
    from densecap_tpu import native_lib as jax_native_lib

    _need("dcio")
    if not jax_native_lib.is_available("dcio"):
        pytest.skip("the JAX package's loader did not load libdcio")
    args = (["--checkpoint", str(setup / "ck.npz"), "--input_dir",
             str(setup / "frames")] + COMMON)
    jax_run.main(args + ["--output_dir", str(tmp_path / "jax"),
                         "--native_io", "1"])
    assert "native IO" in capsys.readouterr().out
    for flag in ("1", "0"):
        run_model.main(args + ["--output_dir", str(tmp_path / flag),
                               "--native_io", flag, "--device", "cpu"])
        assert ("native IO" in capsys.readouterr().out) == (flag == "1")
    ref = _results(tmp_path / "jax" / "results.json")
    native = _results(tmp_path / "1" / "results.json")
    assert len(native) == 4
    _same_results(native, ref)
    assert native == _results(tmp_path / "0" / "results.json")
    # without the library, --native_io 1 runs PIL and answers the same
    monkeypatch.setattr(native_lib, "is_available", lambda name: False)
    run_model.main(args + ["--output_dir", str(tmp_path / "nolib"),
                           "--device", "cpu", "--fast_io", "1"])
    out = capsys.readouterr()
    assert "native IO" not in out.out and "--fast_io" in out.err
    assert native == _results(tmp_path / "nolib" / "results.json")


def test_evaluator_map_native_and_numpy(monkeypatch):
    _need("dcgeom")
    words = ["a cat", "a dog", "red car", "tree"]

    def run():
        ev = DenseCaptioningEvaluator()
        r = np.random.default_rng(4)
        for _ in range(6):
            gt = r.uniform(20, 80, (8, 4))
            gt[:, 2:] = r.uniform(10, 40, (8, 2))
            gt[4:] = gt[:4] + r.uniform(-1, 1, (4, 4))  # merge partners
            det = np.concatenate([gt + r.normal(0, 3, gt.shape),
                                  r.uniform(20, 80, (5, 4))])
            ev.add_result(r.normal(0, 1, len(det)), det,
                          [words[i % 4] for i in r.integers(0, 4, len(det))],
                          gt, [words[i % 4] for i in range(8)])
        return ev.evaluate(), ev.records

    native, rec_native = run()
    monkeypatch.setattr(native_lib, "is_available", lambda name: False)
    plain, rec_plain = run()
    assert native["map"] > 0
    assert native["map"] == pytest.approx(plain["map"], abs=1e-12)
    assert native["detmap"] == pytest.approx(plain["detmap"], abs=1e-12)
    assert [(r["ok"], r["references"]) for r in rec_native] == [
        (r["ok"], r["references"]) for r in rec_plain]


def test_failed_build_is_reported(tmp_path, monkeypatch):
    (tmp_path / "Makefile").write_text(
        "libdcgeom.so:\n\t@echo no compiler here >&2; exit 3\n")
    monkeypatch.setattr(native_lib, "NATIVE_DIR", str(tmp_path))
    monkeypatch.setattr(native_lib, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native_lib, "_libs", {})
    monkeypatch.setattr(native_lib, "build_error", {})
    assert not native_lib.is_available("dcgeom")
    assert "no compiler here" in native_lib.build_error["dcgeom"]
    with pytest.raises(RuntimeError, match="unavailable"):
        native_lib.merge_boxes(np.zeros((2, 4)), 0.7)


LOAD_IN = """
import sys
from densecap_tpu_torch import native_lib
native_lib.BUILD_DIR = sys.argv[1]
ok = native_lib.is_available("dcgeom")
groups = native_lib.merge_boxes([[0, 0, 9, 9], [0, 0, 9, 10]], 0.7) if ok else []
print(ok, len(groups), native_lib.build_error.get("dcgeom"))
"""


def test_concurrent_loads_build_once(tmp_path):
    _need("dcgeom")
    build_dir = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", LOAD_IN, str(build_dir)],
                              cwd=native_lib.ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split() == ["True", "1", "None"], out
    # published and cleaned: the library and its lock, no work directory
    assert sorted(os.listdir(build_dir)) == ["libdcgeom.lock",
                                             "libdcgeom_abi1.so"]


def test_stale_abi_is_rebuilt(tmp_path, monkeypatch):
    _need("dcgeom")
    build_dir = tmp_path / "build"
    build_dir.mkdir()
    src = tmp_path / "stale.cpp"
    src.write_text('extern "C" int dcgeom_abi_version() { return 0; }\n')
    # a library of ABI version 0 under its versioned name and under the
    # plain one
    stale = ["libdcgeom_abi0.so", "libdcgeom.so"]
    for name in stale:
        subprocess.run(["g++", "-shared", "-fPIC", "-o",
                        str(build_dir / name), str(src)], check=True)
    monkeypatch.setattr(native_lib, "BUILD_DIR", str(build_dir))
    monkeypatch.setattr(native_lib, "_libs", {})
    monkeypatch.setattr(native_lib, "build_error", {})
    assert native_lib.is_available("dcgeom"), native_lib.build_error
    assert native_lib._libs["dcgeom"].dcgeom_abi_version() == 1
    groups = native_lib.merge_boxes([[0, 0, 9, 9], [0, 0, 9, 10]], 0.7)
    assert [g.tolist() for g in groups] == [[0, 1]]
    assert sorted(os.listdir(build_dir)) == sorted(
        stale + ["libdcgeom.lock", "libdcgeom_abi1.so"])
