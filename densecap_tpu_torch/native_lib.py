"""ctypes bindings for the native host runtime (twin of
densecap_tpu/native_lib.py): `libdcio.so` (threaded JPEG decode, resize
and canvas fill) and `libdcgeom.so` (the evaluator's box merge and greedy
assignment), built from the sources in `native/`.

The port builds its own copies into `build/native/`, never into
`native/`, where the JAX package's loader builds. The first request
builds a missing library with `native/Makefile` (its rule and flags), in
a directory of its own, and publishes it with `os.replace` under a lock
file in `build/native/`: processes that load at once build it once, and
none ever opens a half-written file. The published file is named by the
ABI version these bindings were written for (`libdcgeom_abi1.so`), so a
library of another version is never found where they look: a new
version builds beside it. When `make` fails, for example without the
libjpeg headers, `is_available` is False, `build_error` says why, and
the callers take their PIL / numpy paths, as the JAX package's do. Host code only: nothing here touches the device.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(ROOT, "native")  # sources and Makefile
BUILD_DIR = os.path.join(ROOT, "build", "native")
# ABI of each library (dc<name>_abi_version in its .cpp)
_ABI = {"dcio": 4, "dcgeom": 1}
_P = ctypes.c_void_p
_SIGNATURES = {
    "dcio": {
        "dcio_abi_version": (ctypes.c_int, []),
        "dcio_load_batch": (ctypes.c_int, [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            _P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int]),
        "dcio_decode_jpeg_mem": (ctypes.c_int, [
            _P, ctypes.c_long, _P, ctypes.c_long,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]),
    },
    "dcgeom": {
        "dcgeom_abi_version": (ctypes.c_int, []),
        "dcgeom_assign": (None, [_P, ctypes.c_int, _P, ctypes.c_int,
                                 _P, _P, _P]),
        "dcgeom_merge_boxes": (ctypes.c_int, [_P, ctypes.c_int,
                                              ctypes.c_float, _P]),
    },
}
# largest decoded image accepted (8192 x 8192 RGB), as in the JAX twin
MAX_DECODED_BYTES = 8192 * 8192 * 3

_lock = threading.Lock()
_libs = {}
build_error = {}


def _open(path, name):
    """dlopen `path`, check its ABI version and declare the signatures."""
    lib = ctypes.CDLL(path)
    version = getattr(lib, f"{name}_abi_version")()
    if version != _ABI[name]:  # before the signatures: it may lack some
        raise RuntimeError(f"{path} reports ABI version {version}, these "
                           f"bindings are for {_ABI[name]}")
    for fn, (restype, argtypes) in _SIGNATURES[name].items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def library_path(name):
    """Where lib<name>.so of the expected ABI version is published."""
    return os.path.join(BUILD_DIR, f"lib{name}_abi{_ABI[name]}.so")


def _build(name):
    """Build lib<name>.so and publish it at `library_path(name)`, unless
    another process has published it while this one waited for the
    lock."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = library_path(name)
    with open(os.path.join(BUILD_DIR, f"lib{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(so):
            return
        work = tempfile.mkdtemp(prefix=f"lib{name}.", dir=BUILD_DIR)
        try:
            # the Makefile's own rule, run in `work`, finding the sources
            # in native/ through VPATH; -B, since VPATH would also find
            # (and call up to date) a library the JAX loader built there
            cmd = ["make", "-B", "-C", work, "-f",
                   os.path.join(NATIVE_DIR, "Makefile"),
                   f"VPATH={NATIVE_DIR}", f"lib{name}.so"]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode:
                raise RuntimeError(
                    f"{' '.join(cmd)} failed ({proc.returncode}): "
                    f"{(proc.stderr or proc.stdout).strip()[-2000:]}")
            os.replace(os.path.join(work, f"lib{name}.so"), so)
        finally:
            shutil.rmtree(work, ignore_errors=True)


def _load(name):
    with _lock:
        if name in _libs:
            return _libs[name]
        lib = None
        try:
            if not os.path.exists(library_path(name)):
                _build(name)
            lib = _open(library_path(name), name)
        except (OSError, RuntimeError, AttributeError) as e:
            build_error[name] = str(e)
        _libs[name] = lib
        return lib


def is_available(name):
    """Whether lib<name>.so ("dcio" or "dcgeom") loads, building it first
    if needed."""
    return _load(name) is not None


def _lib(name):
    lib = _load(name)
    if lib is None:
        raise RuntimeError(f"lib{name}.so is unavailable: "
                           f"{build_error.get(name, '')}")
    return lib


def _ptr(a):
    return a.ctypes.data_as(_P)


def assign(det_boxes_sorted, gt_boxes):
    """Greedy evaluator assignment of (nd, 4) x1y1x2y2 detections, sorted
    by descending score, to (nt, 4) merged gt boxes: per detection its
    best pascal IoU, the gt it takes (-1 for none) and whether it was the
    first to take it."""
    d = np.ascontiguousarray(det_boxes_sorted, np.float32).reshape(-1, 4)
    g = np.ascontiguousarray(gt_boxes, np.float32).reshape(-1, 4)
    nd = len(d)
    ov = np.empty(nd, np.float32)
    asg = np.empty(nd, np.int32)
    ok = np.empty(nd, np.int32)
    _lib("dcgeom").dcgeom_assign(_ptr(d), nd, _ptr(g), len(g), _ptr(ov),
                                 _ptr(asg), _ptr(ok))
    return ov, asg, ok


def merge_boxes(boxes, thr):
    """Greedy grouping of (n, 4) x1y1x2y2 boxes at pascal IoU >= thr (the
    numpy `ops.boxes.merge_boxes`): a list of index arrays, greedy order."""
    b = np.ascontiguousarray(boxes, np.float32).reshape(-1, 4)
    gid = np.empty(len(b), np.int32)
    n = _lib("dcgeom").dcgeom_merge_boxes(_ptr(b), len(b), float(thr),
                                          _ptr(gid))
    return [np.nonzero(gid == g)[0] for g in range(n)]


def load_batch(paths, canvas_size, mean_bgr, num_threads=8, fast_dct=False):
    """Decode and preprocess JPEGs on C++ threads.

    Returns (canvases (n, S, S, 3) f32 BGR, mean subtracted, zero padded;
    heights, widths, orig_heights, orig_widths (n,) f32; the count
    decoded). A file that fails leaves a zero canvas and zero sizes.
    `fast_dct` decodes a large JPEG at the smallest DCT scale that still
    covers the canvas and resizes the rest: faster, not bit-identical.
    """
    lib = _lib("dcio")
    n, S = len(paths), int(canvas_size)
    canv = np.zeros((n, S, S, 3), np.float32)
    sizes = np.zeros((4, n), np.float32)
    mean = np.ascontiguousarray(mean_bgr, np.float32)
    names = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    ok = lib.dcio_load_batch(names, n, S, _ptr(mean), _ptr(canv),
                             *(_ptr(row) for row in sizes),
                             int(num_threads), int(bool(fast_dct)))
    return (canv, *sizes, ok)


def decode_jpeg_bytes(data):
    """JPEG bytes -> (H, W, 3) uint8 RGB, or None when they do not decode."""
    lib = _lib("dcio")
    raw = np.frombuffer(data, np.uint8)
    buf = np.empty(MAX_DECODED_BYTES, np.uint8)
    h, w = ctypes.c_int(), ctypes.c_int()
    if not lib.dcio_decode_jpeg_mem(_ptr(raw), len(raw), _ptr(buf),
                                    MAX_DECODED_BYTES, ctypes.byref(h),
                                    ctypes.byref(w)):
        return None
    return buf[:h.value * w.value * 3].reshape(h.value, w.value, 3).copy()
