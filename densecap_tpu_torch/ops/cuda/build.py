"""Build and bind the hand-written CUDA kernels; count their launches.

The `.cu` files beside this module compile with nvcc into one shared
library with a plain C interface, loaded with ctypes. The library is
named by a hash of its sources and flags, so an edit rebuilds, and lives
in `build/torch_kernels/` at the root of the checkout. Nothing is built
when this module is imported: `load()` builds on first use, on a machine
with the CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
SOURCES = (_HERE / "nms.cu", _HERE / "roi_align.cu")
BUILD_DIR = _HERE.parents[2] / "build" / "torch_kernels"

# -fmad=false: no FMA contraction, so the NMS IoU rounds exactly as the
# plain PyTorch version does. Never add --use_fast_math.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None
build_seconds = None

# Launch counts per kernel. A wrapper adds one where it launches its
# kernel and nowhere else.
launches = {"nms": 0, "roi_align": 0}


def reset_launches():
    with _lock:
        for k in launches:
            launches[k] = 0


def count_launch(name):
    with _lock:
        launches[name] += 1


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def library_path():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdc_torch_kernels_{h.hexdigest()[:16]}.so"


def _compile(so):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent loader never sees a partial file


def load():
    """Return the kernel library, building it first if needed."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        t0 = time.perf_counter()
        if not so.exists():
            _compile(so)
        build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(so))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.dc_nms.argtypes = [vp, vp, ci, ci, ci, ctypes.c_float,
                               vp, vp, vp, vp]
        lib.dc_nms.restype = ci
        lib.dc_roi_align_fwd.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci,
                                         ci, ci, ci, vp, vp]
        lib.dc_roi_align_fwd.restype = ci
        _lib = lib
        return lib


def check(rc, name):
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")
