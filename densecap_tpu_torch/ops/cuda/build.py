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
SOURCES = (_HERE / "nms.cu", _HERE / "roi_align.cu", _HERE / "conv_pool.cu")
BUILD_DIR = _HERE.parents[2] / "build" / "torch_kernels"

# -fmad=false: no FMA contraction, so the NMS IoU rounds exactly as the
# plain PyTorch version does (a kernel that wants an FMA calls fmaf).
# Never add --use_fast_math.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None
build_seconds = None

# Launch counts per kernel. A wrapper adds one where it launches its
# kernel and nowhere else. K2b is two launches: the coordinate gradient
# (roi_align_bwd) and the feature scatter (roi_align_bwd_feats).
launches = {"nms": 0, "roi_align": 0, "roi_align_bwd": 0,
            "roi_align_bwd_feats": 0, "conv_pool": 0}


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


def _run(cmds):
    """Run the commands at once; raise with the first failure's output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    outs = [(cmd, p.communicate()[0], p.returncode) for cmd, p in procs]
    for cmd, out, rc in outs:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")


def _compile(so):
    """One nvcc per source, all started together, then one link."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        nvcc = _nvcc()
        objs = [os.path.join(tmpdir, src.stem + ".o") for src in SOURCES]
        _run([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
              for src, obj in zip(SOURCES, objs)])
        tmp = os.path.join(tmpdir, so.name)
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
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
                               vp, vp, vp]
        lib.dc_nms.restype = ci
        lib.dc_roi_align_fwd.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci,
                                         ci, ci, ci, vp, vp]
        lib.dc_roi_align_fwd.restype = ci
        lib.dc_roi_align_bwd_feats.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci,
                                               ci, ci, ci, ci, vp, vp]
        lib.dc_roi_align_bwd_feats.restype = ci
        lib.dc_roi_align_bwd_coords.argtypes = [vp, vp, vp, vp, vp, vp, vp,
                                                ci, ci, ci, ci, ci, ci, vp,
                                                vp, vp]
        lib.dc_roi_align_bwd_coords.restype = ci
        lib.dc_conv_relu_pool.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                          vp, vp]
        lib.dc_conv_relu_pool.restype = ci
        _lib = lib
        return lib


def check(rc, name):
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")
