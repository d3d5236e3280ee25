"""Build and load the port's CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles each source to an object, all sources at once in
parallel processes, and links them into one shared library with a plain C
interface, loaded with ``ctypes``. The build runs at first use, keyed on a
hash of the sources and flags, into ``build/torch_kernels/`` at the root of
the checkout; a later call (or process) with the same sources loads the
existing library. Nothing is compiled or loaded at import.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_ARGTYPES = {
    # heat, out, n, h, w, thre, plus, stream
    "ibp_nms": [_P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_int, _P],
    # heat, scores, yx, n_raw, patches, k, h, w, max_peaks, win, thre,
    # plus, stream
    "ibp_fused_peaks": [_P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int, ctypes.c_int,
                        ctypes.c_float, ctypes.c_int, _P],
    "ibp_fused_peaks_max_list_keys": [],
    # x, w, bias, w_scale, a_scale, out, n, h, w, cin, cout, kh, kw, stride,
    # pad, dilation, ho, wo, relu, bf16, stream
    "ibp_int8_conv": [_P, _P, _P, _P, _P, _P] + [ctypes.c_int] * 14 + [_P],
    # x, out, a_scale, n, bf16, stream
    "ibp_int8_quantize": [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P],
    # x (or None), x_bf16, xq, w, bias, w_scale, a_scale, a_next (or None),
    # out, n, h, w, cin, cout, k, pad, dilation, ho, wo, relu, bf16, stream
    "ibp_int8_conv_wgmma": [_P, ctypes.c_int] + [_P] * 7 + [ctypes.c_int] * 12 + [_P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# what the last build did: library path, seconds spent, compiler output
build_info: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (needed to build the CUDA kernels)")


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libibp_torch_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the sources unless a library for them exists; returns its path."""
    out = library_path()
    if os.path.exists(out):
        build_info.update(path=out, seconds=0.0, log="(cached)")
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in _sources():           # one nvcc per source, all started together
        obj = f"{tmp}.{os.path.basename(src)}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    log = []
    for proc in procs:
        log.append(proc.communicate()[0])
    try:
        for proc, text in zip(procs, log):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{text}")
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stderr}")
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, out)           # atomic: a concurrent loader sees all or none
    build_info.update(path=out, seconds=time.perf_counter() - t0,
                      log="".join(log))
    return out


def load() -> ctypes.CDLL:
    """The kernels' library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _ARGTYPES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
