"""ctypes binding for the native greedy-assembly fast path
(csrc/grouping.cpp) — the clean-ABI successor of the reference's SWIG
pafprocess extension (utils/pafprocess/make.sh, setup.py).

The port's copy of ``improved_body_parts_tpu/ops/group_cpp.py``. Builds the
shared library on first use (g++ -O3) into ``build/torch_kernels/`` under
its own name, apart from the JAX package's library; callers fall back to the
numpy implementation (ops/group.py) when no compiler is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Sequence, Tuple

import numpy as np

from improved_body_parts_tpu_torch.configs import (
    LIMB_FROM, LIMB_TO, NUM_PARTS, InferenceConfig,
)
from improved_body_parts_tpu_torch.ops.build import BUILD_DIR, CSRC_DIR

_SRC = os.path.join(CSRC_DIR, "grouping.cpp")
_LIB = os.path.join(BUILD_DIR, "libibp_torch_grouping.so")

_lock = threading.Lock()
_lib = None


def _build() -> None:
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           _SRC, "-o", tmp]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _LIB)        # atomic: a concurrent loader sees all or none


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if (not os.path.exists(_LIB)
                or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            _build()
        lib = ctypes.CDLL(_LIB)
        lib.ibp_find_humans.restype = ctypes.c_int
        lib.ibp_find_humans.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,    # conns
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,    # cands
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,                                     # limb tables
            ctypes.c_double, ctypes.c_double, ctypes.c_int,   # gates
            ctypes.c_int, ctypes.c_double,                    # cull
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,    # out
        ]
        _lib = lib
        return lib


def is_available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


def find_humans(connected_limbs: Sequence[np.ndarray],
                joint_candidates: np.ndarray,
                cfg: InferenceConfig = InferenceConfig()) -> Tuple[np.ndarray, np.ndarray]:
    """Drop-in replacement for ops.group.find_humans (same I/O contract)."""
    lib = _load()

    rows = []
    for limb_type, conns in enumerate(connected_limbs):
        if conns is None or len(conns) == 0:
            continue
        block = np.empty((len(conns), 7), np.float64)
        block[:, 0] = limb_type
        block[:, 1:7] = conns[:, :6]
        rows.append(block)
    flat = (np.concatenate(rows, axis=0) if rows
            else np.zeros((0, 7), np.float64))
    flat = np.ascontiguousarray(flat)
    cands = np.ascontiguousarray(joint_candidates, np.float64)
    lf = np.ascontiguousarray(LIMB_FROM, np.int32)
    lt = np.ascontiguousarray(LIMB_TO, np.int32)

    max_out = max(len(flat) + 8, 64)
    out = np.zeros((max_out, NUM_PARTS + 2, 2), np.float64)
    n = lib.ibp_find_humans(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(flat),
        cands.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(cands),
        lf.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        lt.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), len(lf),
        float(cfg.len_rate), float(cfg.connection_tole),
        int(bool(cfg.remove_recon)),
        int(cfg.min_person_parts), float(cfg.min_person_score),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), max_out)
    if n < 0:
        raise RuntimeError("ibp_find_humans: output table overflow")
    return out[:n].copy(), joint_candidates
