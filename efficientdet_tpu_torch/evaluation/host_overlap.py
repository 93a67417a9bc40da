"""Pairwise IoU on the host for the VOC evaluator: a C++ library loaded with
ctypes, or numpy where it cannot be built.

Counterpart of the JAX package's ``evaluation/host_overlap.py``. The source
is the port's own copy, ``cc/compute_overlap.cc``; it is compiled at first
use with ``g++ -O3 -fPIC -shared`` into ``_build/`` beside the package (not
into the JAX package), under a file name that holds a hash of the source and
the flags, written to a temporary name and renamed into place, under a lock.
Contraction into fused multiply-adds is off, so the library and numpy give
the same bits. A failed build or load is remembered: ``compute_overlap``
runs once per (image, class), and must not start a compiler each time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "cc", "compute_overlap.cc")
BUILD_DIR = os.path.join(_PKG, "_build")
FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-ffp-contract=off"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False
build_error: Optional[str] = None  # why the library is not in use, if it is not


def _lib_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"libcompute_overlap-{digest[:16]}.so")


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed, build_error
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            path = _lib_path()
            if not os.path.exists(path):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{path}.{os.getpid()}.tmp"
                subprocess.run(["g++", *FLAGS, "-o", tmp, SOURCE], check=True,
                               capture_output=True, text=True, timeout=120)
                os.replace(tmp, path)
            lib = ctypes.CDLL(path)
        except (OSError, subprocess.SubprocessError) as e:
            _load_failed = True
            build_error = f"{type(e).__name__}: {getattr(e, 'stderr', None) or e}"
            return None
        fn = lib.compute_overlap_f64
        fn.argtypes = [ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                       ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                       ctypes.POINTER(ctypes.c_double)]
        fn.restype = None
        _lib = lib
        return lib


def compute_overlap_numpy(boxes: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Vectorised numpy IoU with the same semantics as the C++ library."""
    boxes = np.asarray(boxes, np.float64)
    queries = np.asarray(queries, np.float64)
    ix = np.clip(np.minimum(boxes[:, None, 2], queries[None, :, 2])
                 - np.maximum(boxes[:, None, 0], queries[None, :, 0]), 0, None)
    iy = np.clip(np.minimum(boxes[:, None, 3], queries[None, :, 3])
                 - np.maximum(boxes[:, None, 1], queries[None, :, 1]), 0, None)
    inter = ix * iy
    ab = np.clip(boxes[:, 2] - boxes[:, 0], 0, None) * np.clip(boxes[:, 3] - boxes[:, 1], 0, None)
    aq = np.clip(queries[:, 2] - queries[:, 0], 0, None) * np.clip(queries[:, 3] - queries[:, 1], 0, None)
    ua = ab[:, None] + aq[None] - inter
    return np.where(ua > 0, inter / np.maximum(ua, 1e-300), 0.0)


def compute_overlap(boxes: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """(N, 4) x (K, 4) xyxy -> (N, K) float64 IoU, by the C++ library when it
    is built."""
    boxes = np.ascontiguousarray(boxes, np.float64)
    queries = np.ascontiguousarray(queries, np.float64)
    if boxes.ndim != 2 or boxes.shape[1] != 4 or queries.ndim != 2 or queries.shape[1] != 4:
        raise ValueError(f"expected (N, 4) and (K, 4) boxes, got {boxes.shape} and {queries.shape}")
    n, k = len(boxes), len(queries)
    if n == 0 or k == 0:
        return np.zeros((n, k), np.float64)
    lib = _load()
    if lib is None:
        return compute_overlap_numpy(boxes, queries)
    out = np.empty((n, k), np.float64)
    ptr = ctypes.POINTER(ctypes.c_double)
    lib.compute_overlap_f64(boxes.ctypes.data_as(ptr), n, queries.ctypes.data_as(ptr), k,
                            out.ctypes.data_as(ptr))
    return out


def using_native() -> bool:
    """Whether ``compute_overlap`` runs the C++ library (building it now if
    it has not been tried)."""
    return _load() is not None
