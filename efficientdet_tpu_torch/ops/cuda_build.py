"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each source in ``csrc/`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), under
``_build/`` beside the package, at first use. The library's file name holds
a hash of its source and flags, so an edited source is rebuilt. Nothing here
runs at import: the CPU-only tests import every module without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, Iterable, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# Per-source extra flags. The NMS mask must agree bit for bit with the
# float32 reference, so no multiply-add may be contracted into an FMA.
EXTRA_FLAGS: Dict[str, List[str]] = {
    "nms_suppress": ["-fmad=false"],
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# ptxas register/shared-memory report of each build, by source name
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found (set CUDA_HOME); nvcc is required")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _flags(name: str) -> List[str]:
    return ARCH_FLAGS + BASE_FLAGS + EXTRA_FLAGS.get(name, [])


def _lib_path(name: str) -> str:
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_flags(name)).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{digest[:16]}.so")


def build(names: Iterable[str]) -> None:
    """Compile the named sources that are not built yet, all nvcc at once."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *_flags(name), "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_lib_path(name))
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if ``name``'s C entry point returned a non-zero cudaError_t.

    Each library exports ``<name>_error_string`` for the message.
    """
    if err != 0:
        fn = getattr(lib, f"{name}_error_string")
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{name}: CUDA error {err}: {fn(err).decode()}")
