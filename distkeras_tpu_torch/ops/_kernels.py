"""Build and load the flash-attention forward kernel: ``nvcc`` → shared
library with a plain C interface → ``ctypes``.

``csrc/flash_fwd.cu`` builds into ``distkeras_tpu_torch/_build/`` (listed
in ``.gitignore``), under a name keyed by a hash of the source and the
flags, so a changed source rebuilds and an unchanged one is reused.
Nothing here runs at import: the first ``library()`` call builds it if
stale.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "flash_fwd.cu")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
#: function name -> (restype, argtypes)
SIGNATURES = {
    # q, k, v, o, lse, bh, tq, tk, head_dim, causal, scale, dtype, device,
    # stream -> cudaError_t
    "dkt_flash_fwd": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           ctypes.c_float, _I, _I, _P]),
    "dkt_error_string": (ctypes.c_char_p, [_I]),
}

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def lib_path() -> str:
    """The library path for the current source and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libflash_fwd-{h.hexdigest()[:16]}.so")


def build() -> dict:
    """Build the library if stale.  Returns ``{"built": bool, "seconds":
    float, "log": str}`` (``log`` holds nvcc's and ptxas's output);
    raises RuntimeError with the compiler output if the build fails."""
    dst = lib_path()
    if os.path.exists(dst):
        return {"built": False, "seconds": 0.0, "log": ""}
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (on PATH or /usr/local/cuda/bin); "
                           "the CUDA kernel is built on first use")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{dst}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, SOURCE],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc flash_fwd.cu failed (exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, dst)
    return {"built": True, "seconds": time.perf_counter() - t0,
            "log": proc.stdout}


def library() -> ctypes.CDLL:
    """The loaded library, built first if stale."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            build()
            lib = ctypes.CDLL(lib_path())
            for fn, (restype, argtypes) in SIGNATURES.items():
                f = getattr(lib, fn)
                f.restype = restype
                f.argtypes = argtypes
            _LIB = lib
    return _LIB
