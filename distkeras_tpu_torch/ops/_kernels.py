"""Build and load the flash-attention kernels: ``nvcc`` → one shared
library with a plain C interface → ``ctypes``.

``csrc/flash_fwd.cu`` (the C interface of K1 in both dtypes, and K1 on
CUDA cores past head dim 128), ``csrc/flash_fwd_tf32_sm90.cu`` (K1 in
f32, as 3xTF32 on mma.sync), ``csrc/flash_fwd_sm90.cu`` (K1 in bf16),
``csrc/flash_bwd.cu`` (the C interface of K2, K3),
``csrc/flash_bwd_tf32_sm90.cu`` (K2, K3 in f32, as 3xTF32 on mma.sync),
``csrc/flash_bwd_sm90.cu`` (K2, K3 in bf16) and ``csrc/flash_bwd_wide.cu``
(on CUDA cores f32 K2 at head dims 129–256, K2 and K3 past 256; the
``_sm90`` files include ``csrc/sm90.cuh``, their shared PTX and
tensor-map helpers, the ``_tf32_`` ones ``csrc/tf32.cuh``, the 3xTF32
pieces, and the two C interfaces ``csrc/launched.h``, the codes of the
kernel a call ran) compile in parallel, one ``nvcc`` each, and link into
``distkeras_tpu_torch/_build/`` (listed in ``.gitignore``) under a name
keyed by a hash of every file under ``csrc/`` and the flags, so a
changed source or header rebuilds and an unchanged tree is reused.
Nothing here runs at import: the first ``library()`` call builds it if
stale.
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
from typing import Optional

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCES = tuple(os.path.join(_CSRC, f)
                for f in ("flash_fwd.cu", "flash_fwd_tf32_sm90.cu",
                          "flash_fwd_sm90.cu", "flash_bwd.cu",
                          "flash_bwd_tf32_sm90.cu", "flash_bwd_sm90.cu",
                          "flash_bwd_wide.cu"))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: function name -> (restype, argtypes)
SIGNATURES = {
    # q, k, v, o, lse, bh, tq, tk, head_dim, causal, scale, dtype, device,
    # stream -> cudaError_t
    "dkt_flash_fwd": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I,
                           _I, _P]),
    # q, k, v, dout, lse, dvec, dq, bh, tq, tk, head_dim, causal, scale,
    # dtype, device, stream -> cudaError_t
    "dkt_flash_bwd_dq": (_I, [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _I, _F, _I, _I, _P]),
    # as dkt_flash_bwd_dq with dk, dv in place of dq
    "dkt_flash_bwd_dkv": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _F, _I, _I, _P]),
    # -> the kernel the calling thread's last launch ran (csrc/launched.h)
    "dkt_flash_last_kernel": (_I, []),
    "dkt_error_string": (ctypes.c_char_p, [_I]),
}

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def lib_path() -> str:
    """The library path for the current flags and every file under
    ``csrc/`` (sources and the headers they include)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(_CSRC)):
        h.update(name.encode())
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libflash-{h.hexdigest()[:16]}.so")


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
                           "the CUDA kernels are built on first use")
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(s) + ".o") for s in SOURCES]
        # one nvcc per source, all started together, then one link
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, s],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(SOURCES, objs)]
        log = "".join([p.communicate()[0] for p in procs])
        if all(p.returncode == 0 for p in procs):
            so = os.path.join(tmp, "lib.so")
            link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", so,
                                   *objs], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            log += link.stdout
            if link.returncode == 0:
                os.replace(so, dst)
    if not os.path.exists(dst):
        raise RuntimeError(f"nvcc failed:\n{log}")
    return {"built": True, "seconds": time.perf_counter() - t0, "log": log}


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
