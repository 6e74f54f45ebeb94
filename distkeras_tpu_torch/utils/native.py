"""ctypes bindings for the native host data plane — the port of
``distkeras_tpu.utils.native`` over the same C source,
``native/dknative.cpp``.

The source is read, never written: at first use it is compiled with
``g++`` and ``native/Makefile``'s flags (plus ``-ffp-contract=off``,
which keeps ``a + scale*b`` two rounded operations on every host) into
the git-ignored ``distkeras_tpu_torch/_build/``, under a name keyed by
the source and the flags, and replaced there atomically, so processes
starting together never read a half-written library.  The port uses one
entry point of it: ``fused_add(a, b, scale)``, ``a + scale·b`` in one
multithreaded pass (the PS commit rule; ctypes releases the GIL for the
duration).  Its NumPy fallback gives the same result bit for bit (f32
and f64: one product, one sum, each rounded); ``available()`` reports
which path is active.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "native", "dknative.cpp")
BUILD_DIR = os.path.join(_ROOT, "distkeras_tpu_torch", "_build")
#: ``native/Makefile``'s CXXFLAGS, and no FMA contraction
CXXFLAGS = ["-O3", "-fPIC", "-std=c++17", "-pthread", "-Wall",
            "-ffp-contract=off"]

_lib = None
_tried = False
_lock = threading.Lock()


def lib_path() -> str:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libdknative-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library if it is not built yet; returns its path.
    Raises RuntimeError with the compiler's output if the build fails."""
    dst = lib_path()
    if os.path.exists(dst):
        return dst
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        so = os.path.join(tmp, "lib.so")
        res = subprocess.run([cxx, *CXXFLAGS, "-shared", "-o", so, SOURCE],
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True,
                             timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"{cxx} failed on {SOURCE}:\n{res.stdout}")
        os.replace(so, dst)
    return dst


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(build())
            lib.dk_fused_add_f32.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_float, ctypes.c_size_t, ctypes.c_int]
            lib.dk_fused_add_f64.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_double, ctypes.c_size_t, ctypes.c_int]
            if lib.dk_version() != 1:
                raise RuntimeError("unexpected dknative ABI version")
            _lib = lib
        except (OSError, RuntimeError, subprocess.SubprocessError):
            _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def fused_add(a: np.ndarray, b: np.ndarray, scale: float = 1.0,
              nthreads: int = 0) -> np.ndarray:
    """``a + scale·b`` — fused native pass when possible, NumPy otherwise.

    Always returns a NEW array (replace semantics: safe for the PS's
    lock-free pull snapshots)."""
    lib = _load()
    if (lib is None or a.dtype != b.dtype or a.shape != b.shape
            or a.dtype not in (np.float32, np.float64)):
        return (a + np.asarray(b, a.dtype) * scale).astype(a.dtype, copy=False)
    a = np.ascontiguousarray(a)
    b = np.ascontiguousarray(b)
    out = np.empty_like(a)
    fn = (lib.dk_fused_add_f32 if a.dtype == np.float32
          else lib.dk_fused_add_f64)
    fn(out.ctypes.data, a.ctypes.data, b.ctypes.data, scale, a.size, nthreads)
    return out

