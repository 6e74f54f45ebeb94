"""Recompilation sentinel over the port's tensor trees (the counterpart of
``distkeras_tpu.obs.profile.RetraceSentinel``).

PyTorch runs eagerly, so nothing is traced; a "compile" here is the first
call of a program with a given argument signature — tree structure plus
each tensor leaf's ``(shape, dtype)`` — and a "retrace" is any new
signature after the first.  The counters keep the JAX package's names
(``jit.compiles`` / ``jit.retraces``), so the serving contract reads the
same: after ``warmup()`` every bucketed program has its signature, and
steady-state serving holds ``jit.retraces == 0``.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Any, Tuple

from .logging import get_logger
from .registry import Registry

_LOG = "obs.profile"


def tree_signature(args: Any) -> Tuple:
    """Hashable signature of a call's arguments: container structure plus
    each tensor/array leaf's ``(shape, dtype)``; other leaves contribute
    their type only (values never change a program's shapes)."""
    if isinstance(args, dict):
        return ("dict", tuple((k, tree_signature(args[k]))
                              for k in sorted(args)))
    if isinstance(args, (list, tuple)):
        return (type(args).__name__,
                tuple(tree_signature(a) for a in args))
    shape = getattr(args, "shape", None)
    dtype = getattr(args, "dtype", None)
    if shape is not None and dtype is not None:
        return (tuple(shape), str(dtype))
    return type(args).__name__


def signature_digest(sig: Tuple) -> str:
    """Short stable hash of a ``tree_signature`` (what the retrace log
    names)."""
    return hashlib.sha1(repr(sig).encode()).hexdigest()[:12]


class RetraceSentinel:
    """Counts first signatures and retraces of ONE program.

    ``observe(args)`` returns ``"cold"`` (first signature ever),
    ``"warm"`` (seen before) or ``"retrace"`` (a new signature after the
    first).  Counters land in ``registry`` — a ``Registry`` or a zero-arg
    callable returning one.  Retraces log once per signature unless
    ``warn=False``."""

    def __init__(self, name: str, registry, warn: bool = True):
        self.name = name
        self._registry = registry
        self.warn = bool(warn)
        self._sigs: dict = {}   # signature -> digest
        self._lock = threading.Lock()

    def _reg(self) -> Registry:
        return self._registry() if callable(self._registry) \
            else self._registry

    def observe(self, args: Any) -> str:
        sig = tree_signature(args)
        with self._lock:
            if sig in self._sigs:
                return "warm"
            first = not self._sigs
            digest = signature_digest(sig)
            self._sigs[sig] = digest
            n_retrace = len(self._sigs) - 1
        reg = self._reg()
        reg.counter("jit.compiles").inc()
        if first:
            return "cold"
        reg.counter("jit.retraces").inc()
        if self.warn:
            get_logger(_LOG).warning(
                "%s: retrace #%d — new arg signature %s (shapes/dtypes "
                "changed since the first call; steady-state steps should "
                "never change signature)", self.name, n_retrace, digest)
        return "retrace"
