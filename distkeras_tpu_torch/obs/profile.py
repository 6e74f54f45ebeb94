"""Recompilation sentinel over the port's tensor trees (the counterpart of
``distkeras_tpu.obs.profile.RetraceSentinel``).

PyTorch runs eagerly, so nothing is traced; a "compile" here is the first
call of a program with a given argument signature — tree structure plus
each tensor leaf's ``(shape, dtype)`` — and a "retrace" is any new
signature after the first.  The counters keep the JAX package's names
(``jit.compiles`` / ``jit.retraces``), so the serving contract reads the
same: after ``warmup()`` every bucketed program has its signature, and
steady-state serving holds ``jit.retraces == 0``.

Also here: ``ProfileConfig``, the trainers' ``profile=`` knobs, and
``observe_memory``, the ``mem.*`` gauges read from PyTorch's CUDA
allocator.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from typing import Any, Optional, Sequence, Tuple, Union

import torch

from .logging import get_logger
from .registry import Registry, default_registry

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
    first).  Counters land in ``registry`` — a ``Registry``, a zero-arg
    callable returning one, or None for the process-wide default.
    Retraces log once per signature unless ``warn=False`` and, with a
    ``sink``, emit a ``retrace`` record into the JSONL stream."""

    def __init__(self, name: str, registry=None, sink=None,
                 warn: bool = True):
        self.name = name
        self._registry = registry
        self.sink = sink
        self.warn = bool(warn)
        self._sigs: dict = {}   # signature -> digest
        self._lock = threading.Lock()

    def _reg(self) -> Registry:
        reg = self._registry() if callable(self._registry) \
            else self._registry
        return reg if reg is not None else default_registry()

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
        if self.sink is not None:
            self.sink.log("retrace", entry=self.name, signature=digest,
                          retraces=n_retrace)
        return "retrace"


def observe_memory(device, registry: Optional[Registry] = None
                   ) -> Optional[dict]:
    """Sample the CUDA allocator of ``device`` into the JAX package's
    watermark gauges: ``mem.live_bytes`` (bytes allocated now),
    ``mem.peak_live_bytes`` (the largest such sample) and
    ``mem.device_peak_bytes`` (the allocator's own peak).  Returns the
    snapshot, or None on a CPU device, which has no allocator stats."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    snap = {"live_bytes": torch.cuda.memory_allocated(device),
            "device_peak_bytes": torch.cuda.max_memory_allocated(device)}
    reg = registry if registry is not None else default_registry()
    reg.gauge("mem.live_bytes").set(snap["live_bytes"])
    reg.gauge("mem.device_peak_bytes").set(snap["device_peak_bytes"])
    peak = reg.gauge("mem.peak_live_bytes")
    peak.set(max(peak.value, snap["live_bytes"]))
    return snap


#: where the readings a ``ProfileConfig`` asks for are ported (ROADMAP)
_PROFILE_ITEM = ("ROADMAP Queue 1 item 7 (torch.profiler / "
                 "torch.cuda readings)")


@dataclasses.dataclass
class ProfileConfig:
    """Profiling knobs a trainer accepts as ``profile=`` (the JAX
    package's fields and defaults).

    * ``trace_dir`` / ``trace_epochs`` — per-epoch device captures; not
      ported yet, so a set ``trace_dir`` raises.
    * ``step_split`` — the host/device step-time split; not ported yet,
      so True raises.
    * ``memory`` — sample ``observe_memory`` at each epoch record (CUDA
      allocator bytes; nothing on a CPU device)."""

    trace_dir: Optional[str] = None
    trace_epochs: Optional[Sequence[int]] = (0,)
    step_split: bool = False
    memory: bool = True

    def __post_init__(self):
        if self.trace_dir:
            raise NotImplementedError(
                f"profile trace_dir (per-epoch device captures) is not "
                f"ported yet: {_PROFILE_ITEM}")
        if self.step_split:
            raise NotImplementedError(
                f"profile step_split (the host/device step split) is not "
                f"ported yet: {_PROFILE_ITEM}")

    @staticmethod
    def resolve(spec: Union[None, str, dict, "ProfileConfig"]
                ) -> "ProfileConfig":
        """``None`` (defaults) | a path string (= ``trace_dir``) | a dict
        of fields | a ready ProfileConfig."""
        if spec is None:
            return ProfileConfig()
        if isinstance(spec, ProfileConfig):
            return spec
        if isinstance(spec, str):
            return ProfileConfig(trace_dir=spec)
        if isinstance(spec, dict):
            return ProfileConfig(**spec)
        raise TypeError(f"profile= expects None, a trace dir path, a dict "
                        f"of ProfileConfig fields, or a ProfileConfig "
                        f"(got {type(spec).__name__})")
