"""Profiling for the port (the counterpart of
``distkeras_tpu.obs.profile``): the recompilation sentinel, memory
watermarks, the host/device step-time split, the device trace seam and
the trainers' ``profile=`` knobs.

PyTorch runs eagerly, so nothing is traced; a "compile" here is the first
call of a program with a given argument signature — tree structure plus
each tensor leaf's ``(shape, dtype)`` — and a "retrace" is any new
signature after the first.  The counters keep the JAX package's names
(``jit.compiles`` / ``jit.retraces``), so the serving contract reads the
same: after ``warmup()`` every bucketed program has its signature, and
steady-state serving holds ``jit.retraces == 0``.

* ``memory_snapshot`` / ``observe_memory`` — the ``mem.*`` gauges, read
  from PyTorch's CUDA allocator.
* ``step_split`` — a step program's host dispatch (``time.perf_counter``)
  beside its span on the device's timeline (CUDA events), one sync per
  call after the timed dispatch.
* ``device_trace`` — a ``torch.profiler`` capture of a region, written
  as a Chrome trace into a directory.
* ``ProfileConfig`` — what a trainer's ``profile=`` asks for.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os
import threading
import time
from typing import Any, Callable, Optional, Sequence, Tuple, Union

import torch

from .logging import get_logger
from .registry import TIME_BUCKETS, Registry, default_registry

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


#: guards the read-modify-write on the max-tracked peak gauge (Gauge ops
#: are individually locked, but max() needs the pair to be atomic across
#: concurrently-heartbeating workers)
_PEAK_LOCK = threading.Lock()


def memory_snapshot(device=None) -> Optional[dict]:
    """Point-in-time device-memory accounting of ``device`` (default: the
    current card) from PyTorch's CUDA allocator: ``live_bytes`` (bytes
    allocated now), ``live_arrays`` (allocations live now) and
    ``device_peak_bytes`` (the allocator's peak).  None on a CPU device,
    which keeps no allocator statistics."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(device)
    return {"live_bytes": int(torch.cuda.memory_allocated(device)),
            "live_arrays": int(stats.get("active.all.current", 0)),
            "device_peak_bytes":
                int(torch.cuda.max_memory_allocated(device))}


def observe_memory(device, registry: Optional[Registry] = None
                   ) -> Optional[dict]:
    """Sample ``memory_snapshot(device)`` into the JAX package's watermark
    gauges: ``mem.live_bytes`` / ``mem.live_arrays`` (levels),
    ``mem.peak_live_bytes`` (the largest live-bytes sample this registry
    saw) and ``mem.device_peak_bytes`` (the allocator's own peak).
    Returns the snapshot, or None on a CPU device."""
    snap = memory_snapshot(device)
    if snap is None:
        return None
    reg = registry if registry is not None else default_registry()
    reg.gauge("mem.live_bytes").set(snap["live_bytes"])
    reg.gauge("mem.live_arrays").set(snap["live_arrays"])
    reg.gauge("mem.device_peak_bytes").set(snap["device_peak_bytes"])
    with _PEAK_LOCK:
        peak = reg.gauge("mem.peak_live_bytes")
        if snap["live_bytes"] > peak.value:
            peak.set(snap["live_bytes"])
    return snap


# ---------------------------------------------------------------------------
# step-time split
# ---------------------------------------------------------------------------

def step_split(fn: Callable, registry=None, prefix: str = "step",
               device=None) -> Callable:
    """Wrap a step/window program with the host/device time split.
    Observations land in ``<prefix>.host_seconds`` /
    ``<prefix>.device_seconds`` histograms in ``registry`` (instance,
    zero-arg callable, or None for the default registry).

    On a card, ``host_seconds`` is the call's dispatch on the host's clock
    (``time.perf_counter`` around the call: the card runs its kernels
    asynchronously) and ``device_seconds`` the call's span on the
    device's timeline, between CUDA events recorded before and after it
    on the current stream.  The wrapper waits for the second event after
    the timed dispatch, never inside it.  The two overlap: a call whose
    device span is no longer than its dispatch kept the card waiting on
    the host.  On a CPU device each op has run when it returns, so the
    whole call is host time and ``device_seconds`` is 0.

    The sync per call is what the trainers' epoch pipelining exists to
    avoid — this is a profiling mode (``ProfileConfig.step_split``), not a
    default.  ``device`` is where the program runs (default: the card)."""

    def wrapped(*args):
        reg = registry() if callable(registry) else registry
        reg = reg if reg is not None else default_registry()
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda":
            stream = torch.cuda.current_stream(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            t0 = time.perf_counter()
            out = fn(*args)
            t1 = time.perf_counter()
            end.record(stream)
            end.synchronize()
            dev_s = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            out = fn(*args)
            t1 = time.perf_counter()
            dev_s = 0.0
        reg.histogram(f"{prefix}.host_seconds", TIME_BUCKETS).observe(t1 - t0)
        reg.histogram(f"{prefix}.device_seconds",
                      TIME_BUCKETS).observe(dev_s)
        return out
    return wrapped


# ---------------------------------------------------------------------------
# device trace seam (torch.profiler)
# ---------------------------------------------------------------------------

#: dirs already announced — the capture log is once per destination, not
#: once per epoch
_ANNOUNCED: set = set()
_ANNOUNCE_LOCK = threading.Lock()

#: the file a capture writes into its ``log_dir``
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the wrapped region (the host's
    ops, and the card's kernels and copies where there is a card) and
    write it as a Chrome trace to ``<log_dir>/trace.json`` (open it in
    ``ui.perfetto.dev``).  The output dir is announced once via
    ``obs.logging``; on an exception inside the region the capture is
    still stopped — a stop failure there is logged instead of masking the
    body's error — and nothing is written."""
    from torch.profiler import ProfilerActivity, profile
    log = get_logger(_LOG)
    with _ANNOUNCE_LOCK:
        if log_dir not in _ANNOUNCED:
            _ANNOUNCED.add(log_dir)
            log.info("device trace capture -> %s (open with "
                     "ui.perfetto.dev)", log_dir)
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    except BaseException:
        try:
            prof.stop()
        except RuntimeError as e:
            # the body's exception is the story; a stop failure on the
            # unwind path must not replace it (but must not hide either)
            log.warning("device trace %s: stop failed during exception "
                        "unwind: %s", log_dir, e)
        raise
    else:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


# ---------------------------------------------------------------------------
# trainer-facing config
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ProfileConfig:
    """Profiling knobs a trainer accepts as ``profile=`` (the JAX
    package's fields and defaults).

    * ``trace_dir`` — per-epoch ``device_trace`` captures into
      ``<trace_dir>/epoch<k>`` for every epoch in ``trace_epochs`` (None =
      no capture).
    * ``trace_epochs`` — which epochs to capture (default: epoch 0);
      None means every epoch.
    * ``step_split`` — wrap the window program in the host/device split
      (``step_split``: a sync per call, so profiling runs only).
    * ``memory`` — sample ``observe_memory`` at each epoch record (CUDA
      allocator bytes; nothing on a CPU device)."""

    trace_dir: Optional[str] = None
    trace_epochs: Optional[Sequence[int]] = (0,)
    step_split: bool = False
    memory: bool = True

    def trace_epoch(self, epoch: int) -> bool:
        """Should ``epoch`` run under a device capture?"""
        if not self.trace_dir:
            return False
        return self.trace_epochs is None or epoch in tuple(self.trace_epochs)

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
