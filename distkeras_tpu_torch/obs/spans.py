"""Nested timed scopes — the port's copy of ``distkeras_tpu.obs.spans``.

A ``SpanTracer`` keeps a thread-local span stack and emits one record per
closed span into the same JSONL sink the metrics use (``MetricsLogger``),
with the JAX package's record fields::

    tracer = SpanTracer(metrics_logger)
    with tracer.span("train"):
        with tracer.span("jit_compile"):
            ...   # -> {"event": "span", "name": "jit_compile",
                  #     "path": "train/jit_compile", "depth": 1,
                  #     "seconds": 1.83, "trace_id": ..., "span_id": ...,
                  #     "parent_span": ...}

Every span carries a thread-local ``trace_id`` (settable) and a
``span_id``; nested spans record the enclosing span as ``parent_span``,
and a ``trace_id``/``parent_span`` keyword adopts a remote caller's
context.  Optionally a ``Registry`` accumulates per-name duration
histograms (``span.<name>.seconds``).  A process-wide default tracer
(``span``) serves ad-hoc call sites.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
import uuid
from typing import Optional, Tuple

from .registry import Registry, TIME_BUCKETS

#: span ids are ``<trace_id>.<salt><seq>``: a process-wide monotone
#: counter plus a per-process random salt, so runs that append to one
#: sink under the same pinned trace id never collide
_SPAN_SEQ = itertools.count(1)
_SPAN_SALT = uuid.uuid4().hex[:8]


class SpanTracer:
    """Thread-local nested span stack bound to an optional JSONL sink
    (anything with ``.log(event, **fields)``) and an optional registry."""

    def __init__(self, sink=None, registry: Optional[Registry] = None):
        self.sink = sink
        self.registry = registry
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    @property
    def depth(self) -> int:
        return len(self._stack())

    def current_path(self) -> str:
        return "/".join(name for name, _ in self._stack())

    # -- trace identity ------------------------------------------------------
    def set_trace_id(self, trace_id: str) -> None:
        """Pin THIS thread's trace id; every span it opens afterwards
        belongs to that trace."""
        self._local.trace_id = str(trace_id)

    def trace_id(self) -> str:
        """This thread's trace id (lazily minted when never pinned)."""
        tid = getattr(self._local, "trace_id", None)
        if tid is None:
            tid = self._local.trace_id = f"t{uuid.uuid4().hex[:8]}"
        return tid

    def current_span_id(self) -> Optional[str]:
        stack = self._stack()
        return stack[-1][1] if stack else None

    def context(self) -> Tuple[str, Optional[str]]:
        """``(trace_id, current_span_id)`` — what a remote call carries so
        the far side's spans can link back here."""
        return self.trace_id(), self.current_span_id()

    @contextlib.contextmanager
    def span(self, name: str, **fields):
        """Time a scope; emits on exit (exceptions included — a crashed
        span still records its duration, flagged ``error=True``).
        ``trace_id``/``parent_span`` keyword fields override the automatic
        thread-local ones."""
        stack = self._stack()
        tid = fields.get("trace_id") or self.trace_id()
        span_id = f"{tid}.{_SPAN_SALT}{next(_SPAN_SEQ)}"
        parent = stack[-1][1] if stack else None
        stack.append((name, span_id))
        path = "/".join(n for n, _ in stack)
        depth = len(stack) - 1
        t0 = time.perf_counter()
        try:
            yield self
        except BaseException:
            self._emit(name, path, depth, time.perf_counter() - t0,
                       span_id, parent, dict(fields, error=True))
            raise
        else:
            self._emit(name, path, depth, time.perf_counter() - t0,
                       span_id, parent, fields)
        finally:
            stack.pop()

    def _emit(self, name: str, path: str, depth: int, seconds: float,
              span_id: str, parent: Optional[str], fields: dict) -> None:
        if self.sink is not None:
            rec = dict(fields)
            # only the trace-adoption keys are caller-overridable; the
            # structural keys below are authoritative
            rec.setdefault("trace_id", self.trace_id())
            if parent is not None:
                rec.setdefault("parent_span", parent)
            rec.update(name=name, path=path, depth=depth, seconds=seconds,
                       span_id=span_id)
            self.sink.log("span", **rec)
        if self.registry is not None:
            self.registry.histogram(f"span.{name}.seconds",
                                    TIME_BUCKETS).observe(seconds)


_DEFAULT = SpanTracer()


def default_tracer() -> SpanTracer:
    return _DEFAULT


def span(name: str, **fields):
    """Ad-hoc span on the process-wide tracer (silent until a sink is
    attached via ``set_default_sink``; nesting/paths always tracked)."""
    return _DEFAULT.span(name, **fields)


def set_default_sink(sink, registry: Optional[Registry] = None) -> None:
    """Point the process-wide tracer at a JSONL sink (and optionally a
    registry)."""
    _DEFAULT.sink = sink
    if registry is not None:
        _DEFAULT.registry = registry
