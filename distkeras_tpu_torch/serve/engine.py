"""Continuous-batching decode engine, plain mode (the port of
``distkeras_tpu.serve.engine.DecodeEngine``; the prefix cache, the KV
fabric and speculative decoding come with later slices).

One decode state for ``slots`` concurrent requests — token buffer
(B, T), KV cache (B rows), per-row position and logits, and an
``active`` mask — lives on the device and is advanced for every active
row per step.  A new request does not wait for the batch to finish: a
**join** prefills its prompt at its length bucket (a single-row
``apply_prefill``: on the card, one flash-attention kernel launch per
attention layer) and writes the row into a free slot while the other
rows keep decoding.  The JAX package blends the row in with a one-hot
mask because its arrays are immutable; here the slot's row is written
in place.

Programs, each behind its own ``RetraceSentinel``
(``jit.compiles``/``jit.retraces`` in the service registry):

* ``serve.join.l<L>`` — per prefill bucket L: the single-row prefill of
  the (1, L) padded prompt + the write into slot ``row``.
* ``serve.step`` — every active row takes its next token from its
  carried logits (argmax when every row is greedy, ``sample_rowwise``
  when any row samples — decided from the host-side per-row
  temperatures, so the branch costs no device sync), writes it at its
  own position and runs one cached decode forward.  Inactive rows are
  masked no-ops.

PyTorch runs eagerly, so a program's "compile" is the first call with a
given argument signature; ``warmup()`` calls every bucket's join and the
step once, and steady-state serving then holds ``jit.retraces == 0``.

**Dispatch-ahead**: the decode loop dispatches step k+1 BEFORE doing step
k's host bookkeeping.  Each dispatch copies its tokens to pinned host
memory without blocking and records a CUDA event; retiring a step waits
on that event only, so the host's readback, detokenize, retire and SLO
work overlaps the next step on the card.  Each dispatch snapshots its
slot->request map, and a token computed for a row that retired (or
re-joined) after the dispatch is discarded by the snapshot check.
``serve.step_seconds`` is a step's dispatch->retire wall: one loop
iteration, including the host work overlapped with it.

Scheduling is host-side and single-threaded: one decode thread owns the
device state and the slot table; ``submit()`` (any thread) only touches
the bounded admission queue.  Metrics, all in the service registry, keep
the JAX package's names: ``serve.queue_wait_seconds``,
``serve.ttft_seconds`` (and its ``_warm``/``_cold`` split),
``serve.per_token_seconds``, ``serve.e2e_seconds``,
``serve.step_seconds``, ``serve.host_seconds``, ``serve.join_seconds``,
counters ``serve.requests`` / ``admitted`` / ``completed`` /
``tokens_out`` / ``steps`` / ``joins`` / ``promotions`` / ``rejected``
(split by reason), gauges ``serve.queue_depth`` / ``serve.active_slots``,
and the accelerator counters ``serve.prefix.*`` / ``serve.spec.*``,
created at zero so a snapshot carries the same names.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..models.generation import _model_cache, _write_at, sample_rowwise
from ..obs import Registry, TIME_BUCKETS
from ..obs.logging import get_logger
from ..obs.profile import RetraceSentinel
from ..utils.device import DeviceLike, default_device
from ..utils.tree import tree_map
from .config import ServeConfig

_LOG = "serve.engine"

#: decode-thread wait quantum while idle (seconds) — submissions notify
#: the condition, so this only bounds shutdown latency
_IDLE_WAIT_S = 0.05


class ServeRejected(Exception):
    """A request the admission controller load-shed (queue full /
    draining / aborted by a hard stop).  ``reason`` names which."""

    def __init__(self, reason: str):
        super().__init__(f"request rejected: {reason}")
        self.reason = reason


class ServeRequest:
    """One in-flight generation: the handle ``submit()`` returns.

    ``wait(timeout)`` blocks until completion; ``result()`` returns the
    GENERATED token ids (eos included when sampled) as int32, raising
    ``ServeRejected`` if the engine aborted the request.  ``temperature``
    / ``top_k`` / ``top_p`` are the request's resolved sampling params
    (``top_k == 0`` and ``top_p == 1.0`` disable those filters)."""

    __slots__ = ("prompt", "length", "max_new", "tokens", "error",
                 "submit_t", "admit_t", "first_token_t", "done_t",
                 "temperature", "top_k", "top_p", "_done")

    def __init__(self, prompt: np.ndarray, max_new: int,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0):
        self.prompt = prompt
        self.length = int(prompt.shape[0])
        self.max_new = int(max_new)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.tokens: list = []
        self.error: Optional[str] = None
        self.submit_t = time.perf_counter()
        self.admit_t: Optional[float] = None
        self.first_token_t: Optional[float] = None
        self.done_t: Optional[float] = None
        self._done = threading.Event()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._done.wait(timeout):
            raise TimeoutError("request not complete")
        if self.error is not None:
            raise ServeRejected(self.error)
        return np.asarray(self.tokens, np.int32)


class _Slot:
    """Decode-thread-private per-row bookkeeping (no locking: one owner)."""

    __slots__ = ("request",)

    def __init__(self):
        self.request: Optional[ServeRequest] = None


class _Pending:
    """One dispatched-but-not-yet-retired step: its tokens (a host
    buffer filled by a non-blocking copy), the event that marks the copy
    done (None on the CPU), and the dispatch-time slot->request
    snapshot."""

    __slots__ = ("reqs", "tokens", "event", "t0")

    def __init__(self, reqs, tokens, event, t0):
        self.reqs = reqs
        self.tokens = tokens
        self.event = event
        self.t0 = t0


class DecodeEngine:
    """The scheduler/batcher.  ``start()`` spawns the decode thread;
    ``submit()`` is thread-safe; ``drain()`` stops admission and waits
    for in-flight work; ``stop()`` is drain + shutdown (hard stop after
    ``drain_timeout_s``, aborted requests recorded as rejections).

    ``device`` (default: the card) must be where ``model`` lives."""

    def __init__(self, model, config: Optional[ServeConfig] = None,
                 registry: Optional[Registry] = None,
                 device: DeviceLike = None):
        device = default_device(device)
        if model.device != device:
            raise ValueError(f"the model lives on {model.device}, not "
                             f"{device}")
        self.model = model
        self.device = device
        self.config = config if config is not None else ServeConfig()
        self.registry = registry if registry is not None else Registry()
        self._t = int(model.input_shape[0])
        self._b = int(self.config.slots)
        self._buckets = self.config.resolved_buckets(self._t)
        if self.config.max_new_tokens >= self._t:
            raise ValueError(
                f"max_new_tokens {self.config.max_new_tokens} must be < "
                f"the model's seq_len {self._t}")
        cache = _model_cache(model, self._b)
        if cache is None:
            raise ValueError(
                "the serve engine needs the KV-cached decode path "
                "(init_cache protocol, no mesh-attached attention, no "
                "time-mixing layer without a decode rule)")
        self._vocab = int(model.output_shape[-1])
        self._init_state(cache)

        self._sentinels: dict = {}
        # pre-created so a snapshot taken before any traffic carries 0
        self.registry.counter("jit.compiles")
        self.registry.counter("jit.retraces")

        reg = self.registry
        self._h_queue_wait = reg.histogram("serve.queue_wait_seconds",
                                           TIME_BUCKETS)
        self._h_ttft = reg.histogram("serve.ttft_seconds", TIME_BUCKETS)
        self._h_ttft_warm = reg.histogram("serve.ttft_warm_seconds",
                                          TIME_BUCKETS)
        self._h_ttft_cold = reg.histogram("serve.ttft_cold_seconds",
                                          TIME_BUCKETS)
        self._h_per_token = reg.histogram("serve.per_token_seconds",
                                          TIME_BUCKETS)
        self._h_e2e = reg.histogram("serve.e2e_seconds", TIME_BUCKETS)
        self._h_step = reg.histogram("serve.step_seconds", TIME_BUCKETS)
        self._h_host = reg.histogram("serve.host_seconds", TIME_BUCKETS)
        self._h_join = reg.histogram("serve.join_seconds", TIME_BUCKETS)
        self._c_requests = reg.counter("serve.requests")
        self._c_admitted = reg.counter("serve.admitted")
        self._c_completed = reg.counter("serve.completed")
        self._c_tokens = reg.counter("serve.tokens_out")
        self._c_steps = reg.counter("serve.steps")
        self._c_joins = reg.counter("serve.joins")
        self._c_promotions = reg.counter("serve.promotions")
        self._c_rejected = reg.counter("serve.rejected")
        self._c_rej_full = reg.counter("serve.rejected_queue_full")
        self._c_rej_drain = reg.counter("serve.rejected_draining")
        self._c_rej_abort = reg.counter("serve.rejected_aborted")
        self._g_queue = reg.gauge("serve.queue_depth")
        self._g_active = reg.gauge("serve.active_slots")
        for name in ("spec.proposed", "spec.accepted", "prefix.hits",
                     "prefix.misses", "prefix.inserts",
                     "prefix.remote_inserts", "prefix.evictions"):
            reg.counter(f"serve.{name}")
        for name in ("spec.accept_rate", "prefix.bytes", "prefix.entries"):
            reg.gauge(f"serve.{name}")

        #: admission queue + flags — the ONLY state shared across threads;
        #: every touch goes through _lock (slot table and device state are
        #: decode-thread-private)
        self._queue: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._draining = False
        self._pending_state = None
        self._stop_evt = threading.Event()
        self._idle_evt = threading.Event()
        self._idle_evt.set()
        self._slots = [_Slot() for _ in range(self._b)]
        self._thread: Optional[threading.Thread] = None

    # -- device state -------------------------------------------------------
    def _init_state(self, cache=None):
        b, t, dev = self._b, self._t, self.device
        self._buf = torch.zeros((b, t), dtype=torch.long, device=dev)
        self._cache = cache if cache is not None \
            else _model_cache(self.model, b)
        self._pos = torch.zeros((b,), dtype=torch.long, device=dev)
        self._logits = torch.zeros((b, self._vocab), dtype=torch.float32,
                                   device=dev)
        #: device mirror of the slot table, written at join and finish
        self._active = torch.zeros((b,), dtype=torch.bool, device=dev)
        self._gen = torch.Generator(device=dev).manual_seed(
            int(self.config.seed))
        # per-row sampling params: host arrays (the step's greedy/sampled
        # branch reads these, no device sync) and their device copies,
        # both written at admit.  0 / 0 / 1.0 = greedy, unfiltered
        self._row_temp = np.zeros((b,), np.float32)
        self._temp = torch.zeros((b,), dtype=torch.float32, device=dev)
        self._topk = torch.zeros((b,), dtype=torch.long, device=dev)
        self._topp = torch.ones((b,), dtype=torch.float32, device=dev)

    # -- programs -----------------------------------------------------------
    def _sentinel(self, name: str) -> RetraceSentinel:
        s = self._sentinels.get(name)
        if s is None:
            s = self._sentinels[name] = RetraceSentinel(
                f"serve.{name}", registry=lambda: self.registry)
        return s

    def _join_args(self, prompt, length, row):
        """The cold join's observed-arg tuple — one function shared by
        warmup and _admit, so their signatures cannot drift apart."""
        return (self._buf, self._cache, self._pos, self._logits, prompt,
                int(length), int(row))

    def _join(self, prompt, length: int, row: int) -> None:
        """Single-row prefill of ``prompt`` (1, L) (L = the bucket) and the
        write of its row — tokens, L-long K/V then zeros, position,
        last-token logits — into slot ``row``."""
        cap = int(prompt.shape[1])
        layer = self.model.layer
        y, cache1 = layer.apply_prefill(prompt, layer.init_cache(1, (cap,)))

        def write_row(c, c1):
            c[row, :cap] = c1[0].to(c.dtype)
            c[row, cap:] = 0

        tree_map(write_row, self._cache, cache1)
        self._buf[row] = 0
        self._buf[row, :cap] = prompt[0]
        self._pos[row] = length
        self._logits[row] = y[0, length - 1].to(self._logits.dtype)

    def _step_args(self):
        return (self._buf, self._cache, self._pos, self._logits,
                self._active, self._temp, self._topk, self._topp)

    def _step(self):
        """One decode step for every active row; returns the (B,) tokens."""
        if (self._row_temp > 0.0).any():
            nxt = sample_rowwise(self._gen, self._logits, self._temp,
                                 self._topk, self._topp)
        else:
            nxt = torch.argmax(self._logits, dim=-1)
        t = self._t
        _write_at(self._buf, nxt, self._pos, t, keep=self._active)
        # clamp retired rows' positions into range: their decode output is
        # discarded, but the cache write must stay in bounds
        logits2, self._cache = self.model.layer.apply_decode(
            nxt, self._cache, self._pos.clamp(max=t - 1))
        self._logits = torch.where(self._active[:, None],
                                   logits2.to(self._logits.dtype),
                                   self._logits)
        self._pos += self._active.to(self._pos.dtype)
        return nxt

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "DecodeEngine":
        if self._thread is not None:
            raise RuntimeError("engine already started")
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serve-decode")
        self._thread.start()
        return self

    def _prompt_tensor(self, prompt: np.ndarray) -> torch.Tensor:
        """Host prompt → device, without blocking the host on the card."""
        x = torch.from_numpy(prompt)
        if self.device.type == "cuda":
            return x.pin_memory().to(self.device, non_blocking=True)
        return x.to(self.device)

    @torch.no_grad()
    def warmup(self) -> "DecodeEngine":
        """Run every bucket's join and the step once against throwaway
        state (recording each program's signature), then reset the decode
        state: afterwards any new signature is a real bucketing bug
        (``jit.retraces`` stays 0).  Call before ``start()``."""
        for bucket in self._buckets:
            prompt = self._prompt_tensor(np.zeros((1, bucket), np.int64))
            self._sentinel(f"join.l{bucket}").observe(
                self._join_args(prompt, 1, 0))
            self._join(prompt, 1, 0)
        self._sentinel("step").observe(self._step_args())
        self._step()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._init_state()
        return self

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        """Shut the engine down.  ``drain=True`` (default) completes
        queued + in-flight requests first (bounded by ``timeout`` /
        ``drain_timeout_s``); anything still outstanding afterwards —
        or everything, with ``drain=False`` — is aborted with a recorded
        rejection."""
        if drain:
            self.drain(timeout=timeout)
        else:
            with self._lock:
                self._draining = True
        self._stop_evt.set()
        with self._lock:
            self._work.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10)
        self._abort_outstanding("aborted: engine stopped")

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop admitting, wait for queue + slots to empty.  Returns True
        when fully drained within the timeout."""
        with self._lock:
            self._draining = True
            self._work.notify_all()
        timeout = self.config.drain_timeout_s if timeout is None \
            else float(timeout)
        return self._idle_evt.wait(timeout)

    def undrain(self) -> bool:
        """Re-open admission on a drained-but-running engine.  Raises
        ``RuntimeError`` on a stopped engine."""
        if self._stop_evt.is_set() or (
                self._thread is not None and not self._thread.is_alive()):
            raise RuntimeError("cannot undrain a stopped engine")
        with self._lock:
            was = self._draining
            self._draining = False
            self._work.notify_all()
        if was:
            get_logger(_LOG).info("engine un-drained: admission reopened")
        return was

    def _abort_outstanding(self, reason: str) -> None:
        """Fail every request still queued or in a slot: each is recorded
        under ``serve.rejected``.  The slot table is touched only when the
        decode thread is THIS thread or provably dead."""
        with self._lock:
            stranded = list(self._queue)
            self._queue.clear()
            self._g_queue.set(0)
        own_slots = self._thread is None \
            or self._thread is threading.current_thread() \
            or not self._thread.is_alive()
        if own_slots:
            for slot in self._slots:
                if slot.request is not None:
                    stranded.append(slot.request)
                    slot.request = None
        else:
            get_logger(_LOG).warning(
                "decode thread still running after stop timeout; leaving "
                "in-slot requests to it (queued requests aborted)")
        for req in stranded:
            self._c_rejected.inc()
            self._c_rej_abort.inc()
            req.error = reason
            req.done_t = time.perf_counter()
            req._done.set()
        if stranded:
            get_logger(_LOG).warning(
                "engine stop aborted %d outstanding request(s) "
                "(recorded under serve.rejected)", len(stranded))

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- checkpoint promotion -----------------------------------------------
    def promote(self, state_dict) -> None:
        """Swap the serving weights: ``state_dict`` (name -> tensor or
        array, the model's ``state_dict()`` keys) is validated HERE, on
        the caller's thread, and adopted by the decode thread at its next
        loop turn; in-flight requests continue under the new weights.  A
        key, shape or dtype mismatch raises ``ValueError``."""
        cur = self.model.state_dict()
        if set(state_dict) != set(cur):
            raise ValueError("promoted state dict keys do not match the "
                             "serving model's")
        new = {k: torch.as_tensor(v) for k, v in state_dict.items()}
        bad = [f"{k}: {tuple(new[k].shape)}/{new[k].dtype} != "
               f"{tuple(c.shape)}/{c.dtype}" for k, c in cur.items()
               if new[k].shape != c.shape or new[k].dtype != c.dtype]
        if bad:
            raise ValueError(f"promoted weights do not match the serving "
                             f"model (shape/dtype: {'; '.join(bad[:3])}"
                             f"{' ...' if len(bad) > 3 else ''})")
        new = {k: v.to(self.device) for k, v in new.items()}
        with self._lock:
            self._pending_state = new
            self._work.notify_all()
        self._c_promotions.inc()

    def _adopt_promotion(self) -> None:
        with self._lock:
            new = self._pending_state
            self._pending_state = None
        if new is not None:
            self.model.load_state_dict(new)

    # -- admission ----------------------------------------------------------
    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None,
               top_p: Optional[float] = None) -> ServeRequest:
        """Queue one generation request.  Raises ``ValueError`` for
        malformed requests and ``ServeRejected`` when the admission
        controller load-sheds (queue full / draining).  ``temperature`` /
        ``top_k`` / ``top_p`` override the engine defaults per request."""
        self._c_requests.inc()
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if prompt.shape[0] < 1:
            raise ValueError("prompt must hold at least one token")
        max_new = self.config.max_new_tokens if max_new_tokens is None \
            else int(max_new_tokens)
        if not 1 <= max_new <= self.config.max_new_tokens:
            raise ValueError(
                f"max_new_tokens must lie in [1, "
                f"{self.config.max_new_tokens}], got {max_new}")
        temperature = float(self.config.temperature) \
            if temperature is None else float(temperature)
        if not temperature >= 0.0:  # not-form: NaN must fail too
            raise ValueError(
                f"temperature must be >= 0, got {temperature}")
        top_k = self.config.top_k if top_k is None else top_k
        top_k = 0 if top_k is None else int(top_k)   # 0 = disabled
        if top_k < 0:
            raise ValueError(
                f"top_k must be >= 0 (0/None disable it), got {top_k}")
        top_p = self.config.top_p if top_p is None else top_p
        top_p = 1.0 if top_p is None else float(top_p)  # 1.0 = disabled
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        # validates the prompt fits a bucket too
        self.config.bucket_for(int(prompt.shape[0]), self._t)
        if int(prompt.shape[0]) + max_new > self._t:
            raise ValueError(
                f"prompt length {prompt.shape[0]} + {max_new} new tokens "
                f"exceeds the model's seq_len {self._t}")
        req = ServeRequest(prompt, max_new, temperature=temperature,
                           top_k=top_k, top_p=top_p)
        with self._lock:
            if self._draining:
                self._c_rejected.inc()
                self._c_rej_drain.inc()
                raise ServeRejected("draining")
            if len(self._queue) >= self.config.max_queue:
                self._c_rejected.inc()
                self._c_rej_full.inc()
                raise ServeRejected("queue full")
            self._queue.append(req)
            self._g_queue.set(len(self._queue))
            self._idle_evt.clear()
            self._work.notify_all()
        return req

    # -- decode loop --------------------------------------------------------
    def _free_slot(self) -> Optional[int]:
        for i, slot in enumerate(self._slots):
            if slot.request is None:
                return i
        return None

    def _active_count(self) -> int:
        return sum(1 for s in self._slots if s.request is not None)

    def _join_cold(self, req: ServeRequest, row: int) -> None:
        bucket = self.config.bucket_for(req.length, self._t)
        host = np.zeros((1, bucket), np.int64)
        host[0, :req.length] = req.prompt
        prompt = self._prompt_tensor(host)
        self._sentinel(f"join.l{bucket}").observe(
            self._join_args(prompt, req.length, row))
        self._join(prompt, req.length, row)

    def _admit(self) -> int:
        """Move queued requests into free slots (prefill + row write).
        Decode-thread only; the queue pop is the one locked touch."""
        admitted = 0
        while True:
            row = self._free_slot()
            if row is None:
                return admitted
            with self._lock:
                if not self._queue:
                    return admitted
                req = self._queue.popleft()
                self._g_queue.set(len(self._queue))
            req.admit_t = time.perf_counter()
            self._h_queue_wait.observe(req.admit_t - req.submit_t)
            t0 = time.perf_counter()
            self._join_cold(req, row)
            self._h_join.observe(time.perf_counter() - t0)
            # the row adopts the request's sampling params
            self._row_temp[row] = req.temperature
            self._temp[row] = req.temperature
            self._topk[row] = req.top_k
            self._topp[row] = req.top_p
            self._active[row] = True
            self._slots[row].request = req
            self._c_admitted.inc()
            self._c_joins.inc()
            admitted += 1
            self._g_active.set(self._active_count())

    def _finish(self, row: int, now: float) -> None:
        slot = self._slots[row]
        req = slot.request
        slot.request = None
        self._active[row] = False
        req.done_t = now
        self._c_completed.inc()
        self._h_e2e.observe(now - req.submit_t)
        req._done.set()

    def _dispatch_step(self) -> _Pending:
        """Dispatch ONE step and return the pending handle — the tokens
        are copied to host memory without blocking; ``_retire_step``
        waits for them, overlapped with the NEXT dispatched step."""
        reqs = [s.request for s in self._slots]
        t0 = time.perf_counter()
        self._sentinel("step").observe(self._step_args())
        nxt = self._step()
        if self.device.type == "cuda":
            host = torch.empty(nxt.shape, dtype=nxt.dtype, pin_memory=True)
            host.copy_(nxt, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        else:
            host, event = nxt.clone(), None
        return _Pending(reqs, host, event, t0)

    def _drain_certain(self, pending: Optional[_Pending]) -> bool:
        """True when the un-retired ``pending`` step is guaranteed to
        retire EVERY currently-active row, so dispatching another step
        now would be pure waste."""
        if pending is None:
            return False
        for row, slot in enumerate(self._slots):
            req = slot.request
            if req is None:
                continue
            if pending.reqs[row] is not req or \
                    len(req.tokens) + 1 < req.max_new:
                return False
        return True

    def _retire_step(self, pending: _Pending) -> None:
        """Host bookkeeping for a dispatched step: wait for its tokens,
        attribute them via the dispatch-time snapshot, stamp SLOs, retire
        finished rows."""
        if pending.event is not None:
            pending.event.synchronize()
        tokens = pending.tokens.numpy()
        now = time.perf_counter()
        dt = now - pending.t0
        self._h_step.observe(dt)
        self._c_steps.inc()
        eos = self.config.eos_id
        for row, req in enumerate(pending.reqs):
            if req is None or req.done:
                continue
            tok = int(tokens[row])
            req.tokens.append(tok)
            self._c_tokens.inc()
            self._h_per_token.observe(dt)
            if req.first_token_t is None:
                req.first_token_t = now
                self._h_ttft.observe(now - req.submit_t)
            if len(req.tokens) >= req.max_new or \
                    (eos is not None and tok == int(eos)):
                self._finish(row, now)
        self._g_active.set(self._active_count())
        self._h_host.observe(time.perf_counter() - now)

    def _loop(self) -> None:
        pending: Optional[_Pending] = None
        try:
            with torch.no_grad():
                while True:
                    # a hard stop exits immediately; the graceful path
                    # only sets the stop event once drained
                    if self._stop_evt.is_set():
                        self._abort_outstanding("aborted: engine stopped")
                        return
                    self._adopt_promotion()
                    self._admit()
                    # dispatch-ahead: step k+1 goes out BEFORE step k's
                    # host bookkeeping, unless step k is certain to drain
                    # the whole batch
                    nxt = self._dispatch_step() \
                        if self._active_count() and \
                        not self._drain_certain(pending) else None
                    if pending is not None:
                        self._retire_step(pending)
                    pending = nxt
                    if pending is not None:
                        continue
                    with self._lock:
                        if self._queue:
                            continue
                        self._idle_evt.set()
                        self._work.wait(_IDLE_WAIT_S)
        except Exception:
            # a dead decode thread must not strand waiters on requests
            # that will never complete: fail them loudly as rejections
            get_logger(_LOG).exception("decode loop crashed; aborting "
                                       "outstanding requests")
            with self._lock:
                self._draining = True
            self._idle_evt.set()
            self._abort_outstanding("aborted: decode loop crashed")
