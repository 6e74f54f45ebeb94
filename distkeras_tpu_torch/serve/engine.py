"""Continuous-batching decode engine (the port of
``distkeras_tpu.serve.engine.DecodeEngine``, with its prefix KV cache,
speculative decoding, dispatch-ahead and KV-fabric seam).

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
  the (1, L) padded prompt + the write into slot ``row``.  With the
  prefix cache on, the join also RETURNS the single-row full-length KV
  it just computed, so the host caches it for later prompts sharing the
  prefix.  With speculative decode on, the draft prefills its own cache
  for the row too.
* ``serve.sjoin.s<S>`` — per suffix bucket S (prefix cache on): admit a
  prompt whose longest prefix is already cached by replaying only its
  suffix over a copy of the cached KV with ``decode_window`` (the JAX
  package's algorithm: one cached decode per suffix token, no prefill
  kernel) + the same row write.  The JAX program replays the suffix
  padded to S because its shapes are static; here only the real suffix
  tokens run — the padded positions are never attended, so every kept
  logit is the same.
* ``serve.step`` — every active row takes its next token from its
  carried logits (argmax when every row is greedy, ``sample_rowwise``
  when any row samples — decided from the host-side per-row
  temperatures, so the branch costs no device sync), writes it at its
  own position and runs one cached decode forward.  Inactive rows are
  masked no-ops.
* ``serve.spec_step`` (``spec_k > 0``, replaces ``serve.step``) — the
  draft proposes k tokens per row, the target verifies all k in one
  window, up to k+1 tokens emitted per dispatch (``serve/spec.py``;
  greedy output equals ``generate_tokens``).

PyTorch runs eagerly, so a program's "compile" is the first call with a
given argument signature; ``warmup()`` calls every bucket's join (and,
with the prefix cache, every suffix bucket's warm join) and the step
once, and steady-state serving then holds ``jit.retraces == 0``.

**Dispatch-ahead**: the decode loop dispatches step k+1 BEFORE doing step
k's host bookkeeping.  Each dispatch copies its tokens (and, in spec
mode, the per-row emitted counts, in the same copy) to pinned host
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
``serve.ttft_seconds`` (split ``serve.ttft_warm_seconds`` /
``serve.ttft_cold_seconds`` by prefix-cache outcome),
``serve.per_token_seconds``, ``serve.e2e_seconds``,
``serve.step_seconds``, ``serve.host_seconds``, ``serve.join_seconds``,
counters ``serve.requests`` / ``admitted`` / ``completed`` /
``tokens_out`` / ``steps`` / ``joins`` / ``promotions`` / ``rejected``
(split by reason), gauges ``serve.queue_depth`` / ``serve.active_slots``,
and the accelerator counters ``serve.prefix.*`` / ``serve.spec.*``,
created at zero so a snapshot always carries the same names.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..models.generation import (_model_cache, _write_at, decode_window,
                                 sample_rowwise)
from ..obs import Registry, TIME_BUCKETS
from ..obs.logging import get_logger
from ..obs.profile import RetraceSentinel
from ..utils.device import DeviceLike, default_device
from ..utils.tree import tree_flatten, tree_map
from .config import ServeConfig
from .prefix import PrefixCache, PrefixEntry
from .spec import build_spec_step, validate_draft

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
    ``ServeRejected`` if the engine aborted the request.  ``warm``
    records the prefix-cache outcome at admission (None when the cache is
    disabled).  ``temperature`` / ``top_k`` / ``top_p`` are the request's
    resolved sampling params (``top_k == 0`` and ``top_p == 1.0`` disable
    those filters)."""

    __slots__ = ("prompt", "length", "max_new", "tokens", "error",
                 "submit_t", "admit_t", "first_token_t", "done_t",
                 "warm", "temperature", "top_k", "top_p", "_done")

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
        self.warm: Optional[bool] = None
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
    buffer filled by a non-blocking copy: (B,) in plain mode, (B, k+2) in
    spec mode — the k+1 emitted tokens, then the row's count), the event
    that marks the copy done (None on the CPU), and the dispatch-time
    slot->request snapshot."""

    __slots__ = ("reqs", "tokens", "event", "t0")

    def __init__(self, reqs, tokens, event, t0):
        self.reqs = reqs
        self.tokens = tokens
        self.event = event
        self.t0 = t0


def _dtype_name(x) -> str:
    return str(x.dtype).removeprefix("torch.")


class DecodeEngine:
    """The scheduler/batcher.  ``start()`` spawns the decode thread;
    ``submit()`` is thread-safe; ``drain()`` stops admission and waits
    for in-flight work; ``stop()`` is drain + shutdown (hard stop after
    ``drain_timeout_s``, aborted requests recorded as rejections).

    ``device`` (default: the card) must be where ``model`` lives.
    ``draft_model`` (required iff ``config.spec_k > 0``, on the same
    device): the small proposal model for speculative decoding —
    validated here, at construction, never discovered by the decode
    thread."""

    def __init__(self, model, config: Optional[ServeConfig] = None,
                 registry: Optional[Registry] = None,
                 device: DeviceLike = None, draft_model=None):
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

        # -- speculative decode: draft model, validated now --
        self._spec_k = int(self.config.spec_k)
        self.draft_model = draft_model
        if self._spec_k > 0:
            validate_draft(model, draft_model, self._b, self._spec_k)
        elif draft_model is not None:
            raise ValueError(
                "draft_model passed but spec_k == 0 — speculative decode "
                "would silently never run; set ServeConfig(spec_k=K) or "
                "drop the draft")
        self._init_state(cache)

        self._step_fn = None
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
        # accelerator metrics are ALWAYS pre-created — a disabled
        # engine's snapshot carries explicit zeros, not missing metrics
        self._c_spec_proposed = reg.counter("serve.spec.proposed")
        self._c_spec_accepted = reg.counter("serve.spec.accepted")
        self._g_accept_rate = reg.gauge("serve.spec.accept_rate")
        for name in ("hits", "misses", "inserts", "remote_inserts",
                     "evictions"):
            reg.counter(f"serve.prefix.{name}")
        reg.gauge("serve.prefix.bytes")
        reg.gauge("serve.prefix.entries")
        self._prefix = None
        if self.config.prefix_cache:
            self._prefix = PrefixCache(
                int(float(self.config.prefix_cache_mb) * 1024 * 1024),
                reg, block=int(self.config.prefix_block))
        #: KV checkpoint version: bumped by the DECODE thread at
        #: promotion adoption — the moment the weights that compute new
        #: cache entries actually change — so a fabric export/import
        #: double-reading it around a cache touch can prove which weight
        #: generation an entry belongs to (``kv_export``,
        #: ``serve.kvfabric.admit_remote_entry``)
        self._kv_version = 0

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
        if self._spec_k > 0:
            self._dcache = _model_cache(self.draft_model, b)
            self._dlogits = torch.zeros((b, self._vocab),
                                        dtype=torch.float32, device=dev)
        else:
            self._dcache = None
            self._dlogits = None

    def _single_row_cache(self, batch_cache):
        """A zeroed single-row, full-length cache tree shaped like one
        row of ``batch_cache`` — the warmup stand-in for a prefix-cache
        entry, and the template a peer's exported entry is checked
        against."""
        return tree_map(lambda c: torch.zeros((1,) + tuple(c.shape[1:]),
                                              dtype=c.dtype,
                                              device=c.device),
                        batch_cache)

    # -- programs -----------------------------------------------------------
    def _sentinel(self, name: str) -> RetraceSentinel:
        s = self._sentinels.get(name)
        if s is None:
            s = self._sentinels[name] = RetraceSentinel(
                f"serve.{name}", registry=lambda: self.registry)
        return s

    def _write_row(self, batch_tree, row_tree, row: int) -> None:
        """Write single-row, full-length ``row_tree`` into slot ``row`` of
        ``batch_tree`` (the join's scatter, in place)."""
        def write(c, c1):
            c[row] = c1[0].to(c.dtype)
        tree_map(write, batch_tree, row_tree)

    def _prefill_row(self, layer, batch_cache, prompt, length):
        """Single-row bucket prefill of ``prompt`` (1, L) -> (last logits
        (1, V), its full-length single-row cache tree)."""
        cap = int(prompt.shape[1])
        y, cache1 = layer.apply_prefill(prompt, layer.init_cache(1, (cap,)))

        def pad_full(c1, c):
            full = torch.zeros((1,) + tuple(c.shape[1:]), dtype=c.dtype,
                               device=c.device)
            full[:, :cap] = c1.to(c.dtype)
            return full

        return y[:, length - 1], tree_map(pad_full, cache1, batch_cache)

    def _join_args(self, prompt, length, row):
        """The cold join's observed-arg tuple — one function shared by
        warmup and _admit, so their signatures cannot drift apart."""
        return (self._buf, self._cache, self._pos, self._logits,
                self._dcache, self._dlogits, prompt, int(length), int(row))

    def _join(self, prompt, length: int, row: int):
        """Single-row prefill of ``prompt`` (1, L) (L = the bucket) and the
        write of its row — tokens, L-long K/V then zeros, position,
        last-token logits — into slot ``row``; the draft's row too with
        spec on.  With the prefix cache on, returns the captured entry
        arrays (token row, cache, draft cache), else None."""
        logits0, c1 = self._prefill_row(self.model.layer, self._cache,
                                        prompt, length)
        self._write_row(self._cache, c1, row)
        prow = torch.zeros((1, self._t), dtype=torch.int32,
                           device=self.device)
        prow[0, :prompt.shape[1]] = prompt[0]
        self._buf[row] = prow[0]
        self._pos[row] = length
        self._logits[row] = logits0[0].to(self._logits.dtype)
        dc1 = None
        if self._spec_k > 0:
            dlogits0, dc1 = self._prefill_row(self.draft_model.layer,
                                              self._dcache, prompt, length)
            self._write_row(self._dcache, dc1, row)
            self._dlogits[row] = dlogits0[0].to(self._dlogits.dtype)
        if self._prefix is None:
            return None
        return prow, c1, dc1

    def _sjoin_args(self, entry_tokens, entry_cache, entry_dcache, plen,
                    suffix, slen, row):
        return (self._buf, self._cache, self._pos, self._logits,
                self._dcache, self._dlogits, entry_tokens, entry_cache,
                entry_dcache, int(plen), suffix, int(slen), int(row))

    def _sjoin(self, entry_tokens, entry_cache, entry_dcache, plen: int,
               suffix, slen: int, row: int):
        """The warm join: replay the suffix (``suffix[:, :slen]``) over a
        copy of the cached single-row prefix KV with ``decode_window``,
        then the same row write the cold join does.  Returns the
        advanced entry arrays (token row, cache, draft cache) for the
        host to cache under the full prompt."""
        t = self._t
        tokens = suffix[:, :slen]

        def replay(layer, pcache):
            # a copy: decode_window writes in place, and the entry stays
            # the cache's until it is evicted
            pcache = tree_map(torch.clone, pcache)
            win, pcache = decode_window(layer, tokens, pcache, plen,
                                        limit=t)
            return win[:, slen - 1], pcache

        logits0, pc = replay(self.model.layer, entry_cache)
        prow = entry_tokens.clone()
        prow[0, plen:plen + slen] = tokens[0].to(prow.dtype)
        self._write_row(self._cache, pc, row)
        self._buf[row] = prow[0]
        self._pos[row] = plen + slen
        self._logits[row] = logits0[0].to(self._logits.dtype)
        pdc = None
        if self._spec_k > 0:
            dlogits0, pdc = replay(self.draft_model.layer, entry_dcache)
            self._write_row(self._dcache, pdc, row)
            self._dlogits[row] = dlogits0[0].to(self._dlogits.dtype)
        return prow, pc, pdc

    def _step_args(self):
        args = (self._buf, self._cache, self._pos, self._logits,
                self._active, self._temp, self._topk, self._topp)
        if self._spec_k > 0:
            args += (self._dcache, self._dlogits)
        return args

    def _step(self):  # dklint: hot
        """One decode step for every active row; returns the (B,) tokens
        (plain) or the (B, k+2) emitted tokens and counts (spec)."""
        # the host mirror of the rows' temperatures (numpy): no sync
        sampled = bool((self._row_temp > 0.0).any())  # dklint: disable=hot-path-purity
        if self._spec_k > 0:
            if self._step_fn is None:
                self._step_fn = build_spec_step(self.model,
                                                self.draft_model,
                                                self._spec_k)
            (self._cache, self._dcache, self._pos, self._logits,
             self._dlogits, emitted, counts) = self._step_fn(
                self._buf, self._cache, self._dcache, self._pos,
                self._logits, self._dlogits, self._active, self._temp,
                self._topk, self._topp, self._gen, sampled)
            return torch.cat([emitted, counts[:, None]], dim=1)
        if sampled:
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

    @property
    def _step_name(self) -> str:
        return "spec_step" if self._spec_k > 0 else "step"

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "DecodeEngine":
        if self._thread is not None:
            raise RuntimeError("engine already started")
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serve-decode")
        self._thread.start()
        return self

    def _host_tensor(self, host: np.ndarray) -> torch.Tensor:
        """Host array → device, without blocking the host on the card."""
        x = torch.from_numpy(host)
        if self.device.type == "cuda":
            return x.pin_memory().to(self.device, non_blocking=True)
        return x.to(self.device)

    @torch.no_grad()
    def warmup(self) -> "DecodeEngine":
        """Run every bucket's join, every suffix bucket's warm join when
        the prefix cache is on, and the (spec) step once against
        throwaway state (recording each program's signature), then reset
        the decode state: afterwards any new signature is a real
        bucketing bug (``jit.retraces`` stays 0).  Call before
        ``start()``."""
        for bucket in self._buckets:
            prompt = self._host_tensor(np.zeros((1, bucket), np.int64))
            self._sentinel(f"join.l{bucket}").observe(
                self._join_args(prompt, 1, 0))
            self._join(prompt, 1, 0)
        if self._prefix is not None:
            etoks = torch.zeros((1, self._t), dtype=torch.int32,
                                device=self.device)
            ecache = self._single_row_cache(self._cache)
            edcache = self._single_row_cache(self._dcache) \
                if self._spec_k > 0 else None
            for bucket in self._buckets:
                suffix = self._host_tensor(np.zeros((1, bucket), np.int64))
                args = self._sjoin_args(etoks, ecache, edcache, 1, suffix,
                                        1, 0)
                self._sentinel(f"sjoin.s{bucket}").observe(args)
                self._sjoin(etoks, ecache, edcache, 1, suffix, 1, 0)
        self._sentinel(self._step_name).observe(self._step_args())
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
        when fully drained within the timeout.  A stopped engine has
        nothing left to drain (its stop aborted what was outstanding):
        it returns at once, so a server stopped twice does not wait out
        ``drain_timeout_s``."""
        if self._stop_evt.is_set():
            return True
        with self._lock:
            self._draining = True
            self._work.notify_all()
        timeout = self.config.drain_timeout_s if timeout is None \
            else float(timeout)
        return self._idle_evt.wait(timeout)

    def undrain(self) -> bool:
        """Re-open admission on a drained-but-running engine (the
        scale-up primitive: its decode thread, programs and KV cache stay
        parked).  Raises ``RuntimeError`` on a stopped engine."""
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
        key, shape or dtype mismatch raises ``ValueError``.

        **The prefix cache is flushed**: cached KV is a pure function of
        (tokens, weights).  Flushed here AND again when the decode thread
        adopts the weights — an admit racing between the two could insert
        one more old-weight entry, and the adoption-time flush drops
        it."""
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
        # flush BEFORE publishing: were the order reversed, the decode
        # thread could adopt + flush + insert a valid NEW-weight entry in
        # the window before this thread's flush, which would then drop it
        if self._prefix is not None:
            self._prefix.flush()
        with self._lock:
            self._pending_state = new
            self._work.notify_all()
        self._c_promotions.inc()

    def _adopt_promotion(self) -> None:
        with self._lock:
            new = self._pending_state
            self._pending_state = None
        if new is not None:
            if self._prefix is not None:
                # any entry a concurrent admit inserted under the OLD
                # weights after the caller-side flush dies here
                self._prefix.flush()
            # flush -> bump -> swap, all on the decode thread (the only
            # inserter), is what makes the KV version stamp exact: an
            # entry visible while _kv_version reads v was computed under
            # generation v's weights
            self._kv_version += 1
            self.model.load_state_dict(new)

    # -- KV fabric seam: cached prefix KV as a fleet resource ---------------
    @property
    def kv_version(self) -> int:
        """The serving checkpoint generation KV transfers are stamped
        with — bumped at promotion ADOPTION (see ``_adopt_promotion``)."""
        return int(self._kv_version)

    def _entry_doc(self, entry: PrefixEntry) -> dict:
        """One cache entry as a host-side wire document: ``host_tokens``
        int32, ``cache`` (and ``draft_cache``) trees of (1, T, KV, Dh)
        arrays — the JAX package's document."""
        def host(x):
            return x.detach().cpu().numpy()
        doc = {"host_tokens": np.asarray(entry.host_tokens, np.int32),
               "cache": tree_map(host, entry.cache)}
        if entry.draft_cache is not None:
            doc["draft_cache"] = tree_map(host, entry.draft_cache)
        return doc

    def kv_export(self, prompt) -> Optional[dict]:
        """The longest cached prefix entry for ``prompt`` as a wire doc
        ``{"entries": [...], "version": v}`` — what the ``kv_fetch`` RPC
        answers a replication-on-spill request with.  Returns ``None``
        when the cache is off/cold for this prompt, or when a promotion
        raced the export: the version is read before AND after the cache
        probe, and a mismatch means the entry's weight generation is
        ambiguous."""
        if self._prefix is None:
            return None
        v0 = self._kv_version
        hit = self._prefix.peek(np.asarray(prompt, np.int32).reshape(-1))
        if hit is None:
            return None
        entry, _ = hit
        doc = {"entries": [self._entry_doc(entry)], "version": int(v0)}
        if self._kv_version != v0:
            return None
        return doc

    def kv_export_hottest(self, max_entries: int,
                          budget_bytes: int) -> Optional[dict]:
        """The MRU-side working set as a wire doc — what a draining
        engine answers a migration ``kv_fetch`` with (hottest first,
        entry- and byte-bounded by the CALLER's budget).  Same
        double-read promotion refusal as :meth:`kv_export`."""
        if self._prefix is None:
            return None
        v0 = self._kv_version
        entries = self._prefix.hottest(max_entries, budget_bytes)
        if not entries:
            return None
        doc = {"entries": [self._entry_doc(e) for e in entries],
               "version": int(v0)}
        if self._kv_version != v0:
            return None
        return doc

    def kv_import(self, doc: dict, version: int) -> Tuple[bool, str]:
        """Admit ONE peer-exported cache entry (an ``_entry_doc``, from
        either package) stamped with checkpoint ``version``; returns
        ``(joined, reason)``.  The tree's leaves, in
        ``jax.tree_util``'s order, are checked against this engine's own
        single-row cache template HERE, so the decode thread never trips
        over a foreign-model tree.  The stale-version refusal itself
        (checked before and after the insert) lives in the
        ``serve.kvfabric`` seam, the only ``insert_remote`` caller."""
        from .kvfabric import admit_remote_entry

        if self._prefix is None:
            return False, "prefix cache disabled"
        # copy out of the receive arena: a retained view would pin the
        # pooled receive buffer for the lifetime of the cache entry
        host_tokens = np.array(doc.get("host_tokens"),
                               np.int32).reshape(-1)
        length = int(host_tokens.shape[0])
        if not 1 <= length <= self._t:
            return False, f"entry length {length} outside [1, {self._t}]"

        def device_tree(got, template, what):
            tleaves, unflatten = tree_flatten(template)
            leaves = [np.asarray(leaf) for leaf in tree_flatten(got)[0]]
            if len(leaves) != len(tleaves):
                raise ValueError(f"{what}: {len(leaves)} leaves != "
                                 f"{len(tleaves)} expected")
            bad = [f"{g.shape}/{g.dtype} != {tuple(t.shape)}/"
                   f"{_dtype_name(t)}" for g, t in zip(leaves, tleaves)
                   if g.shape != tuple(t.shape)
                   or g.dtype.name != _dtype_name(t)]
            if bad:
                raise ValueError(f"{what} leaf mismatch: "
                                 f"{'; '.join(bad[:3])}"
                                 f"{' ...' if len(bad) > 3 else ''}")
            return unflatten([torch.from_numpy(np.array(leaf)).to(
                self.device) for leaf in leaves])

        try:
            cache = device_tree(doc.get("cache"),
                                self._single_row_cache(self._cache),
                                "cache")
            if self._spec_k > 0:
                if doc.get("draft_cache") is None:
                    return False, "draft cache missing (spec_k > 0)"
                draft_cache = device_tree(
                    doc.get("draft_cache"),
                    self._single_row_cache(self._dcache), "draft cache")
            else:
                draft_cache = None
        except (ValueError, TypeError) as e:
            return False, str(e)
        tokens = np.zeros((1, self._t), np.int32)
        tokens[0, :length] = host_tokens
        entry = PrefixEntry(host_tokens,
                            torch.from_numpy(tokens).to(self.device),
                            cache, draft_cache)
        return admit_remote_entry(self, entry, int(version))

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

    def _join_cold(self, req: ServeRequest, row: int):
        bucket = self.config.bucket_for(req.length, self._t)
        host = np.zeros((1, bucket), np.int64)
        host[0, :req.length] = req.prompt
        prompt = self._host_tensor(host)
        self._sentinel(f"join.l{bucket}").observe(
            self._join_args(prompt, req.length, row))
        return self._join(prompt, req.length, row)

    def _join_warm(self, req: ServeRequest, row: int,
                   entry: PrefixEntry, plen: int):
        s = req.length - plen
        bucket = self.config.bucket_for(s, self._t)
        host = np.zeros((1, bucket), np.int64)
        host[0, :s] = req.prompt[plen:]
        suffix = self._host_tensor(host)
        args = self._sjoin_args(entry.tokens, entry.cache,
                                entry.draft_cache, plen, suffix, s, row)
        self._sentinel(f"sjoin.s{bucket}").observe(args)
        return self._sjoin(entry.tokens, entry.cache, entry.draft_cache,
                           plen, suffix, s, row)

    def _admit(self) -> int:
        """Move queued requests into free slots (prefill + row write — or,
        on a prefix-cache hit, a suffix replay over the cached KV).
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
            if self._prefix is not None:
                hit = self._prefix.lookup(req.prompt)
                if hit is not None:
                    req.warm = True
                    captured = self._join_warm(req, row, *hit)
                else:
                    req.warm = False
                    captured = self._join_cold(req, row)
                self._prefix.insert(PrefixEntry(req.prompt, *captured))
            else:
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
        self._sentinel(self._step_name).observe(self._step_args())
        out = self._step()
        if self.device.type == "cuda":
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        else:
            host, event = out.clone(), None
        return _Pending(reqs, host, event, t0)

    def _drain_certain(self, pending: Optional[_Pending]) -> bool:
        """True when the un-retired ``pending`` step is guaranteed to
        retire EVERY currently-active row (each needs at most the one
        token every step emits), so dispatching another step now would
        be pure waste."""
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
        k = self._spec_k
        for row, req in enumerate(pending.reqs):
            if req is None or req.done:
                continue
            if k == 0:
                emitted = [int(tokens[row])]
            else:
                count = int(tokens[row, -1])
                emitted = [int(v) for v in tokens[row, :count]]
                self._c_spec_proposed.inc(k)
                self._c_spec_accepted.inc(count - 1)
            for tok in emitted:
                req.tokens.append(tok)
                self._c_tokens.inc()
                self._h_per_token.observe(dt)
                if req.first_token_t is None:
                    req.first_token_t = now
                    self._h_ttft.observe(now - req.submit_t)
                    if req.warm is True:
                        self._h_ttft_warm.observe(now - req.submit_t)
                    elif req.warm is False:
                        self._h_ttft_cold.observe(now - req.submit_t)
                if len(req.tokens) >= req.max_new or \
                        (eos is not None and tok == int(eos)):
                    # tokens past the stop condition (possible inside a
                    # speculative window) are discarded — the slot's
                    # device state is replaced wholesale at re-join
                    self._finish(row, now)
                    break
        if k > 0:
            prop = self._c_spec_proposed.value
            if prop:
                self._g_accept_rate.set(
                    self._c_spec_accepted.value / prop)
        self._g_active.set(self._active_count())
        self._h_host.observe(time.perf_counter() - now)

    def _loop(self) -> None:
        pending: Optional[_Pending] = None
        try:
            if self.device.type == "cuda":
                # a fresh thread's current device is 0: launch on ours
                torch.cuda.set_device(self.device)
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
