"""Serving configuration — the knob bundle ``DecodeEngine`` reads, copied
from ``distkeras_tpu.serve.config`` (same fields, defaults and bucket
rule).

The one load-bearing choice is **bucketing**: every program's shapes are
fixed by ``(slots, seq_len)`` plus a small ascending set of prefill
lengths (``prefill_buckets``).  A request's prompt is right-padded to the
smallest bucket that holds it, so the service runs ``len(buckets) + 1``
distinct program signatures and, after ``warmup()``, never a new one
(``jit.retraces == 0``).

The decode accelerators are knobs here too: ``prefix_cache`` (and with
it the fleet ``kv_fabric``) and ``spec_k > 0`` (speculative decoding,
which needs a draft model passed to ``DecodeEngine``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

#: smallest derived prefill bucket — below this, halving buckets buys
#: little prefill time and costs a compiled program each
_MIN_BUCKET = 32

#: derived bucket count cap (largest is always the full seq_len)
_MAX_BUCKETS = 4


@dataclasses.dataclass
class ServeConfig:
    """Knobs for the continuous-batching decode service.

    * ``slots`` — continuous-batch width: how many requests decode
      concurrently (the B of every compiled program).
    * ``max_queue`` — admission bound: every request transits the queue
      (the decode thread drains it into slots), so this bounds the
      admitted-but-not-yet-slotted backlog; a full queue load-sheds
      (``serve.rejected``).  Must be >= 1 — a zero-length queue would
      reject everything even with every slot idle.
    * ``max_new_tokens`` — per-request generation cap (and the default
      when a request names none); admission enforces
      ``prompt_len + max_new <= seq_len``.
    * ``prefill_buckets`` — ascending prompt-pad lengths; None derives
      a geometric ladder ending at the model's ``seq_len``.
    * ``temperature`` / ``top_k`` / ``top_p`` / ``eos_id`` — sampling
      controls, identical semantics to
      ``models.generation.generate_tokens`` (0.0 = greedy; ``eos_id``
      finishes a row early).  The first three are the per-request
      DEFAULTS — ``submit()`` may override them per request; they ride
      into the step as per-row values, so any mix of greedy and sampled
      requests shares a batch at ``jit.retraces == 0``.
    * ``seed`` — sampling generator seed (one stream for the whole
      service; with ``temperature == 0`` decoding is deterministic per
      request).
    * ``drain_timeout_s`` — graceful-drain bound: how long ``drain()``
      waits for in-flight requests before aborting them (aborts are
      recorded as rejections — nothing drops silently).
    * ``prefix_cache`` / ``prefix_cache_mb`` / ``prefix_block`` — the
      prefix KV cache (``serve/prefix.py``): a byte-bounded LRU of
      admitted prompts' single-row KV, block-aligned lookup, flushed on
      ``promote()``.
    * ``kv_fabric`` — with the prefix cache on, answer the fleet KV
      fabric's ``kv_fetch`` / ``kv_push`` RPCs (``serve/kvfabric.py``).
    * ``spec_k`` — speculative decoding: the draft proposes ``spec_k``
      tokens per row, the target verifies them in one window; 0
      disables.
    """

    slots: int = 4
    max_queue: int = 32
    max_new_tokens: int = 64
    prefill_buckets: Optional[Sequence[int]] = None
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    eos_id: Optional[int] = None
    seed: int = 0
    drain_timeout_s: float = 30.0
    prefix_cache: bool = False
    prefix_cache_mb: float = 64.0
    prefix_block: int = 16
    kv_fabric: bool = True
    spec_k: int = 0

    def __post_init__(self):
        if int(self.slots) < 1:
            raise ValueError(f"slots must be >= 1, got {self.slots}")
        if int(self.max_queue) < 1:
            raise ValueError(f"max_queue must be >= 1 (admission flows "
                             f"through the queue), got {self.max_queue}")
        if int(self.max_new_tokens) < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{self.max_new_tokens}")
        if float(self.temperature) < 0.0:
            raise ValueError(f"temperature must be >= 0, got "
                             f"{self.temperature}")
        if self.top_k is not None and int(self.top_k) < 1:
            raise ValueError(f"top_k must be >= 1, got {self.top_k}")
        if self.top_p is not None and not 0.0 < float(self.top_p) <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        # a config that can only misbehave is rejected here, before an
        # engine is built on it
        if self.prefix_cache and not float(self.prefix_cache_mb) > 0.0:
            raise ValueError(
                f"prefix_cache_mb must be > 0 when the prefix cache is "
                f"enabled (it bounds the device-side KV LRU), got "
                f"{self.prefix_cache_mb}")
        if int(self.prefix_block) < 1:
            raise ValueError(f"prefix_block must be >= 1, got "
                             f"{self.prefix_block}")
        if int(self.spec_k) < 0:
            raise ValueError(f"spec_k must be >= 0 (0 disables "
                             f"speculative decode), got {self.spec_k}")

    def resolved_buckets(self, seq_len: int) -> Tuple[int, ...]:
        """The ascending prefill-bucket lengths for a ``seq_len`` model:
        the explicit ``prefill_buckets`` (validated, largest must cover
        the longest admissible prompt = ``seq_len``), or a derived
        geometric ladder ``(..., seq_len/4, seq_len/2, seq_len)``."""
        seq_len = int(seq_len)
        if self.prefill_buckets is not None:
            buckets = sorted({int(b) for b in self.prefill_buckets})
            if not buckets or buckets[0] < 1 or buckets[-1] > seq_len:
                raise ValueError(
                    f"prefill_buckets must lie in [1, {seq_len}], got "
                    f"{self.prefill_buckets}")
            if buckets[-1] != seq_len:
                buckets.append(seq_len)
            return tuple(buckets)
        buckets = [seq_len]
        while buckets[0] // 2 >= _MIN_BUCKET and len(buckets) < _MAX_BUCKETS:
            buckets.insert(0, buckets[0] // 2)
        return tuple(buckets)

    def bucket_for(self, prompt_len: int, seq_len: int) -> int:
        """Smallest bucket holding ``prompt_len`` (ValueError when none)."""
        for b in self.resolved_buckets(seq_len):
            if prompt_len <= b:
                return b
        raise ValueError(f"prompt length {prompt_len} exceeds the largest "
                         f"prefill bucket "
                         f"{self.resolved_buckets(seq_len)[-1]}")

    def config_row(self, seq_len: int) -> dict:
        """Plain-data config for obs snapshots / the bench row — the
        fields that make two runs comparable (drift gate ``config``)."""
        return {
            "slots": int(self.slots),
            "max_queue": int(self.max_queue),
            "max_new_tokens": int(self.max_new_tokens),
            "prefill_buckets": list(self.resolved_buckets(seq_len)),
            "temperature": float(self.temperature),
            "top_k": None if self.top_k is None else int(self.top_k),
            "top_p": None if self.top_p is None else float(self.top_p),
            "eos_id": None if self.eos_id is None else int(self.eos_id),
            "prefix_cache": bool(self.prefix_cache),
            "prefix_cache_mb": float(self.prefix_cache_mb)
            if self.prefix_cache else None,
            "prefix_block": int(self.prefix_block)
            if self.prefix_cache else None,
            "kv_fabric": bool(self.kv_fabric and self.prefix_cache),
            "spec_k": int(self.spec_k),
        }
