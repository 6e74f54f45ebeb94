"""Prefix KV cache — decode accelerator #1 (the port of
``distkeras_tpu.serve.prefix``: the same keys, LRU, aliasing and byte
accounting, so one sequence of operations gives the same hits,
evictions and bytes in both packages).

Production traffic shares long system-prompt prefixes, so most prefill
work is redundant: the engine caches every admitted prompt's device-side
KV slices (one single-row cache pytree padded to the model's full
``seq_len``, plus the token row itself) keyed by its token content.  A
later ``_admit`` looks up the **longest cached prefix** of its prompt
and dispatches a *suffix join* — a short ``decode_window``
over only the uncached tail — instead of re-prefilling from token 0.
Time-to-first-token on a warm prefix collapses from O(prompt²·D)
prefill to O(suffix·prompt·D) replay.

**Block-aligned matching.**  An entry is registered under a lookup key
at every ``block`` boundary of its content (plus its full length), so
two prompts sharing a system prefix hit each other's entries without
either being a strict prefix of the other — the actual production
shape (``system + user_a`` vs ``system + user_b``).  A hit at matched
length ``m`` uses only cache positions ``< m``; the entry's own
continuation beyond ``m`` is *stale for this prompt* but provably
inert: a row's attention horizon is its own position, and every
position is overwritten by a real write before any kept logit attends
it (the same placeholder contract as prefill padding — see
``decode_window``).  Matches are verified token-by-token after the
hash, so a collision can never serve another prompt's KV.

This module is the HOST side only: an LRU of device-tensor entries with
byte accounting.  All device math (the per-bucket suffix joins,
entry capture inside the cold join) lives in ``engine.py``; exactness
holds because prefill and cached decode write identical K/V for
identical tokens at identical positions (the ``generate_tokens`` parity
contract ``models.generation`` already tests).

Bounds and invalidation:

* The LRU is bounded in **bytes** (``ServeConfig.prefix_cache_mb``) —
  entries are full-length KV slices, exactly one decode slot's worth of
  device memory each.  Inserting past the budget evicts
  least-recently-used entries (``serve.prefix.evictions``).
* ``DecodeEngine.promote()`` **flushes the cache**: cached KV is a pure
  function of (tokens, weights), so a checkpoint swap invalidates every
  entry.  Serving correctness never depends on the cache — only ttft
  does.

Thread-safety: one internal lock.  The decode thread looks up / inserts
on every admit; ``promote()`` flushes from the caller's thread.

Metrics (service registry): counters ``serve.prefix.hits`` /
``serve.prefix.misses`` / ``serve.prefix.inserts`` /
``serve.prefix.evictions``, gauges ``serve.prefix.bytes`` /
``serve.prefix.entries``.  The engine splits ttft into
``serve.ttft_warm_seconds`` / ``serve.ttft_cold_seconds`` on top of the
combined histogram.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Optional

import numpy as np

from ..utils.tree import tree_leaves


def tree_nbytes(tree) -> int:
    """Total bytes of a tree of (device) tensors or numpy arrays."""
    return sum(int(leaf.nbytes) if hasattr(leaf, "nbytes")
               else int(np.asarray(leaf).nbytes)
               for leaf in tree_leaves(tree))


class PrefixEntry:
    """One cached prompt: its token row padded to ``seq_len`` (device),
    the single-row KV cache pytree(s) padded to ``seq_len`` (device),
    and the host-side token content for exact-match verification."""

    __slots__ = ("host_tokens", "length", "tokens", "cache", "draft_cache",
                 "nbytes", "alias_keys", "all_keys")

    def __init__(self, host_tokens: np.ndarray, tokens, cache,
                 draft_cache=None):
        self.host_tokens = np.asarray(host_tokens, np.int32)
        self.length = int(self.host_tokens.shape[0])
        self.tokens = tokens            # (1, T) int32, device
        self.cache = cache              # single-row KV pytree, device
        self.draft_cache = draft_cache  # ditto for the draft, or None
        self.nbytes = (tree_nbytes(cache) + int(tokens.nbytes)
                       + (0 if draft_cache is None
                          else tree_nbytes(draft_cache)))
        self.alias_keys: list = []      # lookup keys this entry OWNS
        self.all_keys: list = []        # every boundary key it can serve


class PrefixCache:
    """Byte-bounded LRU of :class:`PrefixEntry`, block-alias-keyed by
    token content.

    One entry, many keys: ``(L, sha1(tokens[:L]))`` for every ``block``
    multiple ``L`` of the entry's content plus its full length.  Lookup
    probes the registered lengths ascending in ONE incremental hash
    pass over the prompt (hash-state copy per boundary, then an exact
    token compare; the longest verified match wins) and caps the match
    at ``len(prompt) - 1``: the
    suffix join always re-plays at least one token, so it always
    produces fresh last-token logits and no zero-length-suffix program
    is needed."""

    def __init__(self, budget_bytes: int, registry, block: int = 16):
        self.budget = int(budget_bytes)
        self.block = max(1, int(block))
        self._entries: "OrderedDict[tuple, PrefixEntry]" = OrderedDict()
        self._alias: dict = {}       # (L, digest) -> primary key
        self._lengths: dict = {}     # alias length -> alias count
        #: (L, digest) -> set of primaries whose content STARTS with
        #: those bytes — every candidate heir for an alias whose owner
        #: evicts, exact by construction (each holder registered the
        #: digest of its OWN first L tokens)
        self._holders: dict = {}
        self._bytes = 0
        self._lock = threading.Lock()
        self._c_hits = registry.counter("serve.prefix.hits")
        self._c_misses = registry.counter("serve.prefix.misses")
        self._c_inserts = registry.counter("serve.prefix.inserts")
        self._c_remote_inserts = registry.counter(
            "serve.prefix.remote_inserts")
        self._c_evictions = registry.counter("serve.prefix.evictions")
        self._g_bytes = registry.gauge("serve.prefix.bytes")
        self._g_entries = registry.gauge("serve.prefix.entries")

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def nbytes(self) -> int:
        with self._lock:
            return self._bytes

    def _alias_lengths(self, length: int):
        """The lookup lengths an entry of ``length`` registers: every
        block multiple plus the full length."""
        ls = set(range(self.block, length + 1, self.block))
        ls.add(length)
        return sorted(ls)

    def lookup(self, prompt: np.ndarray) -> Optional[tuple]:
        """Longest cached prefix of ``prompt`` as ``(entry,
        matched_len)`` (LRU-refreshed), or None.  ``matched_len`` is
        capped at ``len(prompt) - 1`` — an entry covering the WHOLE
        prompt (e.g. a resubmission) still re-plays the last token,
        regenerating its logits exactly.  Counts one hit or miss."""
        prompt = np.asarray(prompt, np.int32)
        n = int(prompt.shape[0])
        if n <= 1:  # matched_len is capped at n-1; nothing can match
            self._c_misses.inc()
            return None
        with self._lock:
            lengths = sorted(self._lengths)
        # ONE incremental hash pass over the prompt, OUTSIDE the lock
        # (the sha1 work dominates; this sits on the decode thread's
        # ttft-critical admit path and promote()'s flush must not stall
        # behind it).  A stale lengths snapshot only costs a benign
        # one-time miss at a just-registered boundary.
        data = np.ascontiguousarray(prompt).tobytes()
        digests = []
        h = hashlib.sha1()
        hashed = 0  # bytes of ``data`` folded into ``h`` so far
        for length in lengths:
            if length > n:
                break  # ascending: no later length can match
            h.update(data[hashed:length * 4])
            hashed = length * 4
            digests.append((length, h.copy().digest()))
        with self._lock:
            best = None
            for length, digest in digests:
                primary = self._alias.get((length, digest))
                if primary is None:
                    continue
                entry = self._entries[primary]
                if not np.array_equal(entry.host_tokens[:length],
                                      prompt[:length]):
                    continue
                best = (primary, length)  # ascending: keep the longest
            if best is None:
                self._c_misses.inc()
                return None
            primary, length = best
            self._entries.move_to_end(primary)
            self._c_hits.inc()
            return self._entries[primary], min(length, n - 1)

    def peek(self, prompt: np.ndarray) -> Optional[tuple]:
        """The longest cached prefix of ``prompt`` as ``(entry,
        matched_len)`` WITHOUT observing it: no hit/miss counters, no
        LRU refresh, no ``n - 1`` cap.  The KV-fabric export path
        reads through this — the router's affinity-decay
        validation compares ``serve.prefix.hits``/``misses`` against
        routed traffic, and a fabric export probing the cache must not
        pollute that signal (or reorder the LRU the migration exporter
        is about to walk)."""
        prompt = np.asarray(prompt, np.int32)
        n = int(prompt.shape[0])
        if n < 1:
            return None
        with self._lock:
            lengths = sorted(self._lengths)
        data = np.ascontiguousarray(prompt).tobytes()
        digests = []
        h = hashlib.sha1()
        hashed = 0
        for length in lengths:
            if length > n:
                break
            h.update(data[hashed:length * 4])
            hashed = length * 4
            digests.append((length, h.copy().digest()))
        with self._lock:
            best = None
            for length, digest in digests:
                primary = self._alias.get((length, digest))
                if primary is None:
                    continue
                entry = self._entries[primary]
                if not np.array_equal(entry.host_tokens[:length],
                                      prompt[:length]):
                    continue
                best = (primary, length)
            if best is None:
                return None
            primary, length = best
            return self._entries[primary], length

    def hottest(self, max_entries: int, budget_bytes: int) -> list:
        """The MRU-side entries, most-recently-used first, stopping at
        ``max_entries`` or ``budget_bytes`` — the migration exporter's
        unit: a draining/evicting engine ships its hottest
        working set to survivors, bounded so a big cache never stalls
        the planned transition behind a bulk transfer."""
        out: list = []
        total = 0
        with self._lock:
            for primary in reversed(self._entries):
                entry = self._entries[primary]
                if len(out) >= int(max_entries) or \
                        total + entry.nbytes > int(budget_bytes):
                    break
                out.append(entry)
                total += entry.nbytes
        return out

    def insert_remote(self, entry: PrefixEntry) -> None:
        """Insert an entry whose KV arrived OVER THE WIRE from a peer
        engine — the KV-fabric landing seam, counted
        separately (``serve.prefix.remote_inserts``) so a snapshot shows
        how much of the cache was replicated vs locally computed.

        Its one caller is ``serve/kvfabric.py``: remote KV is only valid
        under the checkpoint version it was computed for, and that stamp
        is checked (before AND after the insert) only inside the fabric
        seam — any other call site could join stale KV."""
        self._c_remote_inserts.inc()
        self.insert(entry)

    def insert(self, entry: PrefixEntry) -> None:
        """Insert (dedup by content: an existing identical entry is only
        LRU-refreshed, and an entry whose every lookup key is already
        owned — its content fully covered by an older entry — refreshes
        that owner instead of storing unreachable KV), then evict LRU
        entries past the byte budget."""
        # ONE incremental hash pass builds every boundary key, outside
        # the lock (like lookup()'s hash pass: the decode thread's
        # ttft-critical admit path); the full length is always the last
        # boundary, so the primary key falls out for free
        data = np.ascontiguousarray(entry.host_tokens).tobytes()
        keys = []
        h = hashlib.sha1()
        hashed = 0
        for length in self._alias_lengths(entry.length):
            h.update(data[hashed:length * 4])
            hashed = length * 4
            keys.append((length, h.copy().digest()))
        primary = keys[-1]
        with self._lock:
            if primary in self._entries:
                self._entries.move_to_end(primary)
                return
            self._entries[primary] = entry
            for key in keys:
                # first writer wins an alias: the older entry's prefix
                # KV is byte-identical for the shared tokens
                if key not in self._alias:
                    self._alias[key] = primary
                    entry.alias_keys.append(key)
                    self._lengths[key[0]] = \
                        self._lengths.get(key[0], 0) + 1
            if not entry.alias_keys:
                # every lookup key this entry could answer is owned by
                # an entry already holding these exact prefix bytes, so
                # it could never be hit — spend no budget on dead KV;
                # LRU-refresh the covering owner instead (the
                # dedup-by-content contract, extended to coverage)
                del self._entries[primary]
                owner = self._alias.get(primary)
                if owner is not None:
                    self._entries.move_to_end(owner)
                return
            entry.all_keys = keys
            for key in keys:
                self._holders.setdefault(key, set()).add(primary)
            self._bytes += entry.nbytes
            self._c_inserts.inc()
            while self._bytes > self.budget and self._entries:
                self._evict_lru()
            self._g_bytes.set(self._bytes)
            self._g_entries.set(len(self._entries))

    def _evict_lru(self) -> None:  # caller holds _lock
        old_primary, old = self._entries.popitem(last=False)
        self._bytes -= old.nbytes
        for key in old.all_keys:
            held = self._holders.get(key)
            if held is not None:
                held.discard(old_primary)
                if not held:
                    del self._holders[key]
        for key in old.alias_keys:
            # First-writer-wins means the evictee may own lookup keys
            # whose prefix bytes other live entries still hold (their
            # KV for the shared tokens is byte-identical) — re-point
            # the alias at a surviving holder instead of dropping it
            # and forcing an avoidable cold prefill.  The holders index
            # makes this an exact O(1) probe: every candidate registered
            # the digest of its OWN first ``key[0]`` tokens, and lookup
            # still token-verifies after the hash, so a collision can
            # never serve foreign KV.
            held = self._holders.get(key)
            if held:
                heir = next(iter(held))
                self._alias[key] = heir
                self._entries[heir].alias_keys.append(key)
                continue
            self._alias.pop(key, None)
            length = key[0]
            left = self._lengths.get(length, 1) - 1
            if left:
                self._lengths[length] = left
            else:
                self._lengths.pop(length, None)
        self._c_evictions.inc()

    def flush(self) -> int:
        """Drop every entry (checkpoint promotion: cached KV is a pure
        function of the weights).  Returns the number dropped."""
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            self._alias.clear()
            self._lengths.clear()
            self._holders.clear()
            self._bytes = 0
            self._g_bytes.set(0)
            self._g_entries.set(0)
            return n
