"""Runtime race detector for the port's PS and serving stacks — dklint's
dynamic half (the port of ``distkeras_tpu.analysis.racecheck``).

The static ``lock-discipline`` rule reasons lexically; this module checks
the same discipline at runtime on REAL thread interleavings.  The port's
threaded test files turn it on through one module-scope fixture
(``tests/test_torch_racecheck.py``: ``racecheck_module``);
``DKLINT_RACECHECK=0`` opts out, with zero overhead when disabled.

Mechanics (a write-focused lockset check, in the Eraser family):

* ``TrackedLock`` wraps a ``threading.Lock`` and records which threads
  currently hold it (re-entrant bookkeeping, so an RLock upgrade keeps
  working).
* ``GuardedDict`` subclasses ``dict``; every mutation checks the guard.
  A mutation WITHOUT the guard held is a violation once the dict has been
  touched by more than one thread — single-threaded setup/teardown stays
  legal (construction and post-join reads have a happens-before edge the
  detector cannot see, so reads are recorded but never flagged).
* ``install()`` monkeypatches ``__init__`` across the fleet: every
  ``ParameterServer`` subclass of ``ps/servers.py`` plus ``ServeRouter``,
  ``DecodeEngine``, ``KVFabric`` and ``FleetSupervisor`` built
  afterwards get tracked locks and guarded shared containers.  A class
  or attribute it cannot find is an error naming it (a rename must not
  turn the checker off without notice).  The install registry is
  CLASS-KEYED and idempotent — uninstall restores exactly the attributes
  it patched, per class.  ``enabled()`` is the context-manager form
  tests use.
* **Lock-order recording**: every named ``TrackedLock`` keeps a
  per-thread held stack; acquiring lock B while holding A records the
  order edge A→B in a process-global graph.  An edge that closes a
  cycle is recorded as a violation THE MOMENT it is observed, and
  ``uninstall`` does a final sweep — the dynamic mirror of the static
  ``lock-order-cycle`` rule.  Re-entry of one lock and edges between
  same-named locks (two shards' mutexes) are not edges.
* **Write-after-publish detection**: the pull cache
  (``ps.state.PullCache``) serves pre-serialized frames whose v2 buffers
  are zero-copy views of the center's arrays — the lock-free
  pull-snapshot contract is that commits REPLACE center arrays, never
  mutate them after they were handed to the cache.  When installed, the
  cache's publish hook (``ps.state.set_publish_hook``) fingerprints every
  published leaf (numpy array or tensor), and each subsequent
  ``handle_commit`` re-verifies them: a leaf whose bytes changed after
  publish is a recorded violation (a torn frame some puller may already
  be receiving).

Violations land in a process-global list (thread-safe) with the dict
name, key, thread and stack snippet — ``violations()`` / ``reset()``.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import os
import threading
import traceback
from typing import Any, Dict, List, Optional

import numpy as np
import torch

ENV_VAR = "DKLINT_RACECHECK"

_VIOLATIONS: List[dict] = []
_VLOCK = threading.Lock()


def violations() -> List[dict]:
    """Snapshot of recorded unguarded-access violations."""
    with _VLOCK:
        return list(_VIOLATIONS)


def reset() -> None:
    with _VLOCK:
        _VIOLATIONS.clear()
        _PUBLISHED.clear()
        _LOCK_EDGES.clear()
        _CYCLES_SEEN.clear()


def _record_violation(name: str, op: str, key: Any) -> None:
    # drop the two racecheck frames; keep the caller's context
    stack = "".join(traceback.format_stack(limit=8)[:-2])
    with _VLOCK:
        _VIOLATIONS.append({
            "dict": name, "op": op, "key": key,
            "thread": threading.current_thread().name,
            "stack": stack,
        })


# ---------------------------------------------------------------------------
# write-after-publish detection: the lock-free pull-snapshot
# contract — once a center tree's buffers are handed to the pre-serialized
# pull cache, commits must replace (never mutate) those arrays
# ---------------------------------------------------------------------------

#: id(ps) -> list[(published ndarray, fingerprint, leaf label)] for the
#: LATEST publish per server (older payloads leave the cache when
#: replaced); every touch under _VLOCK.  Strong references are fine: the
#: cache's wire frames keep the arrays alive anyway, and reset() clears.
_PUBLISHED: Dict[int, list] = {}


def _iter_leaves(tree: Any, prefix: str = ""):
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _iter_leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _iter_leaves(v, f"{prefix}{i}/")
    elif isinstance(tree, np.ndarray) or torch.is_tensor(tree):
        yield prefix[:-1] if prefix else "", tree


def _fingerprint(arr) -> bytes:
    """A digest of a leaf's bytes: a numpy array, or a tensor (the port's
    center leaves may be either; a tensor on the card is read back)."""
    if torch.is_tensor(arr):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        arr = t.numpy()
    return hashlib.blake2b(np.ascontiguousarray(arr).tobytes(),
                           digest_size=8).digest()


def _on_publish(owner: Any, center: Any) -> None:
    """``ps.state`` publish hook: fingerprint every leaf the
    pull cache just captured for ``owner``'s latest payload."""
    if owner is None or center is None:
        return
    entry = [(arr, _fingerprint(arr), label)
             for label, arr in _iter_leaves(center)]
    with _VLOCK:
        _PUBLISHED[id(owner)] = entry


def _check_published(owner: Any) -> None:
    """Verify the owner's published leaves still hold their published
    bytes; a changed one is a write-after-publish violation (recorded
    once per mutation — the stored fingerprint is refreshed so the same
    corruption is not re-reported every commit)."""
    with _VLOCK:
        entry = _PUBLISHED.get(id(owner))
    if not entry:
        return
    refreshed = []
    for arr, fp, label in entry:
        now = _fingerprint(arr)
        if now != fp:
            _record_violation(f"{type(owner).__name__}.center",
                              "write_after_publish", label)
        refreshed.append((arr, now, label))
    with _VLOCK:
        if _PUBLISHED.get(id(owner)) is entry:
            _PUBLISHED[id(owner)] = refreshed


def enabled_by_env() -> bool:
    """Whether the env asks for racecheck.  ON unless explicitly
    disabled: ``DKLINT_RACECHECK=0`` (or ``off``/``false``/``no``/empty)
    opts out."""
    return os.environ.get(ENV_VAR, "1").lower() not in (
        "", "0", "off", "false", "no")


# ---------------------------------------------------------------------------
# lock-order recording: the dynamic half of lock-order-cycle
# ---------------------------------------------------------------------------

#: (held lock name, acquired lock name) -> observation count; under _VLOCK
_LOCK_EDGES: Dict[tuple, int] = {}
#: canonical cycle tuples already reported; under _VLOCK
_CYCLES_SEEN: set = set()
_TLS = threading.local()


def _held_stack() -> list:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


def lock_order_edges() -> Dict[tuple, int]:
    """Snapshot of the observed acquisition-order graph."""
    with _VLOCK:
        return dict(_LOCK_EDGES)


def _canon_cycle(path: tuple) -> tuple:
    """Rotate a cycle node tuple so the smallest name leads — one
    identity per rotation class."""
    i = path.index(min(path))
    return path[i:] + path[:i]


def _find_cycle(a: str, b: str, edges: Dict[tuple, int]):
    """Path b -> ... -> a in the edge graph, as a cycle tuple starting
    at ``a`` — the cycle the new edge (a, b) would close."""
    adj: Dict[str, list] = {}
    for (u, v) in edges:
        adj.setdefault(u, []).append(v)
    stack = [(b, (a, b))]
    seen = {b}
    while stack:
        node, path = stack.pop()
        for nxt in sorted(adj.get(node, ())):
            if nxt == a:
                return path
            if nxt not in seen and len(path) < 8:
                seen.add(nxt)
                stack.append((nxt, path + (nxt,)))
    return None


def _note_acquired(lock: "TrackedLock") -> None:
    """First (non-reentrant) acquisition by this thread: record order
    edges from every distinctly-named lock the thread already holds,
    flag immediately if one closes a cycle, then push."""
    st = _held_stack()
    cycles = []
    if st:
        held_names = []
        for h in st:
            if h.name != lock.name and h.name not in held_names:
                held_names.append(h.name)
        with _VLOCK:
            for hname in held_names:
                key = (hname, lock.name)
                fresh = key not in _LOCK_EDGES
                _LOCK_EDGES[key] = _LOCK_EDGES.get(key, 0) + 1
                if not fresh:
                    continue
                cyc = _find_cycle(hname, lock.name, _LOCK_EDGES)
                if cyc is not None:
                    canon = _canon_cycle(cyc)
                    if canon not in _CYCLES_SEEN:
                        _CYCLES_SEEN.add(canon)
                        cycles.append(canon)
    for canon in cycles:
        _record_violation("lock-order", "cycle",
                          " -> ".join(canon + (canon[0],)))
    st.append(lock)


def _note_released(lock: "TrackedLock") -> None:
    st = _held_stack()
    for i in range(len(st) - 1, -1, -1):
        if st[i] is lock:
            del st[i]
            break


def _flush_lock_cycles() -> None:
    """Final sweep at uninstall: report any cycle in the observed edge
    graph not already flagged incrementally (belt over suspenders — the
    incremental check fires as edges land)."""
    with _VLOCK:
        edges = dict(_LOCK_EDGES)
    fresh = []
    for (a, b) in sorted(edges):
        cyc = _find_cycle(a, b, edges)
        if cyc is None:
            continue
        canon = _canon_cycle(cyc)
        with _VLOCK:
            if canon in _CYCLES_SEEN:
                continue
            _CYCLES_SEEN.add(canon)
        fresh.append(canon)
    for canon in fresh:
        _record_violation("lock-order", "cycle",
                          " -> ".join(canon + (canon[0],)))


class TrackedLock:
    """Lock proxy that knows which threads currently hold it and feeds
    the global acquisition-order graph (named locks only — an anonymous
    proxy still tracks holders but records no edges)."""

    def __init__(self, lock: Optional[threading.Lock] = None,
                 name: str = ""):
        self._lock = lock if lock is not None else threading.Lock()
        self._meta = threading.Lock()
        self._holders: Dict[int, int] = {}  # thread id -> depth
        self.name = name

    def acquire(self, *args, **kwargs) -> bool:
        got = self._lock.acquire(*args, **kwargs)
        if got:
            tid = threading.get_ident()
            with self._meta:
                depth = self._holders.get(tid, 0)
                self._holders[tid] = depth + 1
            if depth == 0 and self.name:
                _note_acquired(self)
        return got

    def release(self) -> None:
        tid = threading.get_ident()
        with self._meta:
            depth = self._holders.get(tid, 0)
            if depth <= 1:
                self._holders.pop(tid, None)
            else:
                self._holders[tid] = depth - 1
        if depth <= 1 and self.name:
            _note_released(self)
        self._lock.release()

    def held_by_current_thread(self) -> bool:
        return threading.get_ident() in self._holders

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class _GuardedMixin:
    """Shared write-lockset bookkeeping for the guarded containers: a
    mutation without the guard held is a violation once the container
    has been touched by more than one thread."""

    def _init_guard(self, guard: TrackedLock, name: str) -> None:
        self._guard = guard
        self._name = name
        self._threads: set = set()
        self._threads.add(threading.get_ident())

    def _touch(self, op: str, key: Any, write: bool) -> None:
        tid = threading.get_ident()
        self._threads.add(tid)  # GIL-atomic set.add
        if write and len(self._threads) > 1 and \
                not self._guard.held_by_current_thread():
            _record_violation(self._name, op, key)


class GuardedDict(_GuardedMixin, dict):
    """dict that requires ``guard`` to be held for mutations once the
    dict is shared across threads.  Reads record thread participation
    only (post-join single-thread reads are legal and common)."""

    def __init__(self, guard: TrackedLock, name: str, data=()):
        super().__init__(data)
        self._init_guard(guard, name)

    # -- reads (participation only) ----------------------------------------
    def __getitem__(self, key):
        self._touch("getitem", key, write=False)
        return super().__getitem__(key)

    def get(self, key, default=None):
        self._touch("get", key, write=False)
        return super().get(key, default)

    # -- writes (checked) ---------------------------------------------------
    def __setitem__(self, key, value):
        self._touch("setitem", key, write=True)
        super().__setitem__(key, value)

    def __delitem__(self, key):
        self._touch("delitem", key, write=True)
        super().__delitem__(key)

    def pop(self, key, *default):
        self._touch("pop", key, write=True)
        return super().pop(key, *default)

    def popitem(self):
        self._touch("popitem", None, write=True)
        return super().popitem()

    def clear(self):
        self._touch("clear", None, write=True)
        super().clear()

    def update(self, *args, **kwargs):
        self._touch("update", None, write=True)
        super().update(*args, **kwargs)

    def setdefault(self, key, default=None):
        self._touch("setdefault", key, write=True)
        return super().setdefault(key, default)


class GuardedOrderedDict(_GuardedMixin, collections.OrderedDict):
    """OrderedDict under the same write-lockset check — covers the
    router's LRU affinity table (``move_to_end`` / LRU ``popitem`` are
    writes too: they mutate the order the eviction scan relies on)."""

    def __init__(self, guard: TrackedLock, name: str, data=()):
        super().__init__(data)
        self._init_guard(guard, name)

    def __getitem__(self, key):
        self._touch("getitem", key, write=False)
        return super().__getitem__(key)

    def get(self, key, default=None):
        self._touch("get", key, write=False)
        return super().get(key, default)

    def __setitem__(self, key, value):
        # OrderedDict.__init__/__reduce__ call __setitem__ before our
        # guard exists — pass construction-time writes through
        if hasattr(self, "_guard"):
            self._touch("setitem", key, write=True)
        super().__setitem__(key, value)

    def __delitem__(self, key):
        self._touch("delitem", key, write=True)
        super().__delitem__(key)

    def pop(self, key, *default):
        self._touch("pop", key, write=True)
        return super().pop(key, *default)

    def popitem(self, last=True):
        self._touch("popitem", None, write=True)
        return super().popitem(last=last)

    def move_to_end(self, key, last=True):
        self._touch("move_to_end", key, write=True)
        return super().move_to_end(key, last=last)

    def clear(self):
        self._touch("clear", None, write=True)
        super().clear()

    def update(self, *args, **kwargs):
        self._touch("update", None, write=True)
        super().update(*args, **kwargs)

    def setdefault(self, key, default=None):
        self._touch("setdefault", key, write=True)
        return super().setdefault(key, default)


class GuardedSet(_GuardedMixin, set):
    """set under the same write-lockset check — the fabric's
    single-flight key set."""

    def __init__(self, guard: TrackedLock, name: str, data=()):
        super().__init__(data)
        self._init_guard(guard, name)

    def add(self, item):
        self._touch("add", item, write=True)
        super().add(item)

    def discard(self, item):
        self._touch("discard", item, write=True)
        super().discard(item)

    def remove(self, item):
        self._touch("remove", item, write=True)
        super().remove(item)

    def pop(self):
        self._touch("pop", None, write=True)
        return super().pop()

    def clear(self):
        self._touch("clear", None, write=True)
        super().clear()

    def update(self, *args):
        self._touch("update", None, write=True)
        super().update(*args)


def wrap_ps(ps) -> None:
    """Instrument one already-built ParameterServer in place: tracked
    mutex + guarded shared dicts (idempotent)."""
    if not isinstance(ps.mutex, TrackedLock):
        ps.mutex = TrackedLock(ps.mutex, name="ParameterServer.mutex")
    name = type(ps).__name__
    # every mutex-guarded shared dict, the fleet-lifecycle state
    # (generations/tombstones/eviction tallies) included — commit handler
    # threads and the supervisor thread both touch them
    for attr in ("commits_by_worker", "generations", "tombstoned_by_worker",
                 "evictions_by_worker", "respawns_by_worker",
                 "joins_by_worker"):
        cur = getattr(ps, attr, None)
        if cur is not None and not isinstance(cur, GuardedDict):
            setattr(ps, attr, GuardedDict(ps.mutex, f"{name}.{attr}", cur))
    by_worker = getattr(ps, "_h_by_worker", None)
    if by_worker is not None and not isinstance(by_worker, GuardedDict):
        ps._h_by_worker = GuardedDict(ps.mutex, f"{name}._h_by_worker",
                                      by_worker)


# ---------------------------------------------------------------------------
# fleet wrap functions: one per instrumented class, each
# idempotent — install patches the class __init__ to call these
# ---------------------------------------------------------------------------

def wrap_router(r) -> None:
    """ServeRouter: routing lock + promote lock tracked, the LRU
    affinity table guarded (owner lists, ``move_to_end`` ordering and
    LRU eviction are all ``_lock``-protected state)."""
    if not isinstance(r._lock, TrackedLock):
        r._lock = TrackedLock(r._lock, name="ServeRouter._lock")
    if not isinstance(r._promote_lock, TrackedLock):
        r._promote_lock = TrackedLock(r._promote_lock,
                                      name="ServeRouter._promote_lock")
    if not isinstance(r._affinity, GuardedOrderedDict):
        r._affinity = GuardedOrderedDict(r._lock, "ServeRouter._affinity",
                                         r._affinity)


def wrap_engine(e) -> None:
    """DecodeEngine: tracked queue lock.  The engine's ``_work``
    condition wraps ``_lock`` — it must be REBUILT over the proxy, or
    ``wait()`` would release the raw lock while the proxy still thinks
    it is held and every subsequent lockset check lies."""
    if not isinstance(e._lock, TrackedLock):
        e._lock = TrackedLock(e._lock, name="DecodeEngine._lock")
        e._work = threading.Condition(e._lock)


def wrap_fabric(f) -> None:
    """KVFabric: tracked job lock (condition rebuilt, see wrap_engine),
    guarded single-flight set and per-link job counts."""
    if not isinstance(f._lock, TrackedLock):
        f._lock = TrackedLock(f._lock, name="KVFabric._lock")
        f._work = threading.Condition(f._lock)
    if not isinstance(f._inflight, GuardedSet):
        f._inflight = GuardedSet(f._lock, "KVFabric._inflight",
                                 f._inflight)
    if not isinstance(f._link_jobs, GuardedDict):
        f._link_jobs = GuardedDict(f._lock, "KVFabric._link_jobs",
                                   f._link_jobs)


def wrap_supervisor(s) -> None:
    """FleetSupervisor: tracked fleet lock + guarded incarnation maps
    (the supervisor poll loop and concurrent ``add_worker`` callers both
    write them)."""
    if not isinstance(s._lock, TrackedLock):
        s._lock = TrackedLock(s._lock, name="FleetSupervisor._lock")
    for attr in ("live", "attempts", "finished"):
        cur = getattr(s, attr, None)
        if cur is not None and not isinstance(cur, GuardedDict):
            setattr(s, attr, GuardedDict(s._lock,
                                         f"FleetSupervisor.{attr}", cur))


#: class -> [(attr name, original value)] for everything install patched;
#: the CLASS-KEYED registry that makes uninstall exact and idempotent
_INSTALLED: Dict[type, list] = {}


def installed() -> bool:
    return bool(_INSTALLED)


def _patch_init(cls, wrap, originals: list) -> None:
    orig_init = cls.__init__

    def patched_init(self, *args, _orig=orig_init, _wrap=wrap, **kwargs):
        _orig(self, *args, **kwargs)
        _wrap(self)

    cls.__init__ = patched_init
    originals.append((cls, "__init__", orig_init))


#: the serving/fleet classes install() patches besides the PS hierarchy:
#: (module, class, wrap function)
FLEET_SPECS = (
    ("..serve.router", "ServeRouter", wrap_router),
    ("..serve.engine", "DecodeEngine", wrap_engine),
    ("..serve.kvfabric", "KVFabric", wrap_fabric),
    ("..ps.runner", "FleetSupervisor", wrap_supervisor),
)


def _target(modname: str, attr: str):
    """``modname.attr``, or an error that names what is missing."""
    import importlib
    try:
        return getattr(importlib.import_module(modname, package=__package__),
                       attr)
    except (ImportError, AttributeError) as e:
        raise RuntimeError(
            f"racecheck cannot instrument {modname.lstrip('.')}.{attr}: "
            f"{e} (renamed? update analysis/racecheck.py)") from e


def install():
    """Monkeypatch ``__init__`` across the instrumented fleet so every
    object constructed from now on is racechecked.

    PS servers: patching only the base class would wrap BEFORE subclass
    bodies run (``DynSGDParameterServer`` creates ``_h_by_worker`` after
    ``super().__init__``), leaving that dict unguarded — so every class
    in the hierarchy that defines its own ``__init__`` is patched and
    ``wrap_ps`` stays idempotent.  Serving fleet: ``ServeRouter``,
    ``DecodeEngine``, ``KVFabric``, ``FleetSupervisor`` get the same
    treatment (the router's fabric is built inside
    ``ServeRouter.__init__`` — the fabric's own patched ``__init__``
    wraps it first, and its dynamic reads of ``router._lock`` see the
    proxy installed a moment later, before any fabric thread starts).
    A class or attribute that cannot be found raises ``RuntimeError``
    naming it, with nothing left patched.

    Everything patched is recorded CLASS-KEYED in ``_INSTALLED``;
    ``uninstall()`` restores exactly those attributes and nothing else.
    Returns the ``uninstall()`` callable (a no-op when already
    installed — nested enables uninstall once, at the outermost exit)."""
    import inspect

    if installed():
        return lambda: None  # already installed (nested enables)

    originals: list = []
    try:
        servers = _target("..ps", "servers")
        base = _target("..ps.servers", "ParameterServer")
        targets = [
            cls for _, cls in inspect.getmembers(servers, inspect.isclass)
            if issubclass(cls, base) and "__init__" in vars(cls)
        ] or [base]
        for cls in targets:
            _patch_init(cls, wrap_ps, originals)
        # methods that REBIND guarded attributes (restore() replaces
        # commits_by_worker with a plain dict) must re-wrap afterwards,
        # or detection silently dies for the rest of the run
        for name in ("restore",):
            orig_m = getattr(base, name, None)
            if orig_m is None:
                raise RuntimeError(f"racecheck cannot instrument "
                                   f"ps.servers.ParameterServer.{name}")

            def rewrapped(self, *args, _orig=orig_m, **kwargs):
                out = _orig(self, *args, **kwargs)
                wrap_ps(self)
                return out

            originals.append((base, name, orig_m))
            setattr(base, name, rewrapped)
        # write-after-publish: observe every pull-cache publish, and
        # re-verify the published leaves after each commit applies — a
        # rule that mutated a published leaf in place (instead of the
        # replace-semantics contract) is caught on its very next commit
        orig_commit = getattr(base, "handle_commit", None)
        if orig_commit is None:
            raise RuntimeError("racecheck cannot instrument "
                               "ps.servers.ParameterServer.handle_commit")

        def checked_commit(self, *args, _orig=orig_commit, **kwargs):
            out = _orig(self, *args, **kwargs)
            _check_published(self)
            return out

        originals.append((base, "handle_commit", orig_commit))
        base.handle_commit = checked_commit

        for modname, clsname, wrap in FLEET_SPECS:
            _patch_init(_target(modname, clsname), wrap, originals)

        set_publish_hook = _target("..ps.state", "set_publish_hook")
    except BaseException:
        for cls, attr, orig in reversed(originals):
            setattr(cls, attr, orig)
        raise
    prev_hook = set_publish_hook(_on_publish)
    base._dklint_racecheck = True
    for cls, attr, orig in originals:
        _INSTALLED.setdefault(cls, []).append((attr, orig))

    def uninstall():
        _flush_lock_cycles()  # report observed lock-order cycles
        for cls, patched in list(_INSTALLED.items()):
            for attr, orig in reversed(patched):
                setattr(cls, attr, orig)
            del _INSTALLED[cls]
        set_publish_hook(prev_hook)
        base._dklint_racecheck = False

    return uninstall


@contextlib.contextmanager
def enabled():
    """``with racecheck.enabled() as viol:`` — installs the PS proxies,
    yields the live violations list, uninstalls on exit.  The caller
    asserts ``not viol`` (the port tests' ``racecheck_module`` fixture
    does exactly this).

    The violation list is scoped to the block: reset on entry AND on
    exit, so a test that deliberately seeds a violation inside a nested
    ``enabled()`` cannot leak it into an outer collector (the autouse
    fixture under ``DKLINT_RACECHECK=1``) and fail teardown spuriously.
    Assert on the yielded list before the block closes."""
    reset()
    uninstall = install()
    try:
        yield _VIOLATIONS
    finally:
        uninstall()
        reset()
