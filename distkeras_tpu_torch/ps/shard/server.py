"""Sharded center host — the port of ``distkeras_tpu.ps.shard.server``:
N single-shard parameter servers behind N front-ends, in one process or
one process each.

``ShardedParameterServer`` partitions the center tree with a
:class:`~.plan.ShardPlan` and hosts one ``ParameterServer`` (the
caller's update-rule class, unmodified) per shard behind one
:class:`ShardFrontend` each — so every shard owns its own commit mutex,
accept loop, handler threads, pre-serialized pull cache, codec
accounting and registry.  Commits and pulls from a ``ShardedPSClient``
hit the shards in parallel.

The facade also speaks the ``ParameterServer``-shaped surface the
``FleetSupervisor`` and the async runner drive (``evict_worker`` /
``register_respawn`` / ``register_join`` / ``commits_by_worker`` /
``get_model`` / ``last_seen_age``), fanning lifecycle transitions out to
every shard.  Generation tombstoning is per shard, not a fleet-wide
transaction: a zombie whose commit fan-out races the sequential eviction
sweep can land on a not-yet-bumped shard while the bumped ones tombstone
it.  The consistent-cut pull's ``cut_incomplete`` fallback absorbs the
diverged version vector, and respawn's MIN-window resume replays
at-least-once rather than losing the window.

Shard failure is **fatal and loud**: :meth:`raise_if_unhealthy` — polled
by the supervisor — names the dead shard and its last commit counter
instead of letting workers spin in reconnect backoff against a vanished
listener.  There is no shard failover.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Callable, List, Optional, Tuple

from ...obs import Registry
from ..networking import repo_env
from ..servers import SocketParameterServer
from .plan import ShardPlan

Tree = Any

#: seconds a shard process may take to bind its port
START_TIMEOUT_S = 60.0


class ShardFleetError(RuntimeError):
    """A PS shard died while the fleet depended on it — fatal for the
    run (there is no failover)."""


class ShardFrontend(SocketParameterServer):
    """One shard's TCP front-end: a ``SocketParameterServer`` that
    (1) ships the shard placement descriptor in its ``hello`` reply so
    clients verify plan agreement at negotiation time, (2) answers the
    ``plan`` action with the full plan document (the v1 path: v1 clients
    never send a hello), and (3) serves **versioned pulls**: the reply
    carries this shard's per-worker commit counts (the version vector)
    and plan epoch, captured atomically with the center."""

    def __init__(self, ps, plan: ShardPlan, shard_index: int, **kw):
        super().__init__(ps, **kw)
        self.plan = plan
        self.shard_index = int(shard_index)
        self.registry.gauge("ps.shard.index").set(self.shard_index)

    def shard_descriptor(self) -> dict:
        return {"index": self.shard_index, **self.plan.descriptor()}

    def hello_reply(self, msg: dict, ver: int) -> dict:
        reply = super().hello_reply(msg, ver)
        reply["shard"] = self.shard_descriptor()
        return reply

    def _pull_state(self):
        center, updates, vv = self.ps.pull_versioned()
        return center, updates, {"vv": vv, "shard": self.shard_index,
                                 "plan_epoch": self.plan.epoch}

    def handle_request(self, action, msg, ver, conn):
        if action == "plan":
            return {"ok": True, "shard": self.shard_descriptor(),
                    "plan": self.plan.doc()}
        reply = super().handle_request(action, msg, ver, conn)
        if action == "stats" and isinstance(reply, dict):
            reply["shard"] = self.shard_descriptor()
        return reply


class _MergedRegistryView:
    """Read-only merged view over the shard registries — the
    ``.snapshot()`` surface the runner persists (counters and histograms
    sum across shards; each shard's own ``stats`` RPC stays exact)."""

    def __init__(self, servers: List[ShardFrontend]):
        self._servers = servers

    def snapshot(self) -> dict:
        return Registry.merge_snapshots(
            *[s.registry.snapshot() for s in self._servers])


class ShardedParameterServer:
    """N single-shard servers and the supervisor-facing facade.

    ``ps_factory(center_slice, num_workers=...)`` builds each shard's
    update-rule server (the trainer's ``_ps_factory()`` unchanged — a
    shard's slice is a valid tree)."""

    def __init__(self, center: Tree, num_shards: int,
                 ps_factory: Callable[..., Any], num_workers: int = 1,
                 host: str = "127.0.0.1",
                 epoch: int = 0, fault_injector=None,
                 tracer_factory: Optional[Callable[[Registry], Any]] = None):
        self.plan = ShardPlan.build(center, num_shards, epoch=epoch)
        self.host = host
        slices = self.plan.split(center)
        self.shards = [ps_factory(slices[i], num_workers=num_workers)
                       for i in range(num_shards)]
        self.servers = [
            ShardFrontend(self.shards[i], self.plan, i, host=host,
                          fault_injector=fault_injector,
                          tracer=tracer_factory(self.shards[i].registry)
                          if tracer_factory is not None else None)
            for i in range(num_shards)]
        self.num_workers = int(num_workers)
        self.registry = _MergedRegistryView(self.servers)
        #: facade generation mirror (read under ``mutex`` like a plain
        #: ParameterServer's)
        self.mutex = threading.Lock()
        self.generations: dict = {}
        self._stopping = False

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "ShardedParameterServer":
        for s in self.servers:
            s.start()
        return self

    def stop(self) -> None:
        self._stopping = True
        for s in self.servers:
            s.stop()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    @property
    def ports(self) -> List[int]:
        return [s.port for s in self.servers]

    def addrs(self) -> List[Tuple[str, int]]:
        return [(self.host, s.port) for s in self.servers]

    # -- health: a dead shard is fatal, by name -----------------------------
    def _dead_reason(self, srv: ShardFrontend) -> Optional[str]:
        if not srv._running.is_set():
            return "stopped"
        if srv._sock is None or srv._sock.fileno() < 0:
            return "listener closed"
        with srv._conn_lock:
            accept = srv._threads[0] if srv._threads else None
        if accept is not None and not accept.is_alive():
            return "accept loop died"
        return None

    def raise_if_unhealthy(self) -> None:
        """Raise :class:`ShardFleetError` naming any dead shard (index,
        address, last commit counter) — the supervisor polls this, so a
        vanished shard fails the run at once, with a diagnosis."""
        if self._stopping:
            return
        for i, srv in enumerate(self.servers):
            reason = self._dead_reason(srv)
            if reason is not None:
                raise ShardFleetError(
                    f"ps shard {i}/{self.plan.num_shards} "
                    f"({self.host}:{srv.port}) is dead ({reason}); its "
                    f"last commit counter was {self.shards[i].num_updates} "
                    "— there is no shard failover, treating this as a "
                    "fatal fleet error")

    # -- supervisor-facing ParameterServer surface --------------------------
    @property
    def num_updates(self) -> int:
        """Logical update count: every logical commit lands once per
        shard; the max is the in-flight edge."""
        return max((ps.num_updates for ps in self.shards), default=0)

    @property
    def commits_by_worker(self) -> dict:
        """Element-wise MIN across shards — the fully-committed prefix
        (a commit counts once every shard has applied it)."""
        out: dict = {}
        for ps in self.shards:
            with ps.mutex:
                counts = dict(ps.commits_by_worker)
            for w, c in counts.items():
                out[w] = c if w not in out else min(out[w], c)
        return out

    def evict_worker(self, worker_id) -> int:
        """Fan the eviction to every shard (each tombstones the zombie's
        late commits on its own); returns the fully-committed window
        (element-wise MIN: a commit the sweep caught on only some shards
        is replayed by the respawn, at-least-once, not lost)."""
        w = int(worker_id)
        window = None
        for ps in self.shards:
            win = ps.evict_worker(w)
            window = win if window is None else min(window, win)
        with self.mutex:
            self.generations[w] = self.generations.get(w, 0) + 1
        return window or 0

    def register_respawn(self, worker_id) -> tuple:
        w = int(worker_id)
        window, gen = None, 0
        for ps in self.shards:
            win, g = ps.register_respawn(w)
            window = win if window is None else min(window, win)
            gen = max(gen, g)
        return (window or 0, gen)

    def register_join(self, worker_id) -> tuple:
        w = int(worker_id)
        window, gen = None, 0
        for ps in self.shards:
            win, g = ps.register_join(w)
            window = win if window is None else min(window, win)
            gen = max(gen, g)
        return (window or 0, gen)

    def get_model(self) -> Tree:
        """The full center from every shard's slice, each read under its
        own mutex: exact at rest, a best-effort snapshot mid-run (workers
        use the consistent-cut client pull instead)."""
        return self.plan.assemble(*[ps.get_model() for ps in self.shards])

    def last_seen_age(self, worker_id) -> Optional[float]:
        """Freshest traffic from this worker across all shards."""
        ages = [srv.last_seen_age(worker_id) for srv in self.servers]
        ages = [a for a in ages if a is not None]
        return min(ages) if ages else None

    # -- telemetry ----------------------------------------------------------
    def stats(self) -> dict:
        """Merged stats document and per-shard balance."""
        per_shard = []
        for i, (ps, srv) in enumerate(zip(self.shards, self.servers)):
            snap = ps.registry.snapshot()
            per_shard.append({
                "shard": i, "port": srv.port,
                "num_updates": ps.num_updates,
                "commits": snap.get("ps.commits", {}).get("value", 0),
                "bytes_sent": snap.get("net.bytes_sent", {}).get("value", 0),
                "bytes_recv": snap.get("net.bytes_recv", {}).get("value", 0),
            })
        return {"stats": self.registry.snapshot(),
                "num_updates": self.num_updates,
                "commits_by_worker": self.commits_by_worker,
                "server": type(self).__name__,
                "num_workers": self.num_workers,
                "plan": self.plan.descriptor(),
                "shards": per_shard}

    def write_plan(self, path: str) -> None:
        """Write the plan file (addresses included) — the hand-off for
        out-of-process clients and ``scripts/obsview.py --ps``."""
        with open(path, "w") as f:
            json.dump(self.plan.doc(addresses=self.addrs()), f, indent=1)


def _shard_env() -> dict:
    """A shard process's environment: the repo root on ``PYTHONPATH``
    and no card visible — a shard is host code and never
    opens a CUDA context."""
    env = repo_env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


class ProcessShardFleet:
    """One shard-server OS process per shard
    (``python -m distkeras_tpu_torch.ps.shard.shard_main SPEC``), so the
    shards stop sharing one interpreter's GIL.  Exposes ``addrs()`` /
    ``plan`` / ``stop()`` like :class:`ShardedParameterServer`; workers
    connect with the same ``ShardedPSClient``.  The processes are polled
    over the wire (``stats``) and are not supervisor-integrated."""

    def __init__(self, center: Any, num_shards: int,
                 ps_class: str = "delta", num_workers: int = 1,
                 host: str = "127.0.0.1", epoch: int = 0):
        from ...utils import serde
        self.plan = ShardPlan.build(center, num_shards, epoch=epoch)
        self.host = host
        self._td = tempfile.TemporaryDirectory(prefix="dktpu-shards-")
        blob = serde.tree_to_bytes(center)
        env = _shard_env()
        self.procs: List[subprocess.Popen] = []
        port_files = []
        for i in range(num_shards):
            spec = {"center_blob": blob, "num_shards": int(num_shards),
                    "shard_index": i, "epoch": int(epoch),
                    "ps_class": ps_class, "num_workers": int(num_workers),
                    "host": host, "port": 0, "device": "cpu",
                    "port_file": os.path.join(self._td.name, f"port_{i}")}
            spec_path = os.path.join(self._td.name, f"shard_{i}.spec")
            with open(spec_path, "wb") as f:
                f.write(serde.tree_to_bytes(spec))
            port_files.append(spec["port_file"])
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "distkeras_tpu_torch.ps.shard.shard_main", spec_path],
                env=env))
        self.ports: List[int] = []
        deadline = time.monotonic() + START_TIMEOUT_S
        for i, pf in enumerate(port_files):
            while not os.path.exists(pf):
                if self.procs[i].poll() is not None:
                    self.stop()
                    raise RuntimeError(
                        f"shard process {i} exited rc="
                        f"{self.procs[i].returncode} before binding")
                if time.monotonic() > deadline:
                    self.stop()
                    raise RuntimeError(
                        f"shard process {i} did not bind within "
                        f"{START_TIMEOUT_S:.0f}s")
                time.sleep(0.02)
            with open(pf) as f:
                self.ports.append(int(f.read()))

    def addrs(self) -> List[Tuple[str, int]]:
        return [(self.host, p) for p in self.ports]

    def stop(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            if p.poll() is None:
                p.wait()
        self._td.cleanup()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
