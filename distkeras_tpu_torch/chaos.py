"""Chaos harness — fault injection for the self-healing fleet (the port of
``distkeras_tpu.chaos``).

The reference inherited fault tolerance from Spark and never tested it;
the PS stack *implements* detect → down-weight → evict →
respawn (``ps.runner.FleetSupervisor``), so it needs a way to create the
faults on demand.  Three fault families, matching the three boundaries a
real fleet dies at:

* **process faults** — :func:`kill_worker` (SIGKILL: the OOM-killer /
  preempted-VM shape), :func:`pause_worker` / :func:`resume_worker`
  (SIGSTOP/SIGCONT: the wedged-but-alive shape).  For the
  ``async_workers="processes"`` placement, whose incarnations are real
  OS processes (``ps.worker_main``).
* **thread faults** — :class:`ThreadStall`, the in-process analogue of
  SIGSTOP for the ``threads`` placement (a single thread cannot be
  signal-stopped): the targeted worker's window call blocks on an event
  until :meth:`ThreadStall.resume`, exactly reproducing the
  wedged-but-alive liveness signature (pulls and commits stop reaching
  the PS while the thread stays alive).
* **socket faults** — :class:`SocketFaults`, a deterministic schedule of
  connection resets / timeouts injected through the process-wide seam in
  ``ps.networking`` (``set_fault_hook``) at the wire's choke points: the
  dial, the v1/v2 hello negotiation, and per-action sends (the commit
  path) / receives.

Every injector is a context manager that restores the world on exit;
the tests assert the fleet completes under each fault with exact commit
accounting (``requests == applied + dropped + tombstoned``).
"""

from __future__ import annotations

import os
import signal
import socket
import threading
from typing import Dict, Optional, Sequence

from .obs.logging import get_logger
from .ps import networking

_LOG = "chaos"


# ---------------------------------------------------------------------------
# process faults (the "processes" worker placement)
# ---------------------------------------------------------------------------

def _pid(proc_or_pid) -> int:
    return int(getattr(proc_or_pid, "pid", proc_or_pid))


def kill_worker(proc_or_pid) -> int:
    """SIGKILL a worker process (no cleanup, no goodbye — the OOM-killer
    shape).  Accepts a ``subprocess.Popen`` or a raw pid; returns the
    pid."""
    pid = _pid(proc_or_pid)
    get_logger(_LOG).warning("kill -9 worker process %d", pid)
    os.kill(pid, signal.SIGKILL)
    return pid


def pause_worker(proc_or_pid) -> int:
    """SIGSTOP a worker process: alive to the OS, dead to the fleet —
    the liveness signature the supervisor's heartbeat hard threshold
    exists to catch."""
    pid = _pid(proc_or_pid)
    get_logger(_LOG).warning("SIGSTOP worker process %d", pid)
    os.kill(pid, signal.SIGSTOP)
    return pid


def resume_worker(proc_or_pid) -> int:
    """SIGCONT a paused worker process.  By the time this runs the
    supervisor has typically evicted + replaced it — the revenant's next
    commit tombstones and it winds down cleanly."""
    pid = _pid(proc_or_pid)
    get_logger(_LOG).warning("SIGCONT worker process %d", pid)
    os.kill(pid, signal.SIGCONT)
    return pid


# ---------------------------------------------------------------------------
# thread faults (the "threads" worker placement)
# ---------------------------------------------------------------------------

class ThreadStall:
    """Virtual SIGSTOP for one thread-placement worker.

    Patches ``worker_cls._window`` so the targeted ``worker_id``'s
    incarnation at ``generation`` blocks on an internal event once it has
    completed ``stall_after`` windows — commits and pulls stop reaching
    the PS while the thread stays alive, the exact signature of a
    process SIGSTOP.  :meth:`resume` lifts the stall (the SIGCONT); the
    context manager restores the original ``_window`` on exit.

    The generation gate means the supervisor's replacement (which runs
    at the bumped generation) sails through untouched — only the
    incarnation the chaos targeted is wedged.
    """

    def __init__(self, worker_cls, worker_id: int, stall_after: int = 1,
                 generation: int = 0):
        self._cls = worker_cls
        self._orig = worker_cls._window
        self.worker_id = int(worker_id)
        self.stall_after = int(stall_after)
        self.generation = int(generation)
        self._resume_evt = threading.Event()
        self._stalled_evt = threading.Event()

    def __enter__(self) -> "ThreadStall":
        stall = self

        def stalled_window(wself, client, wx, wy):
            if (wself.worker_id == stall.worker_id
                    and wself.generation == stall.generation
                    and len(wself.window_losses) >= stall.stall_after
                    and not stall._resume_evt.is_set()):
                get_logger(_LOG).warning(
                    "stalling worker %d (thread) after %d windows",
                    wself.worker_id, len(wself.window_losses))
                stall._stalled_evt.set()
                stall._resume_evt.wait()
            return stall._orig(wself, client, wx, wy)

        self._cls._window = stalled_window
        return self

    def __exit__(self, *exc) -> None:
        self._cls._window = self._orig
        self._resume_evt.set()  # never leave a thread wedged past the test

    def wait_stalled(self, timeout: Optional[float] = None) -> bool:
        """Block until the target actually wedged (it hit the stall
        point); the chaos equivalent of watching ``ps`` say ``T``."""
        return self._stalled_evt.wait(timeout)

    def resume(self) -> None:
        """The SIGCONT: let the wedged incarnation run again (straight
        into its tombstoned commit, if the supervisor already replaced
        it)."""
        get_logger(_LOG).warning("resuming stalled worker %d (thread)",
                                 self.worker_id)
        self._resume_evt.set()


# ---------------------------------------------------------------------------
# socket faults (the v1/v2 negotiation and commit wire paths)
# ---------------------------------------------------------------------------

class SocketFaults:
    """Deterministic socket-fault schedule over ``ps.networking``'s
    fault seam.

    ``schedule`` maps a stage key to the 1-based call ordinals that
    fault.  Keys are the seam's stages — ``"connect"``, ``"handshake"``,
    ``"recv"`` — plus action-qualified sends: ``"send:commit"`` faults
    only commit sends, ``"send"`` faults every send.  Ordinals count per
    key, so ``{"send:commit": [3]}`` resets exactly the third commit any
    connection in this process attempts.

    ``kind`` picks the exception: ``"reset"`` (ConnectionResetError) or
    ``"timeout"`` (socket.timeout) — both travel the same OSError paths
    real kernels produce.  Thread-safe; counts and injections are
    inspectable (``calls``, ``injected``).  The context manager installs
    the hook on entry and restores the previous hook on exit.
    """

    def __init__(self, schedule: Dict[str, Sequence[int]],
                 kind: str = "reset"):
        if kind not in ("reset", "timeout"):
            raise ValueError(f"kind must be 'reset' or 'timeout', got "
                             f"{kind!r}")
        self.schedule = {str(k): set(int(i) for i in v)
                         for k, v in schedule.items()}
        self.kind = kind
        self.calls: Dict[str, int] = {}
        self.injected = 0
        self._lock = threading.Lock()
        self._prev = None
        self._installed = False

    def _raise(self, key: str, n: int):
        get_logger(_LOG).warning("injecting socket %s at %s call %d",
                                 self.kind, key, n)
        if self.kind == "timeout":
            raise socket.timeout(f"chaos: injected timeout ({key} #{n})")
        raise ConnectionResetError(f"chaos: injected reset ({key} #{n})")

    def __call__(self, stage: str, action=None) -> None:
        keys = [stage]
        if action is not None:
            keys.append(f"{stage}:{action}")
        fire = None
        with self._lock:
            for key in keys:
                if key not in self.schedule:
                    continue
                n = self.calls.get(key, 0) + 1
                self.calls[key] = n
                if n in self.schedule[key]:
                    self.injected += 1
                    fire = (key, n)
        if fire is not None:
            self._raise(*fire)

    def __enter__(self) -> "SocketFaults":
        self._prev = networking.set_fault_hook(self)
        self._installed = True
        return self

    def __exit__(self, *exc) -> None:
        if self._installed:
            networking.set_fault_hook(self._prev)
            self._installed = False
