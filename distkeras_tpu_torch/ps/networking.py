"""TCP message layer — the port of ``distkeras_tpu.ps.networking``, with
the same bytes on the wire (parity with reference
``distkeras/networking.py``: ``determine_host_address``, ``connect``,
send/recv of whole messages).  The reference pickles arbitrary objects;
this wire frames **msgpack** blobs, written by the port's own codec
(``utils._msgpack`` through ``utils.serde``).

Frame formats, auto-detected per message by ``recv_msg``:

* **v1**: ``>Q`` length prefix + one self-contained msgpack blob
  (``serde.tree_to_bytes``).  The format old peers speak.
* **v2**: ``b"DKW2"`` magic + segment count + length table, then the
  msgpack header and the raw tensor **segments** (``serde.tree_to_frames``)
  sent scatter-gather via ``socket.sendmsg``; the receiver reads each
  segment into its own buffer (``recv_into``) and wraps it zero-copy.
* **DKW3** (same-host shared memory): the client creates two
  ``multiprocessing.shared_memory`` rings and names them in its hello; a
  server that can attach them acks, and from then on v2 messages travel
  as a ``DKW3`` control frame over TCP (header + length table + ring
  offset) with the tensor segments in the ring.  A message too big for
  the ring falls back to the TCP frame.  The ring owner (the client)
  unlinks on close; attachments just close.
* **DKW4** (streamed pull replies): an announce frame (magic + chunk
  count), one **prologue** (the reply with every tensor leaf replaced by
  an index stub, and each chunk's exact frame size) and N **chunk**
  frames, each a bounded leaf group in tree order.  The receiver reads
  each chunk with one ``recv_into`` into a slice of a pooled per-pull
  arena and decodes it while the next is on the wire.  Streaming is
  negotiated in the hello (``stream`` extra; ``stream=False`` pins
  either end to monolithic replies) and requested per pull.

Which format a peer may send is negotiated once per connection by the
``hello`` handshake (``client_handshake`` / ``FrameServer``).  Protocol
extensions ride as extra keys in the msgpack map (``trace``, ``gap_s``,
``gen``, ``down``, ``stream``, ``shm``), never as frame changes: every
parser of this wire ignores unknown keys.  ``set_fault_hook`` is the
process-wide seam the chaos harness (``distkeras_tpu_torch.chaos``)
injects socket resets and timeouts through.

Instrumented: every framed send/recv counts messages and wire bytes
(frame header included) into an ``obs.Registry`` — the component's own
when the caller passes one, the process-wide default otherwise — plus a
direction-tagged counter when the caller names one (``ps.wire.bytes_up``
/ ``ps.wire.bytes_down``); ring-borne segment bytes also count under
``net.bytes_shm``.
"""

from __future__ import annotations

import os
import socket
import struct
import sys
import threading
import time
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from ..obs import default_registry
from ..obs.logging import get_logger
from ..utils import serde

_LEN = struct.Struct(">Q")
_MAGIC2 = b"DKW2"
_MAGIC3 = b"DKW3"  # shm data plane: control frame on TCP, segments in the ring
_MAGIC4 = b"DKW4"  # streamed pull reply: announce + prologue + chunk frames
_V2HEAD = struct.Struct(">4sI")  # magic + segment count

#: newest frame format this build speaks; the hello handshake negotiates
#: min(client, server) per connection
WIRE_VERSION = 2

#: max buffers per sendmsg call (stay well under any platform IOV_MAX)
_IOV_CHUNK = 256


def repo_env() -> dict:
    """This process's environment with the repo root on ``PYTHONPATH`` —
    what a PS child process (a worker or a shard, started as
    ``python -m distkeras_tpu_torch...``) needs to import the package."""
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    return env


# ---------------------------------------------------------------------------
# fault-injection seam (the chaos harness's socket-level hook)
# ---------------------------------------------------------------------------

#: process-wide chaos hook (``distkeras_tpu_torch.chaos.SocketFaults`` installs
#: one): called at the wire's choke points — ``("connect", None)`` before
#: each dial, ``("handshake", None)`` entering the v1/v2 negotiation,
#: ``("send", action)`` / ``("recv", None)`` around each framed message —
#: and *raises* (ConnectionResetError, socket.timeout, ...) to inject the
#: fault.  None (the default) costs one global read per message.
_fault_hook = None


def set_fault_hook(hook):
    """Install (or clear, with None) the socket fault-injection hook;
    returns the previous hook so chaos harnesses can nest/restore."""
    global _fault_hook
    prev = _fault_hook
    _fault_hook = hook
    return prev


def _inject_fault(stage: str, action=None) -> None:
    hook = _fault_hook
    if hook is not None:
        hook(stage, action)


def backoff_delays(attempts: int, base: float = 0.1, cap: float = 2.0,
                   jitter: float = 0.25):
    """Capped exponential backoff with ±``jitter`` randomization — the
    retry pacing both reconnect paths share (a fleet
    of workers re-dialing a restarted PS in lockstep is a thundering
    herd; jitter de-synchronizes them).  Yields ``attempts - 1`` sleep
    durations (one per gap between attempts)."""
    import random
    d = float(base)
    for _ in range(max(0, int(attempts) - 1)):
        yield d * (1.0 + random.uniform(-jitter, jitter))
        d = min(d * 2.0, float(cap))


def retry_with_backoff(attempt, attempts: int, base: float, cap: float,
                       on_failure, what: str, log_channel: str):
    """Run ``attempt()`` up to ``attempts`` times with
    :func:`backoff_delays` pacing — the one reconnect loop ``PSClient``
    and ``ServeClient`` share.  ``on_failure()`` is called on EVERY
    failed attempt (the reconnect-failure counters); the final failure
    re-raises.  Returns ``attempt()``'s result."""
    delays = backoff_delays(attempts, base=base, cap=cap)
    for delay in [*delays, None]:
        try:
            return attempt()
        except (ConnectionError, OSError) as e:
            on_failure()
            if delay is None:
                raise
            get_logger(log_channel).warning(
                "%s failed (%s); retrying in %.2fs", what, e, delay)
            time.sleep(delay)


# ---------------------------------------------------------------------------
# streamed pull replies (the DKW4 frame)
# ---------------------------------------------------------------------------

#: default per-chunk tensor-payload bound for streamed pulls; a client
#: may request another bound in its hello/pull (one oversized leaf is
#: its own chunk — the bound caps chunk memory, not leaf size)
STREAM_CHUNK_BYTES = 1 << 20

#: floor on a peer-requested chunk bound: a hostile 1-byte request must
#: not turn a pull into thousands of per-leaf frames
MIN_STREAM_CHUNK_BYTES = 64 * 1024


_STREAM_LEAF = "__dkstream__"


def stream_split(doc: Any, chunk_bytes: int) -> Tuple[Any, List[tuple]]:
    """``(skeleton, groups)`` for one reply document: every non-empty
    ndarray (or tensor: a decoded bfloat16 leaf) is replaced by an ``{_STREAM_LEAF: i}`` index stub, and
    ``groups`` is a list of ``(first_leaf_index, [arrays])`` with each
    group's payload bounded by ``chunk_bytes``.  Leaves stay in tree
    (= plan) order, so the receiver can place group k's arrays by index
    without waiting for the rest.  Empty arrays and non-tensor values
    stay inline in the skeleton — they cost nothing to ship there."""
    leaves: List[Any] = []

    def strip(obj):
        if serde._is_leaf(obj) and obj.nbytes:
            leaves.append(obj)
            return {_STREAM_LEAF: len(leaves) - 1}
        if isinstance(obj, dict):
            return {k: strip(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return [strip(v) for v in obj]
        return obj

    skeleton = strip(doc)
    bound = max(1, int(chunk_bytes))
    groups: List[tuple] = []
    cur: List[Any] = []
    cur_bytes, start = 0, 0
    for i, a in enumerate(leaves):
        if cur and cur_bytes + a.nbytes > bound:
            groups.append((start, cur))
            cur, cur_bytes, start = [], 0, i
        cur.append(a)
        cur_bytes += a.nbytes
    if cur:
        groups.append((start, cur))
    return skeleton, groups


def pack_stream(doc: Any, chunk_bytes: int,
                version: int = 2) -> List[Tuple[List[Any], int]]:
    """Pre-serialize one streamed pull reply: ``[prologue, chunk_0,
    ...]`` as :func:`pack_msg` payloads (the pull cache's unit).  The
    prologue is self-describing — skeleton, leaf count, and each chunk's
    exact FRAME size (``frame_bytes``) so the receiver can read a whole
    chunk frame with one big ``recv_into`` into one preallocated buffer
    and decode the leaves as zero-copy views over it; each chunk carries
    its first leaf index, so any placement mistake is detected at
    assembly, never decoded wrong."""
    skeleton, groups = stream_split(doc, chunk_bytes)
    nleaves = sum(len(arrs) for _, arrs in groups)
    chunks = [pack_msg({"chunk": k, "i0": start, "leaves": arrs},
                       version=version)
              for k, (start, arrs) in enumerate(groups)]
    prologue = {"stream": 1, "nchunks": len(groups), "nleaves": nleaves,
                "frame_bytes": [total for _, total in chunks],
                "skeleton": skeleton}
    return [pack_msg(prologue, version=version)] + chunks


def stream_join(skeleton: Any, leaves: List[Any]) -> Any:
    """Inverse of :func:`stream_split`: the skeleton with every index
    stub replaced by its received leaf."""

    def fill(obj):
        if isinstance(obj, dict):
            if _STREAM_LEAF in obj:
                return leaves[obj[_STREAM_LEAF]]
            return {k: fill(v) for k, v in obj.items()}
        if isinstance(obj, list):
            return [fill(v) for v in obj]
        return obj

    return fill(skeleton)


def determine_host_address() -> str:
    """Routable local IP via the UDP-connect trick (parity: reference
    ``distkeras/networking.py:determine_host_address``)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect(("8.8.8.8", 80))
        return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"
    finally:
        s.close()


def connect(host: str, port: int, timeout: Optional[float] = 30.0,
            retries: int = 20, retry_delay: float = 0.1) -> socket.socket:
    """Connect with retries (the PS thread may not be listening yet —
    the reference relied on Spark task startup latency to hide this)."""
    last = None
    reg = default_registry()
    for _ in range(max(1, retries)):
        try:
            _inject_fault("connect")
            s = socket.create_connection((host, port), timeout=timeout)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            reg.counter("net.connects").inc()
            return s
        except OSError as e:
            last = e
            reg.counter("net.connect_retries").inc()
            time.sleep(retry_delay)
    raise ConnectionError(f"cannot connect to {host}:{port}: {last}")


# ---------------------------------------------------------------------------
# hello negotiation (the seam the PS stack and the serve stack
# share — one definition of "which frame format may this connection use")
# ---------------------------------------------------------------------------

def choose_wire_version(offered: Optional[Sequence[int]],
                        max_wire_version: int = WIRE_VERSION) -> int:
    """Server side of the hello handshake: the newest offered format this
    end also speaks (1 when nothing admissible was offered — v1 is the
    frozen floor every peer parses)."""
    versions = [int(v) for v in (offered or [1])]
    return max(v for v in versions + [1] if v <= int(max_wire_version))


def client_handshake(sock: socket.socket, registry=None,
                     worker_id: Optional[int] = None,
                     want: Optional[int] = None,
                     info: Optional[dict] = None,
                     extras: Optional[dict] = None) -> int:
    """Client side of the hello handshake; returns the negotiated wire
    version for this connection.  The hello itself is always v1-framed
    (any server parses it); current servers answer with the agreed
    version, old ones with an unknown-action error — that failure IS the
    negotiation result: v1.

    ``info``, when given, is updated in place with the server's full
    hello reply — the channel for negotiation-time extras like a shard
    front-end's placement descriptor; old servers' replies
    simply carry no extra keys.  ``extras`` rides in the hello REQUEST
    the same way (the DOWN-codec advertisement and the shm
    ring names) — included only when the caller opted in, so the default
    hello stays byte-identical to previous builds."""
    want = WIRE_VERSION if want is None else int(want)
    if want < 2:
        return 1
    _inject_fault("handshake")
    msg: dict = {"action": "hello", "versions": list(range(1, want + 1))}
    if worker_id is not None:
        msg["worker_id"] = int(worker_id)
    if extras:
        msg.update(extras)
    send_msg(sock, msg, registry=registry)
    resp = recv_msg(sock, registry=registry)
    if info is not None and isinstance(resp, dict):
        info.update(resp)
    if resp.get("ok"):
        return int(resp.get("version", 1))
    return 1


# ---------------------------------------------------------------------------
# same-host shared-memory data plane
# ---------------------------------------------------------------------------

#: default ring capacity; a message whose segments exceed the ring falls
#: back to the TCP frame for that message, so this bounds memory, not
#: message size
SHM_RING_MB = 64.0


def shm_ring_mb() -> float:
    """The ring capacity a new client offers: ``DKTPU_SHM_MB`` as it is
    set when the client connects (default ``SHM_RING_MB``'s 64), so a
    process can size the rings to a center larger than the default
    before it starts a run."""
    return float(os.environ.get("DKTPU_SHM_MB", SHM_RING_MB))


class ShmRing:
    """One-direction tensor-segment ring over a
    ``multiprocessing.shared_memory`` segment.

    The TCP connection stays the control plane and strictly orders use:
    the writer copies a message's segments into the ring BEFORE sending
    the ``DKW3`` control frame, the reader copies them out after
    receiving it, and the request/reply protocol allows one outstanding
    message per connection — so a write can never overtake an unread
    message.  Lifecycle: the CREATING end owns the segment and must
    ``unlink()`` it on its shutdown path; attaching ends just
    ``close()``."""

    def __init__(self, shm, owner: bool):
        self._shm = shm
        self.owner = owner
        self.name = shm.name
        self.size = shm.size
        self._pos = 0

    @classmethod
    def create(cls, size: int) -> "ShmRing":
        from multiprocessing import shared_memory
        return cls(shared_memory.SharedMemory(create=True, size=int(size)),
                   owner=True)

    @classmethod
    def attach(cls, name: str) -> "ShmRing":
        from multiprocessing import shared_memory
        shm = shared_memory.SharedMemory(name=str(name))
        try:
            # the attaching end must NOT own cleanup: unregister it from
            # this process's resource tracker or interpreter shutdown
            # "reclaims" (unlinks) a segment the creator still owns
            from multiprocessing import resource_tracker
            resource_tracker.unregister(shm._name, "shared_memory")
        except (ImportError, AttributeError, KeyError):
            pass
        return cls(shm, owner=False)

    def write(self, views: list) -> Optional[int]:
        """Copy ``views`` contiguously into the ring; returns the start
        offset, or None when they cannot fit (caller falls back to the
        TCP frame for this message)."""
        total = sum(v.nbytes for v in views)
        if total > self.size:
            return None
        if self._pos + total > self.size:
            self._pos = 0  # wrap: the previous message was already read
        off = self._pos
        buf = self._shm.buf
        pos = off
        for v in views:
            buf[pos:pos + v.nbytes] = v
            pos += v.nbytes
        self._pos = pos
        return off

    def stream_begin(self, total: int) -> bool:
        """Start a multi-frame streamed reply: reset the write
        cursor to 0 — safe because the strict request/reply ordering
        means every prior message was already read — so the stream's
        sequential chunk writes never wrap mid-stream and a later chunk
        can never overwrite an unread earlier one (per-chunk
        :meth:`write` wrapping assumes ONE unread message, which a
        multi-frame stream is not).  Returns False when ``total`` exceeds
        the ring: the caller must keep the whole stream on TCP."""
        if total > self.size:
            return False
        self._pos = 0
        return True

    def read(self, offset: int, lens: List[int]) -> List[bytearray]:
        """Copy ``lens``-sized segments out of the ring starting at
        ``offset`` — copies, so the writer's next message can never
        mutate a tensor this one decoded."""
        end = offset + sum(lens)
        if offset < 0 or end > self.size:
            raise ConnectionError(
                f"shm frame outside the ring ({offset}..{end} of "
                f"{self.size} bytes)")
        out, pos = [], int(offset)
        view = self._shm.buf
        for n in lens:
            out.append(bytearray(view[pos:pos + n]))
            pos += n
        return out

    def close(self) -> None:
        try:
            self._shm.close()
        except (OSError, BufferError):
            pass

    def unlink(self) -> None:
        try:
            # thread-placed peers attach in the CREATOR's process, and
            # the attach-side unregister removed this process's tracker
            # entry; re-register (idempotent set add) so the unregister
            # inside SharedMemory.unlink balances instead of raising
            # KeyError noise in the tracker at interpreter exit
            from multiprocessing import resource_tracker
            resource_tracker.register(self._shm._name, "shared_memory")
        except (ImportError, AttributeError):
            pass
        try:
            self._shm.unlink()
        except (OSError, FileNotFoundError):
            pass


class ShmChannel:
    """A negotiated connection: TCP control socket + one ring per
    direction.  Passed anywhere a socket goes (``send_msg`` /
    ``send_packed`` / ``recv_msg`` unwrap it); v2 payloads whose
    segments fit ride the ring, everything else (v1 frames, oversized
    messages) uses the socket unchanged."""

    def __init__(self, sock: socket.socket, tx: ShmRing, rx: ShmRing):
        self.sock = sock
        self.tx = tx
        self.rx = rx

    @classmethod
    def serve_attach(cls, sock: socket.socket, spec: dict) -> "ShmChannel":
        """Server side: attach the client-created rings named in the
        hello's ``shm`` spec.  Failure to attach (different host, dead
        segment) raises — the capability probe that IS the same-host
        check."""
        rx = ShmRing.attach(spec["c2s"])
        try:
            tx = ShmRing.attach(spec["s2c"])
        except BaseException:
            rx.close()
            raise
        return cls(sock, tx=tx, rx=rx)

    def close_rings(self, unlink: bool = False) -> None:
        """Release both ring attachments; ``unlink=True`` additionally
        destroys owned segments (the creating end's shutdown path)."""
        for ring in (self.tx, self.rx):
            if unlink and ring.owner:
                ring.unlink()
            ring.close()


def _chan_parts(chan) -> Tuple[socket.socket, Optional[ShmChannel]]:
    if isinstance(chan, ShmChannel):
        return chan.sock, chan
    return chan, None


def _count_wire(reg, sent: bool, nbytes: int,
                count_as: Optional[str], msgs: int = 1) -> None:
    """One message's byte accounting: the aggregate ``net.*`` totals plus
    the direction-tagged counter when the caller named one.
    ``msgs=0`` counts bytes only — a streamed reply's frames are ONE
    logical message however many chunks carried it, so the
    historical request/reply message-count invariants keep holding."""
    if sent:
        reg.counter("net.msgs_sent").inc(msgs)
        reg.counter("net.bytes_sent").inc(nbytes)
    else:
        reg.counter("net.msgs_recv").inc(msgs)
        reg.counter("net.bytes_recv").inc(nbytes)
    if count_as is not None:
        reg.counter(count_as).inc(nbytes)


# ---------------------------------------------------------------------------
# send path
# ---------------------------------------------------------------------------

def _flat_view(buf: Any) -> memoryview:
    """Any buffer-protocol object -> flat byte view (0-d ndarrays cannot
    cast directly; go through their 1-element reshape.  Empty multi-dim
    views cannot cast either — memoryview refuses zeros in shape — and
    carry no bytes anyway)."""
    v = memoryview(buf)
    if v.nbytes == 0:
        return memoryview(b"")
    if v.ndim == 0:
        v = memoryview(buf.reshape(1))
    return v.cast("B")


def _sendmsg_all(sock: socket.socket, bufs: List[Any]) -> None:
    """Scatter-gather send of every buffer, partial sends handled.  Falls
    back to per-buffer ``sendall`` where ``sendmsg`` is unavailable."""
    views = [v for v in (_flat_view(b) for b in bufs) if v.nbytes]
    if not hasattr(sock, "sendmsg"):
        for v in views:
            sock.sendall(v)
        return
    while views:
        chunk = views[:_IOV_CHUNK]
        sent = sock.sendmsg(chunk)
        # drop fully-sent buffers, slice the partially-sent one
        while sent:
            if sent >= len(views[0]):
                sent -= len(views[0])
                views.pop(0)
            else:
                views[0] = views[0][sent:]
                sent = 0


def pack_msg(obj: Any, version: int = 1) -> Tuple[List[Any], int]:
    """Pre-serialize ``obj`` into ``(buffers, total_bytes)`` for repeated
    :func:`send_packed` calls — the PS pull-reply cache: the
    center is encoded ONCE per update, not once per pull.  v2 buffers hold
    zero-copy views of the tree's tensors, safe to cache because PS
    commits replace (never mutate) center arrays."""
    if version >= 2:
        header, segs = serde.tree_to_frames(obj)
        lens = [len(header)] + [memoryview(s).nbytes for s in segs]
        pre = _V2HEAD.pack(_MAGIC2, len(segs)) \
            + b"".join(_LEN.pack(n) for n in lens)
        bufs: List[Any] = [pre, header, *segs]
        return bufs, len(pre) + sum(lens)
    blob = serde.tree_to_bytes(obj)
    framed = _LEN.pack(len(blob)) + blob
    return [framed], len(framed)


def send_packed(sock: socket.socket, payload: Tuple[List[Any], int],
                registry=None, count_as: Optional[str] = None,
                count_msgs: int = 1) -> None:
    """Send a :func:`pack_msg` payload (counted like any message; the
    optional ``count_as`` counter gets the direction-tagged total).  On a
    negotiated :class:`ShmChannel`, v2 payloads whose segments fit the
    ring travel as a ``DKW3`` control frame + ring segments; anything
    else uses the TCP socket unchanged."""
    sock, shm = _chan_parts(sock)
    bufs, total = payload
    reg = registry if registry is not None else default_registry()
    if shm is not None and len(bufs) >= 2 and \
            bytes(bufs[0][:4]) == _MAGIC2:
        views = [_flat_view(b) for b in bufs[2:]]
        off = shm.tx.write(views)
        if off is not None:
            # control frame: v2 head with the shm magic + ring offset +
            # the original length table; segments already in the ring
            pre = memoryview(bufs[0])
            ctrl = _V2HEAD.pack(_MAGIC3, len(bufs) - 2) + _LEN.pack(off) \
                + bytes(pre[_V2HEAD.size:])
            _sendmsg_all(sock, [ctrl, bufs[1]])
            _count_wire(reg, True, total + _LEN.size, count_as,
                        msgs=count_msgs)
            reg.counter("net.bytes_shm").inc(sum(v.nbytes for v in views))
            return
    _sendmsg_all(sock, bufs)
    _count_wire(reg, True, total, count_as, msgs=count_msgs)


def send_msg(sock: socket.socket, obj: Any, registry=None,
             version: int = 1, count_as: Optional[str] = None) -> None:
    """One framed message (parity: reference ``send_data``).  ``version=2``
    uses the zero-copy scatter-gather frame; the peer must have negotiated
    v2 (its ``recv_msg`` auto-detects either way)."""
    _inject_fault("send", obj.get("action") if isinstance(obj, dict)
                  else None)
    send_packed(sock, pack_msg(obj, version=version), registry=registry,
                count_as=count_as)


def send_stream(chan, parts: List[Tuple[List[Any], int]], registry=None,
                count_as: Optional[str] = None,
                action: str = "pull_stream") -> None:
    """One ``DKW4`` streamed pull reply: an announce frame
    (magic + chunk count), then the prologue and each chunk as ordinary
    :func:`send_packed` frames — the receiver decodes chunk k while
    chunk k+1 is still in flight.  ``parts`` is the pre-packed
    ``[prologue, chunk_0, ...]`` list (the pull cache's unit).

    ``action`` names the stream for the chaos fault hook (the
    serve KV fabric streams ``kv_fetch`` replies over this same seam,
    and its faults must be addressable separately from PS pulls).

    On a negotiated :class:`ShmChannel` the chunks ride the ring only
    when the WHOLE stream fits at once (:meth:`ShmRing.stream_begin`);
    otherwise every frame of this reply stays on TCP — a per-chunk ring
    fallback could wrap onto an unread earlier chunk."""
    _inject_fault("send", action)
    sock, shm = _chan_parts(chan)
    reg = registry if registry is not None else default_registry()
    # however many frames carry it, a streamed reply is ONE message in
    # the net.* ledgers — the request/reply count invariants hold
    if shm is not None:
        total = sum(sum(_flat_view(b).nbytes for b in bufs[2:])
                    for bufs, _ in parts[1:]
                    if len(bufs) >= 2 and bytes(bufs[0][:4]) == _MAGIC2)
        if shm.tx.stream_begin(total):
            _sendmsg_all(sock, [_V2HEAD.pack(_MAGIC4, len(parts) - 1)])
            _count_wire(reg, True, _V2HEAD.size, count_as, msgs=1)
            for p in parts:
                send_packed(chan, p, registry=reg, count_as=count_as,
                            count_msgs=0)
            return
    # TCP: ONE scatter-gather send for announce + every frame — a
    # per-frame send would pay a sender/receiver scheduler round-trip
    # per chunk (measured ~1.5ms extra on a 4 MB loopback pull),
    # erasing the win streaming exists for
    bufs: List[Any] = [_V2HEAD.pack(_MAGIC4, len(parts) - 1)]
    total = _V2HEAD.size
    for p_bufs, p_total in parts:
        bufs.extend(p_bufs)
        total += p_total
    _sendmsg_all(sock, bufs)
    _count_wire(reg, True, total, count_as, msgs=1)


# ---------------------------------------------------------------------------
# recv path
# ---------------------------------------------------------------------------

def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ConnectionError("socket closed mid-message")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def _recv_exact_into(sock: socket.socket, view: memoryview) -> None:
    """Fill ``view`` from the socket — the segment read lands directly in
    the buffer the decoded ndarray will wrap (no join, no second copy)."""
    while view.nbytes:
        got = sock.recv_into(view)
        if not got:
            raise ConnectionError("socket closed mid-message")
        view = view[got:]


def recv_msg(sock: socket.socket, registry=None,
             count_as: Optional[str] = None) -> Any:
    """Recv-all loop for one framed message, v1/v2/shm auto-detected
    (parity: reference ``recv_data``)."""
    _inject_fault("recv")
    sock, shm = _chan_parts(sock)
    head = _recv_exact(sock, _LEN.size)
    reg = registry if registry is not None else default_registry()
    return _recv_framed(sock, shm, head, reg, count_as)


def _recv_framed(sock: socket.socket, shm, head: bytes, reg,
                 count_as: Optional[str], msgs: int = 1) -> Any:
    """Decode one framed message whose 8-byte head was already read.
    ``msgs=0``: count bytes only (a frame inside a streamed reply)."""
    if head[:4] == _MAGIC4:
        raise ConnectionError(
            "peer sent a streamed (DKW4) reply where a single message "
            "was expected — protocol desync")
    if head[:4] in (_MAGIC2, _MAGIC3):
        _, nseg = _V2HEAD.unpack(head)
        extra = 0
        if head[:4] == _MAGIC3:
            if shm is None:
                raise ConnectionError(
                    "peer sent a shm frame on a connection with no "
                    "negotiated shared-memory ring")
            (off,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
            extra = _LEN.size
        table = _recv_exact(sock, _LEN.size * (nseg + 1))
        lens = [_LEN.unpack_from(table, i * _LEN.size)[0]
                for i in range(nseg + 1)]
        header = _recv_exact(sock, lens[0])
        if head[:4] == _MAGIC3:
            segments = shm.rx.read(off, lens[1:])
            reg.counter("net.bytes_shm").inc(sum(lens[1:]))
        else:
            segments = []
            for n in lens[1:]:
                buf = bytearray(n)
                _recv_exact_into(sock, memoryview(buf))
                segments.append(buf)
        msg = serde.tree_from_frames(header, segments)
        _count_wire(reg, False, len(head) + extra + len(table) + sum(lens),
                    count_as, msgs=msgs)
        return msg
    (n,) = _LEN.unpack(head)
    msg = serde.tree_from_bytes(_recv_exact(sock, n))
    _count_wire(reg, False, _LEN.size + n, count_as, msgs=msgs)
    return msg


def _take_arena(scratch: Optional[list], nbytes: int):
    """A receive arena of ≥ ``nbytes``: reused from the caller's bounded
    ``scratch`` pool when a pooled arena is provably unreferenced
    (refcount == pool + loop binding + getrefcount's own argument — the
    previous pull's leaves all died), else freshly allocated and pooled.
    Fresh multi-MB allocations every pull ping-pong the allocator
    against the still-referenced previous center (measured ~2x a whole
    4 MB pull on this class of host); the pool turns the steady state
    into zero large allocations."""
    if scratch is not None:
        for i, a in enumerate(scratch):
            if a.nbytes >= nbytes and sys.getrefcount(a) <= 3:
                del scratch[i]
                scratch.append(a)
                return a
    arena = np.empty(nbytes, np.uint8)
    if scratch is not None:
        scratch.append(arena)
        del scratch[:-2]  # bound: current + previous (still referenced)
    return arena


def recv_pull(chan, registry=None, count_as: Optional[str] = None,
              scratch: Optional[list] = None) -> Tuple[Any, Optional[list]]:
    """One pull reply, monolithic or streamed, auto-detected per message
    like v1/v2.  Returns ``(doc, chunk_payload_bytes)`` —
    ``chunk_payload_bytes`` is None for a monolithic reply, else one
    tensor-byte total per received chunk (the client's chunk-size
    telemetry).  Each chunk decodes as it lands (the same zero-copy
    ``recv_into`` path as any v2 frame — no intermediate assembly blob);
    the skeleton is filled only once every leaf arrived, and any gap or
    overlap in the leaf indices fails loudly rather than assembling a
    wrong center."""
    _inject_fault("recv")
    sock, shm = _chan_parts(chan)
    head = _recv_exact(sock, _LEN.size)
    reg = registry if registry is not None else default_registry()
    if head[:4] != _MAGIC4:
        return _recv_framed(sock, shm, head, reg, count_as), None
    _, nchunks = _V2HEAD.unpack(head)
    _count_wire(reg, False, _V2HEAD.size, count_as, msgs=1)
    _inject_fault("recv")
    prologue = _recv_framed(sock, shm, _recv_exact(sock, _LEN.size), reg,
                            count_as, msgs=0)
    nleaves = int(prologue["nleaves"])
    frame_bytes = [int(x) for x in (prologue.get("frame_bytes") or [])]
    # ONE receive arena per pull (pooled via ``scratch``, np.empty — no
    # zero-fill), sliced per chunk frame: the decoded leaves are views
    # into it, and one pooled allocation per pull beats one fresh buffer
    # per chunk (see _take_arena)
    arena = _take_arena(scratch,
                        max(0, sum(frame_bytes)
                            - _LEN.size * len(frame_bytes))) \
        if frame_bytes else None
    arena_off = 0
    slots: dict = {}
    sizes: List[int] = []
    for kidx in range(int(nchunks)):
        c, used = _recv_stream_chunk(chan, sock, shm, kidx, frame_bytes,
                                     arena, arena_off, reg, count_as)
        arena_off += used
        arrs = c["leaves"]
        i0 = int(c["i0"])
        nbytes = 0
        for j, a in enumerate(arrs):
            if i0 + j in slots or not 0 <= i0 + j < nleaves:
                raise ConnectionError(
                    f"streamed pull chunk {c.get('chunk')} places leaf "
                    f"{i0 + j} outside/over the announced {nleaves} "
                    "leaves — torn stream")
            slots[i0 + j] = a
            nbytes += int(getattr(a, "nbytes", 0))
        sizes.append(nbytes)
    if len(slots) != nleaves:
        raise ConnectionError(
            f"streamed pull delivered {len(slots)} of {nleaves} leaves "
            "— torn stream")
    doc = stream_join(prologue["skeleton"],
                      [slots[i] for i in range(nleaves)])
    return doc, sizes


def _recv_stream_chunk(chan, sock, shm, kidx: int, frame_bytes: list,
                       arena, arena_off: int, reg,
                       count_as: Optional[str]) -> tuple:
    """One streamed chunk frame; returns ``(chunk_doc, arena_bytes
    _used)``.  On TCP, the prologue's announced frame size lets the
    whole remaining frame land in ONE slice of the pull's receive arena
    via one big ``recv_into`` — the reader stays blocked in a large
    kernel read for the whole chunk, and the decoded leaves are
    zero-copy views over the arena.  Ring-borne (``DKW3``) frames and
    peers predating ``frame_bytes`` fall back to the generic per-frame
    reader (their slice of the arena simply goes unused)."""
    _inject_fault("recv")
    head = _recv_exact(sock, _LEN.size)
    if head[:4] != _MAGIC2 or kidx >= len(frame_bytes) or arena is None:
        return _recv_framed(sock, shm, head, reg, count_as, msgs=0), 0
    total = int(frame_bytes[kidx])
    _, nseg = _V2HEAD.unpack(head)
    tbl = _LEN.size * (nseg + 1)
    if total < _V2HEAD.size + tbl or \
            arena_off + total - _V2HEAD.size > arena.nbytes:
        raise ConnectionError(
            f"streamed chunk {kidx} announces {total} frame bytes "
            f"({nseg} segments) outside the prologue's layout — torn "
            "stream")
    mv = memoryview(arena)[arena_off:arena_off + total - _V2HEAD.size]
    _recv_exact_into(sock, mv)
    lens = [_LEN.unpack_from(mv, i * _LEN.size)[0]
            for i in range(nseg + 1)]
    if tbl + sum(lens) != mv.nbytes:
        raise ConnectionError(
            f"streamed chunk {kidx}: length table does not add up to "
            "the announced frame size — torn stream")
    off = tbl
    header = bytes(mv[off:off + lens[0]])
    off += lens[0]
    segments: List[Any] = []
    for n in lens[1:]:
        segments.append(mv[off:off + n])
        off += n
    msg = serde.tree_from_frames(header, segments)
    _count_wire(reg, False, total, count_as, msgs=0)
    return msg, total - _V2HEAD.size


# ---------------------------------------------------------------------------
# shared TCP front-end frame (ps.servers and serve.server carried
# mirror copies of this accept/handler/stop machinery — one definition,
# so a protocol or lifecycle fix lands once)
# ---------------------------------------------------------------------------

#: sentinel a ``handle_request`` implementation returns when it already
#: sent its own reply on the connection (the PS pull path's
#: pre-serialized ``send_packed`` payload)
REPLY_SENT = object()


class FrameServer:
    """The TCP front-end both socket services share: listener + accept
    loop, one daemon handler thread per connection (finished handlers
    pruned per accept so a long-lived server polled once per obsview
    tick never accumulates dead Thread objects), per-connection ``hello``
    wire negotiation, a uniform error policy — a malformed FIELD answers
    ``{"ok": False, "error": ...}`` on the same connection instead of
    killing the handler replyless — and the stop sequencing: listener
    first (no NEW connections), then the subclass's
    ``_before_close_connections`` hook (the serve front-end drains its
    engine here), then live sockets, then handler joins.

    Subclasses implement ``handle_request(action, msg, ver, conn)``
    returning a reply dict (sent on the negotiated wire version),
    :data:`REPLY_SENT` when the reply already went out on ``conn``, or
    ``None`` for an unknown action.  ``hello`` and ``stop`` are handled
    here.  ``metric_prefix`` names the connections/in-flight gauges
    (``<prefix>.connections`` / ``<prefix>.inflight``) and the log
    channel (``<prefix>.server``); wire byte counts land in
    ``registry`` so one ``stats`` snapshot covers protocol AND traffic.
    """

    #: obs/gauge/log prefix — "ps" and "serve" for the two front-ends
    metric_prefix = "srv"

    def __init__(self, registry, host: str = "127.0.0.1", port: int = 0,
                 max_wire_version: int = WIRE_VERSION):
        self.registry = registry
        self.host = host
        self.port = int(port)
        #: newest frame format this server will negotiate; pin to 1 to
        #: emulate (and interop-test against) a legacy v1-only server
        self.max_wire_version = int(max_wire_version)
        self._sock: Optional[socket.socket] = None
        self._threads: list = []
        self._conns: list = []
        self._conn_lock = threading.Lock()
        self._running = threading.Event()
        #: the push-telemetry aggregator (``telemetry`` frames and the
        #: serve router's health poll feed it); lazy, so a server nobody
        #: ships to carries no store at all
        self.telemetry = None
        self._plane_lock = threading.Lock()
        self._g_conns = registry.gauge(f"{self.metric_prefix}.connections")
        self._g_inflight = registry.gauge(f"{self.metric_prefix}.inflight")
        #: transient accept-loop errors survived (EMFILE under fd
        #: pressure, ECONNABORTED)
        self._c_accept_errors = registry.counter(
            f"{self.metric_prefix}.accept_errors")

    # -- subclass hooks -----------------------------------------------------
    def handle_request(self, action, msg: dict, ver: int,
                       conn: socket.socket):
        """One request -> a reply dict, :data:`REPLY_SENT`, or ``None``
        (unknown action).  Runs on the connection's handler thread."""
        raise NotImplementedError

    def _on_start(self) -> None:
        """After the listener is bound, before the accept thread spawns."""

    def hello_reply(self, msg: dict, ver: int) -> dict:
        """The ``hello`` reply document.  Subclasses append
        negotiation-time extras (a shard front-end ships its placement
        descriptor here); unknown keys are ignored by every
        parser of this wire, so extras degrade cleanly against old
        clients."""
        return {"ok": True, "version": ver}

    def _before_close_connections(self) -> None:
        """Between closing the listener and closing live connections —
        where in-flight work drains so replies still flush."""

    # -- telemetry plane --------------------------------------------------
    #: where the alert engine (the ``alerts`` action) is ported
    ALERTS_ITEM = "ROADMAP Queue 1 item 7 (obs alerts)"

    def enable_telemetry(self, store=None):
        """Attach (or lazily create) the push-telemetry aggregator.
        Idempotent; also called implicitly by the first ``telemetry``
        frame, so shippers need no out-of-band setup handshake."""
        with self._plane_lock:
            if self.telemetry is None:
                if store is None:
                    from ..obs.timeseries import TimeSeriesStore
                    store = TimeSeriesStore(registry=self.registry)
                self.telemetry = store
            return self.telemetry

    def _handle_plane(self, action, msg: dict):
        """The ``telemetry``/``alerts`` actions every front-end answers —
        tried before the subclass's unknown-action fallback.  A
        ``telemetry`` frame folds into the aggregator; the alert engine
        is not ported yet, so ``alerts`` answers an error that names
        where it is, on the same connection.  ``None`` for other
        actions."""
        if action == "telemetry":
            store = self.telemetry or self.enable_telemetry()
            n = store.ingest_delta(str(msg.get("source") or "unknown"),
                                   msg.get("delta"))
            return {"ok": True, "accepted": n}
        if action == "alerts":
            return {"ok": False,
                    "error": f"the 'alerts' action needs the alert "
                             f"engine, not ported yet: {self.ALERTS_ITEM}"}
        return None

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "FrameServer":
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.host, self.port))
        self.port = self._sock.getsockname()[1]
        self._sock.listen(128)
        self._running.set()
        self._on_start()
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name=f"{self.metric_prefix}-accept")
        # _threads is appended by this (caller) thread AND the accept
        # thread, and iterated by stop(): every touch goes through
        # _conn_lock.  Append BEFORE start so
        # index 0 is always the accept thread — an instant connection
        # could otherwise slot a handler thread in first and stop()'s
        # [1:] join would skip it.
        with self._conn_lock:
            self._threads.append(t)
        t.start()
        return self

    def stop(self) -> None:
        self._running.clear()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._before_close_connections()
        # shut live connections down so handlers blocked in recv unblock
        # (a bare close() leaves another thread's recv blocked on Linux),
        # then close them
        with self._conn_lock:
            conns = list(self._conns)
            threads = list(self._threads)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        for t in threads[1:]:
            t.join(timeout=5)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- loops --------------------------------------------------------------
    def _accept(self):
        """One listener accept — a seam so tests can inject EMFILE-style
        transient errors without monkeypatching the socket object."""
        return self._sock.accept()

    def _accept_loop(self):
        log = get_logger(f"{self.metric_prefix}.server")
        while self._running.is_set():
            try:
                conn, _ = self._accept()
            except OSError as e:
                # stop() clears _running BEFORE closing the listener, so
                # a running server that sees accept fail is hitting a
                # TRANSIENT error (EMFILE under fd pressure, ECONNABORTED
                # on a peer that hung up mid-handshake): log, breathe,
                # keep accepting — one bad accept must not end the
                # server's ability to take connections.  A
                # listener torn down under us (fd gone) is fatal.
                if not self._running.is_set() or self._sock.fileno() < 0:
                    return  # listener closed by stop()
                self._c_accept_errors.inc()
                log.warning("accept failed (transient, continuing): %s", e)
                time.sleep(0.05)
                continue
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conn_lock:
                self._conns.append(conn)
            self._g_conns.inc()
            t = threading.Thread(target=self._handle_connection,
                                 args=(conn,), daemon=True,
                                 name=f"{self.metric_prefix}-conn")
            t.start()
            with self._conn_lock:
                # prune finished handlers; index 0 stays the accept thread
                self._threads[1:] = [h for h in self._threads[1:]
                                     if h.is_alive()]
                self._threads.append(t)

    def _negotiate_shm(self, conn: socket.socket, msg: dict, ver: int,
                       reply: dict, log):
        """Try to attach the client-created rings named in the hello's
        ``shm`` spec.  Attach success IS the same-host check —
        no hostname heuristics; a cross-host peer's open() simply fails
        and the connection stays on TCP, ack-less."""
        spec = msg.get("shm")
        if not isinstance(spec, dict) or ver < 2:
            return None
        try:
            chan = ShmChannel.serve_attach(conn, spec)
        except (OSError, ValueError, KeyError, TypeError) as e:
            log.info("shm negotiation refused (cross-host peer, or dead "
                     "segment): %s", e)
            return None
        reply["shm"] = {"ok": True}
        return chan

    def _handle_connection(self, conn: socket.socket):
        reg = self.registry
        log = get_logger(f"{self.metric_prefix}.server")
        ver = 1  # per-connection wire version; hello upgrades it
        up = f"{self.metric_prefix}.wire.bytes_up"
        down = f"{self.metric_prefix}.wire.bytes_down"
        chan = conn  # hello may upgrade to a ShmChannel
        try:
            while self._running.is_set():
                try:
                    msg = recv_msg(chan, registry=reg, count_as=up)
                except (ConnectionError, OSError):
                    return
                action = msg.get("action")
                self._g_inflight.inc()
                try:
                    if action == "hello":
                        ver = choose_wire_version(msg.get("versions"),
                                                  self.max_wire_version)
                        reply = self.hello_reply(msg, ver)
                        new_chan = self._negotiate_shm(conn, msg, ver,
                                                       reply, log)
                        # the reply itself stays v1-framed AND on TCP:
                        # the client switches only after reading it
                        send_msg(conn, reply, registry=reg, count_as=down)
                        if new_chan is not None:
                            chan = new_chan
                    elif action == "stop":
                        send_msg(chan, {"ok": True}, registry=reg,
                                 version=ver, count_as=down)
                        return
                    else:
                        reply = self._handle_plane(action, msg)
                        if reply is None:
                            reply = self.handle_request(action, msg, ver,
                                                        chan)
                        if reply is None:
                            reply = {"ok": False,
                                     "error": f"unknown action {action!r}"}
                        if reply is not REPLY_SENT:
                            send_msg(chan, reply, registry=reg, version=ver,
                                     count_as=down)
                except (ConnectionError, OSError) as e:
                    log.warning("reply to %r failed (peer gone?): %s",
                                action, e)
                    return
                except Exception as e:
                    # a malformed FIELD (bad versions list, undecodable
                    # codec stub, mismatched promote tree) answers like
                    # any bad request instead of killing the handler and
                    # dropping the peer's connection replyless
                    log.warning("action %r failed: %s", action, e)
                    try:
                        send_msg(chan, {"ok": False, "error": str(e)},
                                 registry=reg, version=ver, count_as=down)
                    except (ConnectionError, OSError):
                        return
                finally:
                    self._g_inflight.dec()
        finally:
            if isinstance(chan, ShmChannel):
                # attachments only: the creating client owns the unlink
                chan.close_rings()
            try:
                conn.close()
            except OSError:
                pass
            with self._conn_lock:
                if conn in self._conns:
                    self._conns.remove(conn)
            self._g_conns.dec()
