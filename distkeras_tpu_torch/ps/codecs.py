"""Delta-compression codecs for the PS commit wire — the port of
``distkeras_tpu.ps.codecs``, with the same stubs on the wire.

Every communication window ships a full fp32 delta up to the parameter
server.  For SGD-family updates that payload is massively compressible:
per-tensor-scaled **int8 quantization** (4×), **bfloat16 truncation** (2×)
and **top-k sparsification** (1/frac ×) all preserve convergence when the
quantization error is carried forward — the worker keeps an
**error-feedback residual** (Seide et al. 2014; Karimireddy et al. 2019
EF-SGD) added to the next window's delta before encoding, so nothing is
lost, only delayed.

Shape of the scheme:

* A ``Codec`` instance lives on the WORKER (one per connection — the
  residual is per-worker state): ``encode(tree)`` maps floating leaves
  to ``{_MARK: name, ...}`` stub dicts and accumulates the residual.
  Integer/bool leaves pass through untouched — the server skips them.
* Decoding is STATELESS and self-describing per leaf
  (:func:`decode_tree`) so one server handles workers running different
  codecs — and uncompressed workers — on the same port.
* The encoded leaves are plain dicts of scalars + small arrays, so they
  ride both wire formats; under the v2 framing the quantized bytes ship
  zero-copy.

Everything stays numpy on the host, as in the JAX package.  Trees are
walked in ``jax.tree_util``'s order (``utils.tree.tree_flatten``: dict
keys sorted, rebuilt sorted).  bfloat16 has no numpy dtype here: a
bfloat16 leaf is a CPU ``torch.bfloat16`` tensor (what ``utils.serde``
decodes the wire's bfloat16 bits to), converted from f32 by torch's
round-to-nearest-even, as ``ml_dtypes`` converts in the JAX package, so
the ``bf16`` stub's bytes are the same.

``comm_codec`` on the distributed trainers selects per trainer:
``"none"`` (default — bit-identical to the uncompressed path), ``"int8"``,
``"bf16"``, or ``"topk<frac>"`` (e.g. ``"topk0.01"``; top-k implies
error feedback or it would diverge).

Obs: encode counts ``ps.codec.bytes_raw`` / ``ps.codec.bytes_encoded`` /
``ps.codec.bytes_saved`` into the caller's registry (compression ratio =
raw/encoded); encode and decode latency land in
``ps.codec.encode_seconds`` / ``ps.codec.decode_seconds`` at the call
sites (``ps.client`` / ``ps.servers``).

The **DOWN direction**: :func:`encode_ref_delta` / :func:`apply_ref_delta`
quantize the pulled center as a residual against a **reference center**
both ends hold (the server's shared per-K-counters snapshot —
``ps.state.DownRefState``) with the same stateless per-leaf stubs, so
any UP codec's decoder already understands the DOWN wire.  No error
feedback DOWN: each pull encodes ``center - reference`` fresh.
:class:`AdaptiveDownPolicy` picks the DOWN codec per connection from the
client-measured RTTs, with hysteresis and a recorded
``ps.codec.switches`` trail.
"""

from __future__ import annotations

import collections
from typing import Any, List, Optional

import numpy as np
import torch

from ..obs.logging import get_logger
from ..utils.tree import tree_flatten

_MARK = "__dkcodec__"
_BF16 = "bfloat16"

Tree = Any


def _is_stub(x) -> bool:
    return isinstance(x, dict) and _MARK in x


def _is_bf16(a) -> bool:
    return torch.is_tensor(a) and a.dtype == torch.bfloat16


def _host(a):
    """A leaf on the host: a numpy array, or a CPU bfloat16 tensor."""
    if torch.is_tensor(a):
        a = a.detach().cpu()
        return a if a.dtype == torch.bfloat16 else a.numpy()
    return np.asarray(a)


def _f32(a) -> np.ndarray:
    """A floating leaf's values as a float32 numpy array."""
    if _is_bf16(a):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _floating(a) -> bool:
    return _is_bf16(a) or np.issubdtype(a.dtype, np.floating)


def _size(a) -> int:
    return a.numel() if torch.is_tensor(a) else a.size


def _dtype_tag(a) -> str:
    """Self-describing dtype tag (bfloat16 has no portable ``.str``)."""
    return _BF16 if _is_bf16(a) else a.dtype.str


def _as_stub_dtype(x: np.ndarray, stub: dict):
    """``x`` (float32 values) in the stub's dtype — the one place the
    tag convention is resolved back for every decoder."""
    if stub["dtype"] == _BF16:
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)) \
            .to(torch.bfloat16)
    return x.astype(np.dtype(stub["dtype"]))


def _as_dtype_of(x, like):
    """``x`` in ``like``'s dtype (a bfloat16 leaf stays a tensor)."""
    if _is_bf16(like):
        return x.to(torch.bfloat16) if torch.is_tensor(x) \
            else torch.from_numpy(np.asarray(x, np.float32)).to(
                torch.bfloat16)
    return np.asarray(x).astype(like.dtype, copy=False)


class Codec:
    """Base: identity codec (``comm_codec='none'``).  Stateful subclasses
    implement ``_enc_leaf``/``_dec_leaf``; :meth:`encode` threads the
    error-feedback residual through them."""

    name = "none"
    #: identity codecs skip the encode walk entirely so the default path
    #: stays bit-for-bit the pre-codec wire
    is_identity = True
    #: add the previous window's quantization error before encoding
    error_feedback = True

    def encode(self, tree: Tree) -> Tree:
        if self.is_identity:
            return tree
        leaves, unflatten = tree_flatten(tree)
        residual: List[Optional[Any]] = getattr(
            self, "_residual", None) or [None] * len(leaves)
        if len(residual) != len(leaves):  # tree changed: drop stale state
            residual = [None] * len(leaves)
        enc, res = [], []
        for a, r in zip(leaves, residual):
            a = _host(a)
            if not _floating(a) or _size(a) == 0:
                enc.append(a)
                res.append(None)
                continue
            if self.error_feedback and r is not None:
                a = a + r
            stub = self._enc_leaf(a)
            enc.append(stub)
            # "raw" stubs ship the leaf verbatim — nothing is lost, so no
            # residual (and non-finite leaves would poison it: inf - inf)
            res.append(_as_dtype_of(a - self._dec_leaf(stub), a)
                       if self.error_feedback and stub[_MARK] != "raw"
                       else None)
        self._residual = res
        return unflatten(enc)

    def _enc_leaf(self, a) -> dict:
        raise NotImplementedError

    def _dec_leaf(self, stub: dict):
        raise NotImplementedError


class Int8Codec(Codec):
    """Per-tensor linear quantization to int8: ``q = round(a / scale)``
    with ``scale = max|a| / 127`` — 4× smaller than fp32 on the wire."""

    name = "int8"
    is_identity = False

    def _enc_leaf(self, a):
        a32 = _f32(a)
        scale = float(np.max(np.abs(a32))) / 127.0 if a32.size else 0.0
        if scale == 0.0 or not np.isfinite(scale):
            # all-zero (or non-finite peak: ship verbatim, don't destroy it)
            if scale == 0.0:
                return {_MARK: "int8", "dtype": _dtype_tag(a), "scale": 0.0,
                        "shape": list(a.shape),
                        "q": np.zeros(0, dtype=np.int8)}
            return {_MARK: "raw", "data": a}
        q = np.round(a32 / scale).astype(np.int8)
        return {_MARK: "int8", "dtype": _dtype_tag(a), "scale": scale,
                "shape": list(a.shape), "q": q}

    @staticmethod
    def _dec_leaf(stub):
        # "raw" stubs never reach here: encode skips their residual and
        # decode_tree dispatches them to the shared raw decoder
        if stub["scale"] == 0.0:
            return _as_stub_dtype(np.zeros(stub["shape"], np.float32), stub)
        return _as_stub_dtype(
            np.asarray(stub["q"], np.float32) * stub["scale"], stub)


class Bf16Codec(Codec):
    """Round fp32/fp64 deltas to bfloat16 (2× / 4×): same exponent range
    as fp32, 8-bit mantissa, no scale bookkeeping needed."""

    name = "bf16"
    is_identity = False

    def _enc_leaf(self, a):
        if _is_bf16(a):  # already 2 bytes: ship verbatim
            return {_MARK: "raw", "data": a}
        return {_MARK: "bf16", "dtype": _dtype_tag(a),
                "data": torch.from_numpy(np.ascontiguousarray(a))
                .to(torch.bfloat16)}

    @staticmethod
    def _dec_leaf(stub):
        data = stub["data"]
        if stub["dtype"] == _BF16:
            return data
        return data.float().numpy().astype(np.dtype(stub["dtype"]))


class TopKCodec(Codec):
    """Magnitude top-k sparsification: ship only the ``frac`` largest-
    magnitude entries (values + flat indices).  Error feedback is what
    makes this converge — dropped coordinates accumulate in the residual
    and ship once they grow."""

    name = "topk"
    is_identity = False

    def __init__(self, frac: float):
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"topk fraction must be in (0, 1], got {frac}")
        self.frac = float(frac)
        self.name = f"topk{frac:g}"

    def _enc_leaf(self, a):
        flat = _f32(a).reshape(-1)
        k = max(1, int(round(self.frac * flat.size)))
        if k >= flat.size:
            return {_MARK: "raw", "data": a}
        idx = np.argpartition(np.abs(flat), flat.size - k)[-k:]
        idx = np.sort(idx).astype(
            np.int32 if flat.size < 2**31 else np.int64)
        return {_MARK: "topk", "dtype": _dtype_tag(a),
                "shape": list(a.shape), "idx": idx, "vals": flat[idx]}

    @staticmethod
    def _dec_leaf(stub):
        flat = np.zeros(int(np.prod(stub["shape"])), dtype=np.float32)
        flat[np.asarray(stub["idx"])] = np.asarray(stub["vals"])
        return _as_stub_dtype(flat.reshape(stub["shape"]), stub)


_DECODERS = {
    "int8": Int8Codec._dec_leaf,
    "bf16": Bf16Codec._dec_leaf,
    "topk": TopKCodec._dec_leaf,
    "raw": lambda stub: _host(stub["data"]),
}


def get_codec(spec) -> Codec:
    """``comm_codec`` spec string (or Codec instance) -> fresh Codec.

    Accepted: ``"none"`` / ``None``, ``"int8"``, ``"bf16"``,
    ``"topk<frac>"`` (e.g. ``"topk0.01"``).
    """
    if isinstance(spec, Codec):
        return spec
    if spec is None or spec == "none":
        return Codec()
    if spec == "int8":
        return Int8Codec()
    if spec in ("bf16", "bfloat16"):
        return Bf16Codec()
    if isinstance(spec, str) and spec.startswith("topk"):
        try:
            return TopKCodec(float(spec[4:]))
        except ValueError as e:
            raise ValueError(
                f"bad comm_codec {spec!r}: topk needs a fraction suffix, "
                f"e.g. 'topk0.01' ({e})") from e
    raise ValueError(f"unknown comm_codec {spec!r} "
                     f"(known: none, int8, bf16, topk<frac>)")


def decode_tree(tree: Tree) -> Tree:
    """Stateless inverse of ``Codec.encode`` — dispatches per leaf stub,
    so mixed-codec (and uncompressed) trees all decode."""
    leaves, unflatten = tree_flatten(tree, is_leaf=_is_stub)
    return unflatten([_DECODERS[x[_MARK]](x) if _is_stub(x) else x
                      for x in leaves])


def _nbytes(x) -> int:
    if isinstance(x, np.ndarray) or torch.is_tensor(x):
        return int(x.nbytes)
    return 0


def tree_payload_bytes(tree: Tree) -> int:
    """Tensor-payload bytes of a (possibly encoded) tree: array leaf
    bytes, plus the array fields inside codec stubs — the number the
    ``ps.codec.bytes_*`` counters report (framing/msgpack keys excluded).
    Pure dtype/shape arithmetic (``.nbytes``)."""
    total = 0
    for leaf in tree_flatten(tree, is_leaf=_is_stub)[0]:
        if _is_stub(leaf):
            total += sum(_nbytes(v) for v in leaf.values())
        else:
            total += _nbytes(leaf)
    return total


def count_codec_bytes(registry, raw: int, encoded: int,
                      prefix: str = "ps.codec") -> None:
    """Fold one encode/decode's byte accounting into ``registry``.
    ``prefix`` splits the ledgers: ``ps.codec`` is the UP (commit)
    direction, ``ps.down`` the DOWN (pull) direction."""
    registry.counter(f"{prefix}.bytes_raw").inc(raw)
    registry.counter(f"{prefix}.bytes_encoded").inc(encoded)
    registry.counter(f"{prefix}.bytes_saved").inc(max(0, raw - encoded))


# ---------------------------------------------------------------------------
# DOWN direction: reference/residual center compression
# ---------------------------------------------------------------------------

#: DOWN codec specs a current client can decode — advertised in the
#: hello so a newer server never ships a stub this build cannot open
DOWN_CODECS = ("int8", "bf16", "topk")


def validate_down_spec(spec) -> str:
    """Normalize/validate a ``comm_down`` spec: ``None``/"none" (raw
    pulls, the bit-identical default), "adaptive" (per-link policy), or
    any non-identity ``get_codec`` spec ("int8" / "bf16" / "topk<frac>")."""
    if spec is None or spec == "none":
        return "none"
    if spec == "adaptive":
        return "adaptive"
    codec = get_codec(spec)
    if codec.is_identity:
        raise ValueError(f"comm_down {spec!r} is an identity codec; use "
                         f"'none' to disable DOWN compression")
    return codec.name


def encode_ref_delta(center: Tree, ref: Tree, spec: str) -> Tree:
    """Encode ``center`` as a quantized residual against ``ref`` (the
    reference center the peer already holds): floating leaves become the
    same self-describing stubs the UP codecs ship (``center - ref``
    through ``spec``'s leaf encoder), non-floating/empty leaves pass
    through verbatim.  Stateless — no error feedback."""
    codec = get_codec(spec)
    centers, unflatten = tree_flatten(center)
    refs = tree_flatten(ref)[0]

    def enc(c, r):
        c = _host(c)
        if not _floating(c) or _size(c) == 0:
            return c
        return codec._enc_leaf(_as_dtype_of(c - _host(r), c))

    return unflatten([enc(c, r) for c, r in zip(centers, refs)])


def apply_ref_delta(ref: Tree, residual: Tree) -> Tree:
    """Inverse of :func:`encode_ref_delta`: ``ref + decode(stub)`` per
    stub leaf (new arrays — pulled trees stay read-only), pass-through
    leaves adopted as-is."""
    refs, unflatten = tree_flatten(ref)
    stubs = tree_flatten(residual, is_leaf=_is_stub)[0]

    def dec(r, s):
        if _is_stub(s):
            r = _host(r)
            return r + _as_dtype_of(_DECODERS[s[_MARK]](s), r)
        return s

    return unflatten([dec(r, s) for r, s in zip(refs, stubs)])


class AdaptiveDownPolicy:
    """Per-link DOWN codec selection from measured pull RTTs.

    Lives on the CLIENT — the end that actually measures the link: each
    pull's VISIBLE wait (which folds in the server's encode time, the
    un-overlapped transfer, and this end's decode — but never the
    caller's compute between ``pull_begin`` and ``pull_join``, so
    dispatch-ahead pulls compare codecs by what they still cost the
    critical path) is attributed to the codec that carried it.  The policy seeds an EWMA per candidate during a warmup
    sweep, then serves the argmin — with **hysteresis**: a challenger
    must beat the incumbent by ``margin`` on ``patience`` consecutive
    evaluations before a switch, so RTT noise never flaps the link.
    Every switch increments ``ps.codec.switches`` and appends to the
    bounded :attr:`trail` (the recorded decision log obsview and tests
    read); a periodic re-probe keeps the losers' EWMAs honest as link
    conditions drift.

    The reprobe schedule reads the straggler detector's
    **link-quality signal**: given a :class:`~..obs.stragglers.LinkQuality`
    (the per-link pull/commit RTT EWMAs the client already measures), a
    degraded link (1) **downshifts** the codec one step toward more
    compression IMMEDIATELY — no hysteresis wait, because the remedy for
    a link that just got slower is fewer bytes *now*, before the
    worker's stretched window gap gets it flagged as a straggler — with
    every downshift a recorded ``ps.link.downshifts`` event on the
    trail, and (2) tightens the re-probe cadence (``reprobe_every // 4``)
    while degraded, so the EWMAs re-learn the shifted link quickly.  The
    normal hysteresis path still owns the recovery upshift once probes
    show the cheaper codec winning again.
    """

    #: candidate order is bytes-descending ("none" ships the most), so a
    #: downshift is one step to the right — strictly fewer bytes
    def __init__(self, registry, candidates=("none", "bf16", "int8"),
                 margin: float = 0.2, patience: int = 3,
                 reprobe_every: int = 25, alpha: float = 0.3,
                 warmup_samples: int = 2, link=None):
        for c in candidates:
            if c != "none":
                validate_down_spec(c)
        self.candidates = tuple(candidates)
        self.margin = float(margin)
        self.patience = int(patience)
        self.reprobe_every = int(reprobe_every)
        self.alpha = float(alpha)
        self.warmup_samples = int(warmup_samples)
        #: per-link RTT EWMAs with a degradation edge; None
        #: keeps the pre-link behavior exactly
        self.link = link
        #: cumulative link-degradation downshifts — shipped on the
        #: commit RPC next to the link EWMA
        self.downshifts = 0
        self.current = self.candidates[0]
        self._ewma: dict = {}
        self._samples: dict = {c: 0 for c in self.candidates}
        self._streak_for: Optional[str] = None
        self._streak = 0
        self._n = 0
        self._probe_cursor = 0
        #: bounded decision log: one entry per switch
        self.trail: collections.deque = collections.deque(maxlen=256)
        self._c_switches = registry.counter("ps.codec.switches")
        self._c_downshifts = registry.counter("ps.link.downshifts")
        self._log = get_logger("ps.down")

    def _downshift(self) -> Optional[str]:
        """One step toward more compression on a degraded link, or None
        when already at the smallest candidate."""
        i = self.candidates.index(self.current)
        if i + 1 >= len(self.candidates):
            return None
        nxt = self.candidates[i + 1]
        self.trail.append({"pull": self._n, "from": self.current,
                           "to": nxt, "kind": "downshift"})
        self._log.warning(
            "link degraded (RTT EWMA over %.1fx its best): downshifting "
            "DOWN codec %s -> %s", self.link.degrade_factor, self.current,
            nxt)
        self.current = nxt
        self.downshifts += 1
        self._c_downshifts.inc()
        self._streak_for, self._streak = None, 0
        # the link's byte profile just changed: rebase the degradation
        # baseline so the edge measures the NEW codec's link, and the
        # downshift self-cools instead of cascading every pull
        self.link.rebase()
        return nxt

    def next_codec(self) -> str:
        """The codec the NEXT pull should request."""
        for c in self.candidates:  # warmup: seed every candidate's EWMA
            if self._samples[c] < self.warmup_samples:
                return c
        self._n += 1
        degraded = self.link is not None and self.link.degraded()
        if degraded:
            shifted = self._downshift()
            if shifted is not None:
                return shifted
        reprobe = self.reprobe_every
        if degraded and reprobe:
            # a degraded link's EWMAs are stale by definition: re-probe
            # the alternatives 4x as often until the edge clears
            reprobe = max(2, reprobe // 4)
        if reprobe and self._n % reprobe == 0:
            others = [c for c in self.candidates if c != self.current]
            if others:
                self._probe_cursor = (self._probe_cursor + 1) % len(others)
                return others[self._probe_cursor]
        return self.current

    def observe(self, codec: str, rtt_s: float) -> None:
        """Fold one pull's measured RTT into ``codec``'s EWMA and
        re-evaluate the incumbent."""
        if codec not in self.candidates or not np.isfinite(rtt_s) \
                or rtt_s < 0:
            return
        self._samples[codec] += 1
        prev = self._ewma.get(codec)
        self._ewma[codec] = float(rtt_s) if prev is None \
            else (1 - self.alpha) * prev + self.alpha * float(rtt_s)
        if any(self._samples[c] < self.warmup_samples
               for c in self.candidates):
            return
        best = min(self.candidates, key=lambda c: self._ewma[c])
        if best == self.current or \
                self._ewma[best] >= self._ewma[self.current] * \
                (1.0 - self.margin):
            self._streak_for, self._streak = None, 0
            return
        if self._streak_for == best:
            self._streak += 1
        else:
            self._streak_for, self._streak = best, 1
        if self._streak >= self.patience:
            ratio = self._ewma[self.current] / max(self._ewma[best], 1e-12)
            self.trail.append({"pull": self._n, "from": self.current,
                               "to": best, "rtt_ratio": round(ratio, 3)})
            self._log.info(
                "adaptive DOWN codec switch: %s -> %s (EWMA RTT ratio "
                "%.2fx over %d consecutive evaluations)", self.current,
                best, ratio, self._streak)
            self.current = best
            self._c_switches.inc()
            self._streak_for, self._streak = None, 0
