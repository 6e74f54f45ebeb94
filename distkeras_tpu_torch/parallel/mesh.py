"""The mesh and its collectives — the port of ``distkeras_tpu.parallel.
mesh`` and of the collectives the JAX modules call inside ``shard_map``.

The JAX package's mesh is a grid of devices, and ``shard_map`` runs one
program per device with ``lax.psum`` / ``pmean`` / ``ppermute`` /
``all_to_all`` between them.  Here every process of a
``torch.distributed`` group (``parallel.multihost.initialize``) is one
rank of the mesh: ``make_mesh`` lays the ranks out on the axes (a
``torch.distributed.device_mesh.DeviceMesh`` over the default group, one
process group per axis), and the collectives below run over an axis's
group.  An axis counts **slots**: the ``workers`` axis may give a rank
several consecutive slots (those workers step one after another on the
rank, as ``SyncEngine`` steps its stacked workers), while every other axis
(``sp``, ``ep``, ``dp``) holds one shard per rank.

Every collective here is a plain function of this rank's tensor and an
axis name, differentiable with the transpose the JAX package's
``shard_map`` (``check_vma=False``) gives it: ``psum`` → ``psum``,
``pmean`` → ``pmean``, ``ppermute`` → the inverse permutation,
``all_to_all`` → the reversed exchange, ``all_gather`` → a reduce-scatter.
Autograd runs the backward's collectives in the reverse of the order the
forward made them on every rank (its ready queue takes the latest-made
node first), so ranks that ran the same collectives meet in the backward
too.  :func:`shard_map` is the whole-array boundary: each rank holds the
whole array, takes its slice (whose backward all-gathers the cotangent
slices) and hands back the whole output (whose backward takes this
rank's slice), so a mesh-attached layer's gradient equals the mesh-free
layer's, not P times it; a replicated input's cotangent is summed over
the axes its spec leaves out, and a replicated output's divided by their
size, as JAX's transpose of ``shard_map`` does.

The backend is chosen once, by :func:`choose_backend`: ``nccl`` when
every rank of the group has a card of its own, ``gloo`` on the CPU or
when ranks share a card (NCCL refuses two ranks on one device).  gloo
runs ``all_reduce``, ``broadcast``, ``all_gather``, ``all_to_all`` and
``reduce_scatter`` on CUDA tensors and refuses send/recv
(``GLOO_CUDA_DIRECT``, found on the card), so on a gloo group a CUDA
tensor's ``ppermute`` moves through a host copy made here — that route
is the only one gloo has, and its bytes and calls are counted
(:func:`collective_stats`) beside every collective's.
"""

from __future__ import annotations

import math
import threading
from collections import Counter
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import DeviceLike
from ..utils.tree import tree_map
from . import multihost

#: the axis whose size may exceed the rank count (several workers a rank)
WORKERS = "workers"
#: collectives gloo runs on CUDA tensors directly, as ``python -m
#: distkeras_tpu_torch.parallel.gloo_probe`` found them on an H100 with
#: torch 2.11 (cu128): send/recv refused, the rest right; on a gloo group
#: a CUDA tensor's ``ppermute`` (send/recv) goes through a host copy
GLOO_CUDA_DIRECT = frozenset({"all_reduce", "broadcast", "all_gather",
                              "all_to_all", "reduce_scatter"})


# ---------------------------------------------------------------------------
# the backend rule
# ---------------------------------------------------------------------------

def choose_backend(device: torch.device, num_processes: int,
                   local_processes: Optional[int] = None):
    """``(backend, reason)`` for a group of ``num_processes`` ranks, this
    one on ``device``: ``nccl`` when every rank on this host has a card of
    its own (``local_processes`` ranks on the host, default all of them,
    at most ``torch.cuda.device_count()``), else ``gloo``."""
    device = torch.device(device)
    if device.type != "cuda":
        return "gloo", f"ranks on {device.type}: gloo"
    local = int(local_processes or num_processes)
    cards = torch.cuda.device_count()
    if local <= cards:
        return "nccl", (f"{local} ranks on this host, {cards} cards: one "
                        f"card each, nccl")
    return "gloo", (f"{local} ranks share {cards} card(s): nccl takes one "
                    f"rank per device, gloo")


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------

_STATS_LOCK = threading.Lock()
_STATS = {"calls": Counter(), "bytes": Counter(), "host_calls": Counter(),
          "host_bytes": Counter()}


def reset_collective_stats() -> None:
    """Set every collective counter to 0."""
    with _STATS_LOCK:
        for c in _STATS.values():
            c.clear()


def collective_stats() -> dict:
    """``{"calls", "bytes", "host_calls", "host_bytes"}``, each a dict by
    collective: this rank's calls, the bytes it sent, and those of them
    that went through a host copy (a CUDA tensor on a gloo group)."""
    with _STATS_LOCK:
        return {k: dict(v) for k, v in _STATS.items()}


def _count(op: str, t: torch.Tensor, host: bool) -> None:
    n = t.numel() * t.element_size()
    with _STATS_LOCK:
        _STATS["calls"][op] += 1
        _STATS["bytes"][op] += n
        if host:
            _STATS["host_calls"][op] += 1
            _STATS["host_bytes"][op] += n


def route(op: str, t: torch.Tensor, group) -> str:
    """``"direct"`` or ``"host"``: how collective ``op`` moves ``t`` over
    ``group``.  Only a CUDA tensor on a gloo group whose collective gloo
    refuses goes through the host."""
    if t.is_cuda and dist.get_backend(group) == "gloo" \
            and op not in GLOO_CUDA_DIRECT:
        return "host"
    return "direct"


def _staged(op: str, t: torch.Tensor, group):
    """(tensor to hand torch.distributed, whether it is a host copy)."""
    host = route(op, t, group) == "host"
    _count(op, t, host)
    return (t.detach().cpu() if host else t.detach()), host


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

_CURRENT = threading.local()
_LAST: list = [None]


class PartitionSpec(tuple):
    """The sharding of each dim of an array over mesh axes (None:
    whole), as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *axes):
        return tuple.__new__(cls, axes)


P = PartitionSpec


class LocalSpec(PartitionSpec):
    """A leaf each rank already holds as its own block along the named
    axes (a layer's shard of its experts): ``shard_map`` neither cuts nor
    gathers it, and sums its cotangent over the axes it does not name,
    over whose ranks it is replicated."""


class Mesh:
    """The ranks of the default process group laid out on named axes.

    The JAX object's reading surface: ``shape[axis]`` (slots on the
    axis), ``axis_names`` and ``size``; and for this rank ``axis_index``
    (its first slot), ``procs`` (ranks on the axis), ``slots`` (its slots
    on the axis), ``group`` (the axis's process group, None for one
    rank).  ``device`` is the rank's device; ``backend`` and
    ``backend_reason`` say how the group talks.  ``with mesh:`` makes it
    the mesh the collectives act on (the last one made otherwise)."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int],
                 device: torch.device):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.size = int(np.prod(list(self.shape.values())))
        self.device = torch.device(device)
        ready = dist.is_available() and dist.is_initialized()
        self.rank = dist.get_rank() if ready else 0
        self.world = dist.get_world_size() if ready else 1
        if self.size % self.world:
            raise ValueError(f"mesh shape {tuple(shape)} ({self.size} slots) "
                             f"does not split over {self.world} ranks")
        per_rank = self.size // self.world
        procs = dict(self.shape)
        if per_rank > 1:
            if WORKERS not in self.shape or self.shape[WORKERS] % per_rank:
                raise ValueError(
                    f"mesh shape {tuple(shape)} over {self.world} ranks puts "
                    f"{per_rank} slots on a rank: only the {WORKERS!r} axis "
                    f"may hold several (sp, ep and the rest hold one shard "
                    f"a rank)")
            procs[WORKERS] //= per_rank
        self._procs = procs
        self._slots = {a: (per_rank if a == WORKERS else 1)
                       for a in self.axis_names}
        grid = np.arange(self.world).reshape(
            [procs[a] for a in self.axis_names])
        self._coord = dict(zip(self.axis_names,
                               (int(c[0]) for c in np.nonzero(
                                   grid == self.rank))))
        self.device_mesh = None
        self._groups = {a: None for a in self.axis_names}
        self.backend = dist.get_backend() if ready else None
        self.backend_reason = multihost.backend_reason() if ready else \
            "one process: no group"
        if ready and self.world > 1:
            from torch.distributed.device_mesh import DeviceMesh
            self.device_mesh = DeviceMesh(
                "cuda" if self.backend == "nccl" else "cpu", grid,
                mesh_dim_names=self.axis_names)
            for a in self.axis_names:
                if procs[a] > 1:
                    self._groups[a] = self.device_mesh.get_group(a)
        _LAST[0] = self

    # -- reading surface ------------------------------------------------------
    def procs(self, axis: str) -> int:
        """Ranks along ``axis``."""
        return self._procs[axis]

    def slots(self, axis: str) -> int:
        """This rank's slots on ``axis`` (1 but on ``workers``)."""
        return self._slots[axis]

    def coord(self, axis: str) -> int:
        """This rank's index among the ranks along ``axis``."""
        return self._coord[axis]

    def axis_index(self, axis: str) -> int:
        """This rank's first slot on ``axis``."""
        return self._coord[axis] * self._slots[axis]

    def local_slots(self, axis: str = WORKERS) -> range:
        """The slots of ``axis`` this rank holds."""
        i = self.axis_index(axis)
        return range(i, i + self._slots[axis])

    def group(self, axis: str):
        """The process group of ``axis`` through this rank (None when the
        axis has one rank)."""
        return self._groups[axis]

    def one_slot(self, axis: str) -> None:
        """Raise unless this rank holds one slot of ``axis``."""
        if self._slots[axis] != 1:
            raise ValueError(
                f"this rank holds {self._slots[axis]} slots of the "
                f"{axis!r} axis; a collective inside a forward needs one "
                f"slot a rank (slots on one rank step one after another "
                f"and cannot meet mid-forward)")

    def __enter__(self):
        stack = getattr(_CURRENT, "stack", None)
        if stack is None:
            stack = _CURRENT.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _CURRENT.stack.pop()

    def __repr__(self):
        return (f"Mesh({self.shape}, rank {self.rank}/{self.world}, "
                f"{self.device}, {self.backend})")


def current_mesh(mesh: Optional[Mesh] = None) -> Mesh:
    """``mesh``, else the innermost ``with mesh:``, else the last mesh
    made; raises when there is none."""
    if mesh is not None:
        return mesh
    stack = getattr(_CURRENT, "stack", None)
    if stack:
        return stack[-1]
    if _LAST[0] is None:
        raise RuntimeError("no mesh: build one with make_mesh")
    return _LAST[0]


def active_mesh(who: str) -> Mesh:
    """The innermost ``with mesh:`` (never a mesh merely made before),
    for a layer that communicates inside its forward; raises naming
    ``who`` when there is none."""
    stack = getattr(_CURRENT, "stack", None)
    if not stack:
        raise RuntimeError(
            f"{who} communicates across ranks inside its forward and needs "
            f"a current mesh: train it with a mesh (mesh=make_mesh(...)) "
            f"whose ranks each hold one worker, or run it under "
            f"'with mesh:'")
    return stack[-1]


def make_mesh(num_workers: Optional[int] = None,
              axis_names: Sequence[str] = (WORKERS,),
              shape: Optional[Sequence[int]] = None,
              devices: DeviceLike = None) -> Mesh:
    """A mesh over the ranks of the default group (one process, with no
    group).

    Default: a 1-D ``("workers",)`` mesh of ``num_workers`` slots (the
    rank count when None) — the data-parallel topology of the
    reference's one-partition-per-worker contract.  ``axis_names`` /
    ``shape`` give multi-axis (dp × sp, ep) meshes.  ``devices`` is this
    rank's device: by default the one ``multihost.initialize`` gave it,
    else ``cuda:{local_rank % device_count}``; with no card it must be
    named."""
    world = multihost.process_count()
    if shape is None:
        shape = (int(num_workers) if num_workers is not None else world,)
    if len(shape) != len(tuple(axis_names)):
        raise ValueError(f"shape {tuple(shape)} and axis_names "
                         f"{tuple(axis_names)} differ in length")
    return Mesh(axis_names, shape, multihost.rank_device(devices))


# ---------------------------------------------------------------------------
# raw collectives over a group (no autograd)
# ---------------------------------------------------------------------------

def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    h, host = _staged("all_reduce", t, group)
    h = h.clone()
    dist.all_reduce(h, group=group)
    return h.to(t.device) if host else h


def _broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` of the group's rank ``src`` on every rank."""
    h, host = _staged("broadcast", t, group)
    h = h.clone().contiguous()
    dist.broadcast(h, src=dist.get_global_rank(group, src), group=group)
    return h.to(t.device) if host else h


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """(P, *t.shape): every rank's ``t``, in group rank order."""
    h, host = _staged("all_gather", t, group)
    h = h.contiguous()
    out = [torch.empty_like(h) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, h, group=group)
    out = torch.stack(out)
    return out.to(t.device) if host else out


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` (P, …): block j goes to rank j; returns (P, …) with block s
    from rank s."""
    h, host = _staged("all_to_all", t, group)
    h = h.contiguous()
    out = torch.empty_like(h)
    dist.all_to_all_single(out, h, group=group)
    return out.to(t.device) if host else out


def _permute(t: torch.Tensor, perm, group) -> torch.Tensor:
    """``lax.ppermute``: for each (src, dst) pair, rank dst receives rank
    src's ``t``; a rank no pair sends to gets zeros."""
    me = dist.get_rank(group)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    h, host = _staged("ppermute", t, group)
    h = h.contiguous()
    buf = torch.zeros_like(h)
    ops = [dist.P2POp(dist.isend, h, dist.get_global_rank(group, d),
                      group) for d in dst]
    ops += [dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, s),
                       group) for s in src]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return buf.to(t.device) if host else buf


def _group(mesh: Mesh, axis: str):
    mesh.one_slot(axis)
    return mesh.group(axis)


# ---------------------------------------------------------------------------
# differentiable collectives
# ---------------------------------------------------------------------------

class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, scale):
        ctx.group, ctx.scale = group, scale
        return _all_reduce(x, group) * scale if scale != 1 else \
            _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _Psum.apply(g, ctx.group, ctx.scale), None, None


def psum(x, axis_name: str, mesh: Optional[Mesh] = None):
    """``lax.psum`` over the ranks of ``axis_name``; its transpose is
    ``psum``."""
    mesh = current_mesh(mesh)
    group = _group(mesh, axis_name)
    return x if group is None else _Psum.apply(x, group, 1.0)


def pmean(x, axis_name: str, mesh: Optional[Mesh] = None):
    """``lax.pmean`` over the ranks of ``axis_name``; its transpose is
    ``pmean``."""
    mesh = current_mesh(mesh)
    group = _group(mesh, axis_name)
    return x if group is None else \
        _Psum.apply(x, group, 1.0 / mesh.procs(axis_name))


def _inverse(perm):
    return [(d, s) for s, d in perm]


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, group):
        ctx.perm, ctx.group = perm, group
        return _permute(x, perm, group)

    @staticmethod
    def backward(ctx, g):
        return _Ppermute.apply(g, _inverse(ctx.perm), ctx.group), None, None


def ppermute(x, axis_name: str, perm, mesh: Optional[Mesh] = None):
    """``lax.ppermute``: ``perm`` is (source, destination) pairs of axis
    indices; its transpose is the inverse permutation."""
    mesh = current_mesh(mesh)
    group = _group(mesh, axis_name)
    perm = [(int(s), int(d)) for s, d in perm]
    if group is None:
        return x if (0, 0) in perm else torch.zeros_like(x)
    return _Ppermute.apply(x, perm, group)


def _a2a(x, split_axis: int, concat_axis: int, tiled: bool, group, p: int):
    """``lax.all_to_all`` on this rank's ``x`` (no autograd)."""
    split_axis %= x.ndim
    if tiled:
        if x.shape[split_axis] % p:
            raise ValueError(f"all_to_all: dim {split_axis} of size "
                             f"{x.shape[split_axis]} does not split into "
                             f"{p} blocks")
        xs = x.reshape(*x.shape[:split_axis], p, x.shape[split_axis] // p,
                       *x.shape[split_axis + 1:])
    else:
        if x.shape[split_axis] != p:
            raise ValueError(f"all_to_all (untiled): dim {split_axis} must "
                             f"be the axis size {p}, got "
                             f"{x.shape[split_axis]}")
        xs = x
    # (P, …): block s came from rank s, each laid out as x's block
    parts = _all_to_all(xs.movedim(split_axis, 0), group).unbind(0)
    if tiled:
        return torch.cat(parts, dim=concat_axis % x.ndim)
    return torch.stack(parts, dim=concat_axis % x.ndim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_axis, concat_axis, tiled, group, p):
        ctx.args = (split_axis % x.ndim, concat_axis % x.ndim, tiled,
                    group, p)
        return _a2a(x, split_axis, concat_axis, tiled, group, p)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis, tiled, group, p = ctx.args
        return (_AllToAll.apply(g, concat_axis, split_axis, tiled, group, p),
                None, None, None, None, None)


def all_to_all(x, axis_name: str, split_axis: int, concat_axis: int, *,
               tiled: bool = False, mesh: Optional[Mesh] = None):
    """``lax.all_to_all``: ``x`` is split along ``split_axis`` into one
    block per rank of ``axis_name``, block j goes to rank j, and the
    blocks received are concatenated along ``concat_axis`` in source
    order (``tiled``) or stacked there as a new axis.  Its transpose is
    the reversed exchange."""
    mesh = current_mesh(mesh)
    group = _group(mesh, axis_name)
    p = mesh.procs(axis_name)
    if group is None:
        return x if tiled else x.movedim(split_axis, concat_axis)
    return _AllToAll.apply(x, split_axis, concat_axis, tiled, group, p)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, tiled, group, me):
        ctx.args = (axis, tiled, group, me)
        out = _all_gather(x, group)  # (P, …)
        if tiled:
            return torch.cat(out.unbind(0), dim=axis)
        return out.movedim(0, axis)

    @staticmethod
    def backward(ctx, g):
        axis, tiled, group, me = ctx.args
        g = _all_reduce(g.contiguous(), group)
        if tiled:
            n = g.shape[axis] // dist.get_world_size(group)
            return g.narrow(axis, me * n, n), None, None, None, None
        return g.select(axis, me), None, None, None, None


def all_gather(x, axis_name: str, *, axis: int = 0, tiled: bool = False,
               mesh: Optional[Mesh] = None):
    """``lax.all_gather``: every rank's ``x`` along ``axis_name``, stacked
    on a new ``axis`` (or concatenated along it, ``tiled``).  Its
    transpose is a reduce-scatter."""
    mesh = current_mesh(mesh)
    group = _group(mesh, axis_name)
    axis %= x.ndim + (0 if tiled else 1)
    if group is None:
        return x if tiled else x.unsqueeze(axis)
    return _AllGather.apply(x, axis, tiled, group, mesh.coord(axis_name))


class _DependOn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, *deps):
        ctx.like = [(d.shape, d.dtype, d.device) for d in deps]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=t, device=d)
                     for s, t, d in ctx.like))


def depend_on(x, *deps):
    """``x``, with ``deps`` in its backward as zero cotangents: a
    collective's output that this rank does not use (a skipped causal
    hop's K/V) still gets its backward, so every rank runs the same
    collectives there — as JAX transposes both branches of a
    ``lax.cond``."""
    return _DependOn.apply(x, *deps)


def axis_index(axis_name: str, mesh: Optional[Mesh] = None) -> int:
    """``lax.axis_index``: this rank's (first) slot on the axis."""
    return current_mesh(mesh).axis_index(axis_name)


def axis_size(axis_name: str, mesh: Optional[Mesh] = None) -> int:
    """``lax.axis_size``: the ranks along the axis (its slots, for a
    rank with one slot)."""
    return current_mesh(mesh).procs(axis_name)


def broadcast(x: torch.Tensor, axis_name: str, src: int = 0,
              mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank of ``axis_name`` (no
    autograd)."""
    mesh = current_mesh(mesh)
    group = mesh.group(axis_name)
    return x if group is None else _broadcast(x, src, group)


def gather_slots(x: torch.Tensor, axis_name: str = WORKERS,
                 mesh: Optional[Mesh] = None) -> torch.Tensor:
    """This rank's slot stack ``x`` (its slots, …) → the whole axis's
    (slots on the axis, …), the same on every rank (no autograd)."""
    mesh = current_mesh(mesh)
    group = mesh.group(axis_name)
    if group is None:
        return x
    return _all_gather(x, group).flatten(0, 1)


def sum_slots(x: torch.Tensor, axis_name: str = WORKERS,
              mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The sum of ``x`` (this rank's slots, …) over every slot of the
    axis: the local stack summed, then ``psum`` over the ranks (no
    autograd)."""
    mesh = current_mesh(mesh)
    s = x.sum(0)
    group = mesh.group(axis_name)
    return s if group is None else _all_reduce(s, group)


# ---------------------------------------------------------------------------
# the whole-array boundary (shard_map)
# ---------------------------------------------------------------------------

class _Scatter(torch.autograd.Function):
    """Whole → this rank's block of ``dim``; the backward gathers the
    blocks' cotangents, so every rank holds the whole cotangent."""

    @staticmethod
    def forward(ctx, x, dim, group, me, p):
        ctx.args = (dim, group)
        n = x.shape[dim]
        if n % p:
            raise ValueError(f"dim {dim} of size {n} does not split over "
                             f"{p} ranks")
        return x.narrow(dim, me * (n // p), n // p).contiguous()

    @staticmethod
    def backward(ctx, g):
        dim, group = ctx.args
        out = _all_gather(g.contiguous(), group)
        return torch.cat(out.unbind(0), dim=dim), None, None, None, None


class _Gather(torch.autograd.Function):
    """This rank's block → the whole along ``dim``; the backward takes
    this rank's block of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, y, dim, group, me):
        ctx.args = (dim, me, y.shape[dim])
        out = _all_gather(y.contiguous(), group)
        return torch.cat(out.unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, g):
        dim, me, n = ctx.args
        return g.narrow(dim, me * n, n).contiguous(), None, None, None


class _SumCotangent(torch.autograd.Function):
    """Identity whose backward sums the cotangent over ``groups``: a
    replicated input entering per-rank work."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        for group in ctx.groups:
            g = _all_reduce(g.contiguous(), group)
        return g, None


class _ScaleCotangent(torch.autograd.Function):
    """Identity whose backward scales the cotangent: a replicated output
    leaving per-rank work (JAX divides its cotangent by the size of the
    axes its spec leaves out)."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _unmentioned(mesh: Mesh, spec) -> list:
    named = {a for a in spec if a is not None}
    for a in named:
        if a not in mesh.shape:
            raise ValueError(f"spec {spec} names {a!r}, not an axis of "
                             f"{mesh.axis_names}")
    return [a for a in mesh.axis_names
            if a not in named and mesh.group(a) is not None]


def _enter(x, spec, mesh: Mesh):
    if not torch.is_tensor(x):
        return x
    rest = _unmentioned(mesh, spec)
    if rest and x.requires_grad:
        x = _SumCotangent.apply(x, [mesh.group(a) for a in rest])
    if isinstance(spec, LocalSpec):
        return x
    for dim, a in enumerate(spec):
        if a is not None and mesh.group(a) is not None:
            mesh.one_slot(a)
            x = _Scatter.apply(x, dim, mesh.group(a), mesh.coord(a),
                               mesh.procs(a))
    return x


def _exit(y, spec, mesh: Mesh):
    if not torch.is_tensor(y):
        return y
    for dim in reversed(range(len(spec))):
        a = spec[dim]
        if a is not None and mesh.group(a) is not None:
            y = _Gather.apply(y, dim, mesh.group(a), mesh.coord(a))
    rest = _unmentioned(mesh, spec)
    if rest and y.requires_grad:
        y = _ScaleCotangent.apply(
            y, 1.0 / math.prod(mesh.procs(a) for a in rest))
    return y


def _map_spec(fn, tree, spec, mesh):
    if isinstance(spec, PartitionSpec):
        return tree_map(lambda x: fn(x, spec, mesh), tree)
    if isinstance(spec, dict):
        return {k: _map_spec(fn, tree[k], spec[k], mesh) for k in tree}
    if isinstance(spec, (list, tuple)):
        return type(tree)(_map_spec(fn, t, s, mesh)
                          for t, s in zip(tree, spec))
    raise TypeError(f"not a PartitionSpec tree: {spec!r}")


def shard_map(fn, mesh: Mesh, in_specs, out_specs):
    """``jax.shard_map`` over the port's mesh: every rank holds the whole
    arrays; each input is cut to this rank's block of the dims its spec
    names (a ``PartitionSpec`` or a tree of them matching the input),
    ``fn`` runs on the blocks with ``mesh`` current, and each output is
    gathered whole along its spec's axes.  Gradients flow through the
    boundary exactly once (see the module docstring)."""
    def mapped(*args):
        specs = in_specs if isinstance(in_specs, (list, tuple)) \
            and not isinstance(in_specs, PartitionSpec) else (in_specs,)
        if len(specs) != len(args):
            raise ValueError(f"{len(args)} inputs, {len(specs)} in_specs")
        local = [_map_spec(_enter, a, s, mesh) for a, s in zip(args, specs)]
        with mesh:
            out = fn(*local)
        return _map_spec(_exit, out, out_specs, mesh)
    return mapped


# ---------------------------------------------------------------------------
# host arrays onto the mesh
# ---------------------------------------------------------------------------

def replicated(mesh: Mesh) -> PartitionSpec:
    """The spec of a leaf every rank holds whole."""
    return PartitionSpec()


def sharded_on(mesh: Mesh, axis: str = WORKERS) -> PartitionSpec:
    """The spec of a leaf whose leading dim is split over ``axis``."""
    return PartitionSpec(axis)


def _to_tensor(x, device) -> torch.Tensor:
    t = x if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(x))
    return t.to(device)


def host_to_mesh(mesh: Mesh, tree, axis: str = WORKERS):
    """A host tree whose leaves' leading dim runs over the slots of
    ``axis``: this rank takes only its own slots' rows, onto its device
    — Spark shipping each executor its partitions."""
    rows = mesh.local_slots(axis)

    def put(x):
        if x.shape[0] != mesh.shape[axis]:
            raise ValueError(f"leading dim {x.shape[0]} is not the "
                             f"{axis!r} axis' {mesh.shape[axis]} slots")
        return _to_tensor(x[rows.start:rows.stop], mesh.device)
    return tree_map(put, tree)


def broadcast_to_mesh(mesh: Mesh, tree):
    """A host tree every rank holds whole, on its device (the pull of
    the center down to every worker).  Each rank makes it from the same
    seed, so no bytes move."""
    return tree_map(lambda x: _to_tensor(x, mesh.device), tree)
