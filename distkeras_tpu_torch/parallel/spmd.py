"""dp × mp training over a mesh of processes — the port of
``distkeras_tpu.parallel.spmd``.

The JAX package annotates parameter and batch shardings and lets XLA's
SPMD partitioner insert the collectives: the gradient all-reduce over
``dp`` falls out of the batch being sharded there, and large kernels
are split over ``mp``.  PyTorch's counterpart of that partitioner is
DTensor, but its functional all-gather crashes the process on CUDA
tensors over a gloo group (``python -m distkeras_tpu_torch.parallel.
gloo_probe``: ``funcol_all_gather`` and ``dtensor`` end in SIGSEGV on an
H100 with torch 2.11, where the ``mesh`` phase runs two ranks on one
card).  So the port writes dp × mp with its own explicit collectives
(``parallel.mesh``), on every device alike:

* **Placement.**  Every rank builds the same host array from the same
  seed and keeps only its own block of each dim its ``PartitionSpec``
  names (:func:`put`), so no bytes move — the JAX package's
  ``make_array_from_callback`` contract and ``mesh.host_to_mesh``'s.
  :func:`infer_param_specs` is the JAX rule: a kernel's largest dim
  divisible by the ``mp`` size is split over ``mp`` (a 4-D HWIO conv
  kernel's channel dims only), small or 1-D leaves stay whole.  The
  parameters and the optimizer's state of a split leaf take 1/mp of its
  bytes on each rank (:func:`sharding_report`).
* **The forward** (:func:`constrained_model`) runs on this rank's block
  of the batch (split over ``dp``; whole over every other axis: the
  JAX wrapper's anchor pair).  A ``Dense`` layer whose kernel is split
  splits its product as Megatron does: along the output features
  (column) each rank computes its block of the output and the blocks
  are all-gathered; along the input features (row) each multiplies its
  block of the input and the partial products are ``psum``med.  Every
  other split parameter (embedding tables, attention projections, conv
  kernels) is all-gathered over ``mp`` at its use and its layer runs
  replicated over ``mp``, as DTensor's conv rule runs a channel-split
  kernel; that gather's backward takes this rank's block of the
  gradient, which every ``mp`` rank computed alike.  Each parameter's
  gradient is averaged over ``dp`` (the all-reduce XLA inserts), so the
  optimizer steps on the global batch's gradient (Adam's g² on an
  unreduced gradient would be wrong).  BatchNorm's statistics are the
  global batch's: ``pmean`` over ``dp``, as GSPMD computes them.
  Attention (K1–K3 on the card) runs on plain local tensors: q, k, v
  split over the batch on ``dp``, whole on ``mp``.

Collectives run over the mesh's process groups and are counted by
``mesh.collective_stats()``.  With one process every axis has one rank
and nothing communicates.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from . import mesh as mesh_lib
from .mesh import Mesh, PartitionSpec

P = PartitionSpec
Tree = Any


def _is_leaf(x) -> bool:
    return x is None or isinstance(x, PartitionSpec) or torch.is_tensor(x) \
        or isinstance(x, np.ndarray) or np.isscalar(x)


def _tmap(fn, tree, *rest):
    """Leafwise map whose leaves are arrays, tensors and specs (a
    ``PartitionSpec`` is a tuple, and stays one leaf here)."""
    if _is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _tmap(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    out = [_tmap(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]
    return out if isinstance(tree, list) else tuple(out)


def _paths(tree, prefix: str = ""):
    """``(keystr, leaf)`` pairs in ``jax.tree_util`` order, the paths
    spelled as ``jax.tree_util.keystr`` spells them (``[0]['kernel']``)."""
    if _is_leaf(tree):
        return [] if tree is None else [(prefix, tree)]
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _paths(tree[k], f"{prefix}[{k!r}]")]
    return [p for i, t in enumerate(tree) for p in _paths(t, f"{prefix}[{i}]")]


def spec_str(spec: PartitionSpec) -> str:
    """``str(jax.sharding.PartitionSpec(...))`` of the same spec."""
    return f"PartitionSpec{tuple(spec)!r}"


def infer_param_specs(params: Tree, mesh: Mesh, tp_axis: str = "mp",
                      min_size: int = 2048) -> Tree:
    """The JAX package's tensor-parallel rule: each leaf of at least two
    dims and ``min_size`` elements is split over ``tp_axis`` along its
    largest dim divisible by the axis size (the first such, on a tie);
    a 4-D (HWIO) conv kernel only along its channel dims, since a split
    spatial extent would cut the stencil.  Everything else (biases, norm
    scales, small or indivisible kernels) stays whole: ``P()``."""
    if tp_axis not in mesh.axis_names:
        return _tmap(lambda _: P(), params)
    tp = mesh.shape[tp_axis]

    def spec(leaf):
        shape = tuple(leaf.shape)
        if len(shape) < 2 or math.prod(shape) < min_size:
            return P()
        dims = range(len(shape) - 2, len(shape)) if len(shape) == 4 \
            else range(len(shape))
        best = max((d for d in dims if shape[d] % tp == 0),
                   key=lambda d: shape[d], default=None)
        if best is None:
            return P()
        parts = [None] * len(shape)
        parts[best] = tp_axis
        return P(*parts)

    return _tmap(spec, params)


def _block(x: torch.Tensor, spec: PartitionSpec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the whole ``x`` along each dim ``spec``
    names."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        p = mesh.procs(axis)
        n = x.shape[dim]
        if n % p:
            raise ValueError(f"dim {dim} of size {n} does not split over "
                             f"the {p} ranks of {axis!r}")
        x = x.narrow(dim, mesh.coord(axis) * (n // p), n // p)
    return x


def put(x, mesh: Mesh, spec: PartitionSpec = P()) -> torch.Tensor:
    """A host array (the same on every rank) committed to the mesh by
    ``spec``: this rank's block of it, on the rank's device."""
    t = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
    return _block(t, spec, mesh).contiguous().to(mesh.device)


def place(tree: Tree, mesh: Mesh, specs: Tree) -> Tree:
    """Commit a tree by a tree of ``PartitionSpec``s (see :func:`put`)."""
    return _tmap(lambda x, s: put(x, mesh, s), tree, specs)


def replicate(tree: Tree, mesh: Mesh) -> Tree:
    """Every rank holds every leaf whole, on its device."""
    return _tmap(lambda x: put(x, mesh), tree)


def batch_sharding(mesh: Mesh, dp_axis: str = "dp",
                   batch_dim: int = 0) -> PartitionSpec:
    """The spec of a batch split over ``dp_axis`` along ``batch_dim``."""
    parts = [None] * (batch_dim + 1)
    parts[batch_dim] = dp_axis
    return P(*parts)


def gather_whole(x: torch.Tensor, spec: PartitionSpec,
                 mesh: Mesh) -> torch.Tensor:
    """The whole array of which ``x`` is this rank's block by ``spec``
    (no autograd): the inverse of :func:`put`."""
    for dim in reversed(range(len(spec))):
        axis = spec[dim]
        if axis is not None and mesh.group(axis) is not None:
            parts = mesh_lib._all_gather(x.contiguous(), mesh.group(axis))
            x = torch.cat(parts.unbind(0), dim=dim)
    return x


# ---------------------------------------------------------------------------
# the forward over the mesh
# ---------------------------------------------------------------------------

class _GradMean(torch.autograd.Function):
    """Identity whose backward averages the gradient over ``group``: a
    parameter every rank of a batch-split axis holds alike."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return mesh_lib._all_reduce(g.contiguous(), ctx.group) / ctx.n, \
            None, None


def _used(p: torch.Tensor, spec: PartitionSpec, mesh: Mesh,
          dp_axis: str, compute_dtype, gather: bool = True) -> torch.Tensor:
    """Parameter block ``p`` as the forward uses it: its gradient
    averaged over ``dp``, cast to ``compute_dtype`` (the optimizer keeps
    the f32 block) and, with ``gather``, gathered whole over the axes
    ``spec`` names, each gather's backward taking this rank's block."""
    group = mesh.group(dp_axis) if dp_axis in mesh.shape else None
    if group is not None and p.requires_grad:
        p = _GradMean.apply(p, group, mesh.procs(dp_axis))
    if compute_dtype is not None and p.is_floating_point():
        p = p.to(compute_dtype)
    if not gather:
        return p
    for dim in reversed(range(len(spec))):
        axis = spec[dim]
        if axis is not None and mesh.group(axis) is not None:
            p = mesh_lib._Gather.apply(p, dim, mesh.group(axis),
                                       mesh.coord(axis))
    return p


class _ReduceForward(torch.autograd.Function):
    """``psum`` whose backward is the identity: a row-split product's
    partial sums, added over ``group``, whose cotangent every rank of the
    group already holds whole."""

    @staticmethod
    def forward(ctx, x, group):
        return mesh_lib._all_reduce(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _split_dense(lyr, dim: int, mesh: Mesh, axis: str, x):
    """``Dense`` ``lyr``'s forward with its kernel split over ``axis``
    (``lyr.kernel`` is this rank's block): along its output features
    (``dim`` 1, column) this rank computes its block of the output and
    the blocks are gathered; along its input features (``dim`` 0, row)
    it multiplies its block of ``x`` and the partial products are
    summed (in f32).  ``x`` and the bias are whole on every rank of
    ``axis``; their gradients, which each rank computes for its block
    alone, are summed over it."""
    group, me = mesh.group(axis), mesh.coord(axis)
    if x.requires_grad:
        x = mesh_lib._SumCotangent.apply(x, [group])
    kernel = lyr.kernel.to(x.dtype)
    bias = lyr.bias.to(x.dtype) if lyr.use_bias else None
    rowwise = lyr.activation in ("softmax", "log_softmax")
    if dim == 1:
        n = kernel.shape[1]
        y = x @ kernel
        if bias is not None:
            if bias.requires_grad:
                bias = mesh_lib._SumCotangent.apply(bias, [group])
            y = y + bias.narrow(0, me * n, n)
        if not rowwise:  # an elementwise activation commutes with the split
            y = lyr._act(y)
        y = mesh_lib._Gather.apply(y, y.ndim - 1, group, me)
        return lyr._act(y) if rowwise else y
    n = kernel.shape[0]
    part = x.narrow(-1, me * n, n) @ kernel
    y = _ReduceForward.apply(part.to(torch.float32), group).to(part.dtype)
    if bias is not None:
        y = y + bias
    return lyr._act(y)


def _split_products(model, specs: Dict[str, PartitionSpec], mesh: Mesh):
    """``{module name: (dim, axis)}`` of the ``Dense`` layers of ``model``
    whose kernel ``specs`` splits over an axis of more than one rank."""
    from ..models.layers import Dense
    out = {}
    for name, mod in model.named_modules():
        if isinstance(mod, Dense):
            spec = specs.get(f"{name}.kernel", P())
            for dim, axis in enumerate(spec):
                if axis is not None and mesh.group(axis) is not None:
                    out[name] = (dim, axis)
    return out


@contextlib.contextmanager
def _products_over(model, split: dict, mesh: Mesh):
    """The split ``Dense`` layers run :func:`_split_dense` for the
    duration."""
    layers = [(model.get_submodule(name), dim, axis)
              for name, (dim, axis) in split.items()]
    for lyr, dim, axis in layers:
        lyr.forward = functools.partial(_split_dense, lyr, dim, mesh, axis)
    try:
        yield
    finally:
        for lyr, _, _ in layers:
            del lyr.forward


@contextlib.contextmanager
def _batch_norm_over(model, axis: str):
    """BatchNorm layers without an ``axis_name`` share their statistics
    over ``axis`` for the duration (the batch is split there)."""
    from ..models.layers import BatchNorm
    layers = [lyr for lyr in model.iter_layers()
              if isinstance(lyr, BatchNorm) and lyr.axis_name is None]
    for lyr in layers:
        lyr.batch_axis = axis
    try:
        yield
    finally:
        for lyr in layers:
            lyr.batch_axis = None


class _ConstrainedForward(nn.Module):
    """``model``'s forward over the mesh (see the module docstring):
    this rank's batch block in, its block of the output out."""

    def __init__(self, model, mesh: Mesh, dp_axis: str,
                 specs: Dict[str, PartitionSpec], compute_dtype=None):
        super().__init__()
        self.model = model
        self.mesh = mesh
        self.dp_axis = dp_axis
        self.specs = specs
        self.compute_dtype = compute_dtype

    def iter_layers(self):
        return self.model.iter_layers()

    def forward(self, x):
        if self.compute_dtype is not None and x.is_floating_point():
            x = x.to(self.compute_dtype)
        split = _split_products(self.model, self.specs, self.mesh)
        kept = {f"{name}.kernel" for name in split}
        used = {n: _used(p, self.specs.get(n, P()), self.mesh, self.dp_axis,
                         self.compute_dtype, gather=n not in kept)
                for n, p in self.model.named_parameters()}
        with self.mesh, _batch_norm_over(self.model, self.dp_axis), \
                _products_over(self.model, split, self.mesh):
            return functional_call(self.model, used, (x,))


def constrained_model(model, mesh: Mesh, dp_axis: str = "dp",
                      specs: Optional[Dict[str, PartitionSpec]] = None,
                      compute_dtype=None) -> nn.Module:
    """``model``'s forward over ``mesh``, as a module the window loop
    steps (``make_window_fn``): ``specs`` gives each parameter's
    placement by name (whole when absent), ``compute_dtype`` the mixed-
    precision cast, applied inside (the gradient average stays in the
    f32 masters' dtype)."""
    return _ConstrainedForward(model, mesh, dp_axis,
                               {} if specs is None else specs,
                               compute_dtype)


# ---------------------------------------------------------------------------
# a model's parameters on the mesh
# ---------------------------------------------------------------------------

def _set_param(model, name: str, value: torch.Tensor) -> None:
    mod_name, _, leaf = name.rpartition(".")
    setattr(model.get_submodule(mod_name), leaf, nn.Parameter(value))


def _split(spec: PartitionSpec) -> bool:
    return any(a is not None for a in spec)


def shard_model(model, mesh: Mesh, specs: Dict[str, PartitionSpec]) -> None:
    """Replace each parameter of ``model`` that ``specs`` (by parameter
    name) splits by this rank's block of it; every rank holds the same
    whole model before."""
    named = dict(model.named_parameters())
    for name, spec in specs.items():
        if _split(spec):
            _set_param(model, name,
                       _block(named[name].detach(), spec, mesh).clone())


def unshard_model(model, mesh: Mesh, specs: Dict[str, PartitionSpec]) -> None:
    """The inverse of :func:`shard_model`: every rank ends with the whole
    parameters."""
    named = dict(model.named_parameters())
    for name, spec in specs.items():
        if _split(spec):
            _set_param(model, name,
                       gather_whole(named[name].detach(), spec, mesh))


def sharding_report(params: Tree, specs: Tree, mesh: Mesh) -> dict:
    """Per-leaf placement audit, key for key the JAX package's
    (``keystr`` paths): the spec, the leaf's global bytes and the bytes
    this rank holds.  ``per_device_bytes < global_bytes`` is the evidence
    that ``mp`` split something (a replicated leaf shows equality).
    ``params`` holds this rank's blocks, ``specs`` their specs."""
    rows = {}
    total_global = total_local = 0
    spec_at = dict(_paths(specs))
    for path, leaf in _paths(params):
        spec = spec_at[path]
        local = leaf.numel() * leaf.element_size()
        whole = local * math.prod(mesh.procs(a) for a in spec
                                  if a is not None)
        rows[path] = {"spec": spec_str(spec), "global_bytes": int(whole),
                      "per_device_bytes": int(local)}
        total_global += whole
        total_local += local
    return {"params": rows, "global_bytes": int(total_global),
            "per_device_bytes": int(total_local)}
