"""The local minibatch step and the window loop — the port's share of
``distkeras_tpu.parallel.sync`` (``make_local_step``, ``make_window_fn``).

The JAX package scans a jit-compiled ``value_and_grad`` + optax update
over a window of batches, carrying a pure ``(variables, opt_state, rng)``
tree.  Here the parameters are the model's own ``nn.Parameter``s, keyed
by name (``model_params``); a step runs the forward, takes the gradients
with ``torch.autograd.grad`` and applies the optimizer's updates to the
parameters in place under ``torch.no_grad()`` (JAX donates the carry
buffers for the same effect).  The window is a Python loop over the
leading steps axis whose per-step losses stay on the device, stacked:
nothing in it reads a value back to the host.

The forward runs in train mode (the model is switched for the window and
back after it).  Where JAX carries an rng key, the port carries a
``torch.Generator`` on the model's device, handed to the layers that draw
(Dropout); where JAX returns a new ``state`` tree, each stateful layer
records its new state in the forward and ``commit_state`` copies it into
the buffers after the update, as the JAX step replaces ``state`` after
its update.

The window-edge communication rules (``AdagSync`` and the rest) and
``SyncEngine`` are the sync distributed trainers' share.  JAX runs the W
workers as one program over a ``workers`` mesh axis and communicates with
``lax.pmean``/``lax.psum``; the port keeps every variable leaf of a
process's workers as one stacked (workers, …) tensor, steps those worker
models (each one's parameters and state buffers are views into that
stack) one after another through the window loop above, and applies the
rule at the window edge as a mean or sum over dim 0, one op per leaf.
With a ``mesh`` (``parallel.mesh``) the W workers are spread over the
processes of the ``workers`` axis, each holding its slots' workers, and
the edge's sum is the local stack's sum followed by a ``psum`` over the
axis (``WorkerAxis``): the center ends up the same on every rank.
Center and local trees hold the parameters **and** the state (BatchNorm's
running statistics), as the reference's ``get_weights()`` does; the rules
act on floating leaves only.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..models.layers import commit_state, set_generator
from ..utils.tree import tree_map

Params = Dict[str, torch.Tensor]
Tree = Any


# ---------------------------------------------------------------------------
# tree helpers
# ---------------------------------------------------------------------------

#: the JAX package's name for a leafwise map over trees
tmap = tree_map


def tree_sub(a, b):
    return tmap(lambda x, y: x - y, a, b)


def tree_add(a, b):
    return tmap(lambda x, y: x + y, a, b)


def tree_scale(a, s):
    return tmap(lambda x: x * s, a)


def _inexact(x) -> bool:
    """Communication rules act on floating-point leaves only: integer and
    bool state has no meaningful average or sum and keeps its dtype and
    worker-local value across window edges.  Works on tensor and numpy
    leaves alike."""
    if torch.is_tensor(x):
        return x.is_floating_point() or x.is_complex()
    return bool(np.issubdtype(np.asarray(x).dtype, np.inexact))


def adopt_float_leaves(source: Tree, local: Tree) -> Tree:
    """``local`` with its floating leaves replaced by ``source``'s; integer
    and bool leaves keep the local value (see ``_inexact``).  The one
    merge rule of every window edge."""
    return tmap(lambda s, l: s if _inexact(l) else l, source, local)


def variables_of(model) -> Tree:
    """``{"params": {name: parameter}, "state": {name: buffer}}``: the
    model's own tensors (not copies), the tree the rules and the engine
    act on."""
    return {"params": dict(model.named_parameters()),
            "state": dict(model.named_buffers())}


def model_params(model) -> Params:
    """The model's parameters by name: the tree the optimizer and the
    step update (in place)."""
    return dict(model.named_parameters())


def aux_losses(model) -> list:
    """Every auxiliary loss a layer of ``model`` recorded in its last
    training forward (``live_aux_loss``: the switch-MoE router's
    load-balance loss, ``ops.moe.MoEDense``), live in the autograd graph
    — the JAX package's ``aux_loss`` leaves of the new state.  The records
    are taken: each layer's is cleared, so no graph outlives its step."""
    out = []
    for lyr in model.iter_layers():
        aux = getattr(lyr, "live_aux_loss", None)
        if aux is not None:
            out.append(aux)
            lyr.live_aux_loss = None
    return out


def _replay(gen: Optional[torch.Generator]):
    """``context_fn`` for ``checkpoint``: the recompute in the backward
    draws from ``gen`` as the forward did (``preserve_rng_state`` covers
    the global generators only), and leaves ``gen`` where the forward
    left it."""
    if gen is None:
        return contextlib.nullcontext(), contextlib.nullcontext()
    start = gen.get_state()

    @contextlib.contextmanager
    def recompute():
        after = gen.get_state()
        gen.set_state(start)
        try:
            yield
        finally:
            gen.set_state(after)

    return contextlib.nullcontext(), recompute()


def make_local_step(model, loss_fn: Callable, optimizer,  # dklint: hot
                    compute_dtype=None, remat: bool = False,
                    aux_weight: float = 0.0,
                    generator: Optional[torch.Generator] = None):
    """One minibatch of local optimization:
    ``step(params, opt_state, x, y) -> (opt_state, loss)``, with
    ``params`` (``model_params(model)``) updated in place, the layers'
    state committed after the update, and ``loss`` a 0-d tensor on the
    device.  The caller puts the model in train mode; ``generator``
    feeds the layers that draw random numbers.

    ``compute_dtype`` (mixed precision): the forward runs on cast copies
    of the floating parameters (and of a floating ``x``), made inside the
    autograd graph, so the gradients land on the f32 masters that the
    optimizer updates.  ``remat=True`` wraps the forward in a
    (non-reentrant) activation checkpoint: activations are recomputed in
    the backward instead of kept, with the same random draws, and state
    is committed once.  ``aux_weight > 0`` adds
    ``aux_weight * Σ aux_losses`` to the objective.
    """
    set_generator(model, generator)

    def forward(x):
        if compute_dtype is None:
            return model(x)
        cast = {n: p.to(compute_dtype) if p.is_floating_point() else p
                for n, p in model.named_parameters()}
        return functional_call(model, cast, (x,))

    def step(params: Params, opt_state, x, y):
        if compute_dtype is not None and x.is_floating_point():
            x = x.to(compute_dtype)
        names = list(params)
        with torch.enable_grad():
            out = checkpoint(forward, x, use_reentrant=False,
                             context_fn=lambda: _replay(generator)) \
                if remat else forward(x)
            loss = loss_fn(out, y)
            aux = aux_losses(model)
            if aux_weight and aux:
                loss = loss + aux_weight * sum(aux)
            grads = torch.autograd.grad(loss, [params[n] for n in names],
                                        allow_unused=True)
        # an unused parameter's gradient is zero, as JAX gives it
        grads = {n: torch.zeros_like(params[n]) if g is None else g
                 for n, g in zip(names, grads)}
        updates, opt_state = optimizer.update(grads, opt_state, params)
        with torch.no_grad():
            tree_map(lambda p, u: p.add_(u.to(p.dtype)), params, updates)
        commit_state(model)
        return opt_state, loss.detach()

    return step


def make_window_fn(model, loss_fn, optimizer, compute_dtype=None,  # dklint: hot
                   remat: bool = False, aux_weight: float = 0.0,
                   generator: Optional[torch.Generator] = None):
    """The window loop: ``run(params, opt_state, xs, ys) -> (params,
    opt_state, losses)`` over the leading (steps) axis of ``xs``/``ys``,
    in train mode (eval mode again on return); ``losses`` is a (steps,)
    float32 tensor on the device."""
    step = make_local_step(model, loss_fn, optimizer, compute_dtype, remat,
                           aux_weight, generator)

    def run(params: Params, opt_state, xs, ys):
        losses = []
        model.train(True)
        try:
            for i in range(xs.shape[0]):
                opt_state, loss = step(params, opt_state, xs[i], ys[i])
                losses.append(loss)
        finally:
            model.train(False)
        return params, opt_state, torch.stack(losses).float()

    return run


# ---------------------------------------------------------------------------
# communication rules (one per reference algorithm)
# ---------------------------------------------------------------------------

def _pull(center: Tree, local: Tree) -> Tree:
    """Every worker re-pulls ``center``: ``local``'s floating leaves
    become ``center``'s, broadcast along the worker axis."""
    return adopt_float_leaves(
        tmap(lambda c, l: c.expand_as(l) if _inexact(l) else c,
             center, local), local)


class WorkerAxis:
    """The reduction over the workers of a window edge, for a process
    that holds every worker: the stack's dim 0."""

    def sum(self, x):
        return x.sum(0)

    def mean(self, x):
        return x.mean(0)


#: every worker in this process (no mesh)
STACK = WorkerAxis()


class MeshWorkerAxis(WorkerAxis):
    """The reduction over the workers of a mesh's ``axis``: this rank's
    stack summed over dim 0, then ``psum`` over the axis's ranks."""

    def __init__(self, mesh, axis: str = "workers"):
        self.mesh, self.axis = mesh, axis

    def sum(self, x):
        from .mesh import sum_slots
        return sum_slots(x, self.axis, self.mesh)

    def mean(self, x):
        return self.sum(x) / self.mesh.shape[self.axis]


class SyncAlgorithm:
    """Window-edge communication rule.

    ``communicate(center, local, axis)`` takes the center tree and the
    workers' tree, whose every leaf carries a leading worker axis
    (workers, …), and returns ``(new_center, new_local)`` shaped as they
    are.  It runs under ``torch.no_grad()`` and reads nothing back to the
    host; where the JAX package's ``lax.pmean``/``lax.psum`` reduce over
    the mesh's ``workers`` axis, the port reduces with ``axis``
    (``STACK``: dim 0; ``MeshWorkerAxis``: dim 0, then over the mesh).
    """

    name = "base"

    def communicate(self, center: Tree, local: Tree, axis=STACK):
        raise NotImplementedError


class NoCommSync(SyncAlgorithm):
    """No inter-worker communication (AveragingTrainer / EnsembleTrainer):
    workers train fully independently; any averaging happens after
    training (reference ``AveragingTrainer.average_models``)."""

    name = "none"

    def communicate(self, center, local, axis=STACK):
        return center, local


class AdagSync(SyncAlgorithm):
    """ADAG (reference ``ADAGWorker`` + ``ADAGParameterServer``): workers
    accumulate a window of updates and commit the accumulated delta
    normalized by the worker count.  Synchronous limit: center ← center +
    mean_k(local_k − center) ≡ the mean of the worker models; workers
    re-pull the new center."""

    name = "adag"

    def communicate(self, center, local, axis=STACK):
        new_center = tmap(lambda c, l: axis.mean(l) if _inexact(l) else c,
                          center, local)
        return new_center, _pull(new_center, local)


class DownpourSync(SyncAlgorithm):
    """DOWNPOUR (reference ``DOWNPOURWorker`` + ``DeltaParameterServer``):
    each worker commits Δ_k = local_k − center and the server adds every
    commit in full (no normalization).  Synchronous limit: center ←
    center + Σ_k Δ_k; workers re-pull."""

    name = "downpour"

    def communicate(self, center, local, axis=STACK):
        new_center = tmap(
            lambda c, l: c + axis.sum(l - c) if _inexact(l) else c,
            center, local)
        return new_center, _pull(new_center, local)


class DynSgdSync(SyncAlgorithm):
    """DynSGD (reference ``DynSGDParameterServer``): commits scaled by
    1/(staleness+1).  Every window edge is a barrier here, so staleness
    ≡ 0 and the scale is 1: DOWNPOUR's rule.  The staleness-sensitive
    form belongs to the async parameter server."""

    name = "dynsgd"
    staleness = 0

    def communicate(self, center, local, axis=STACK):
        scale = 1.0 / (self.staleness + 1)
        new_center = tmap(
            lambda c, l: c + axis.sum((l - c) * scale) if _inexact(l)
            else c, center, local)
        return new_center, _pull(new_center, local)


class EasgdSync(SyncAlgorithm):
    """EASGD elastic averaging (reference ``AEASGDWorker`` /
    ``EAMSGDWorker``; Zhang, Choromanska, LeCun 2015): every τ steps the
    elastic force E_k = α(local_k − center), from the center before the
    edge, pulls the worker toward the center and the center toward the
    workers:
        local_k ← local_k − E_k ;  center ← center + Σ_k E_k.
    Workers KEEP their local model across windows — the one family where
    local ≠ center by design.  EAMSGD differs only in the local optimizer
    (Nesterov momentum), not in this rule."""

    name = "easgd"

    def __init__(self, alpha: float):
        self.alpha = float(alpha)

    def communicate(self, center, local, axis=STACK):
        new_center = tmap(
            lambda c, l: c + axis.sum(self.alpha * (l - c))
            if _inexact(l) else c, center, local)
        new_local = tmap(
            lambda c, l: l - self.alpha * (l - c) if _inexact(l) else l,
            center, local)
        return new_center, new_local


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

class EpochResult(NamedTuple):
    """What an epoch (or one window) leaves: the trees, updated in place,
    the per-worker optimizer states and the losses, (workers, n_windows,
    window) from ``epoch_fn`` or (workers, window) from ``window_fn``."""
    center: Tree
    local: Tree
    opt_state: List[Any]
    losses: torch.Tensor


def stack_trees(trees: List[Tree]) -> Tree:
    """W variables trees → one tree of stacked (W, …) tensors (copies)."""
    return tmap(lambda *xs: torch.stack([x.detach() for x in xs]), *trees)


def replicate(center: Tree, num_workers: int) -> Tree:
    """The local tree of ``num_workers`` workers that all start from
    ``center``: each leaf copied into a (W, …) tensor."""
    return tmap(lambda c: c.detach().unsqueeze(0).repeat(
        num_workers, *([1] * c.dim())), center)


def _assign(dst: Tree, src: Tree) -> None:
    """Copy ``src``'s leaves into ``dst``'s tensors in place (broadcasting
    along the worker axis); a leaf that is its own source is left."""
    tmap(lambda d, s: None if d is s else d.copy_(s), dst, src)


def _bind(model, local: Tree, k: int) -> None:
    """Make worker ``k``'s slice of ``local`` the parameters and state
    buffers of ``model``: each becomes a view into its stacked leaf, so
    the optimizer's in-place update and ``commit_state`` write the stack
    and the window edge reads it without a copy."""
    params = {id(p): nn.Parameter(local["params"][n][k],
                                  requires_grad=p.requires_grad)
              for n, p in model.named_parameters()}
    buffers = {id(b): local["state"][n][k]
               for n, b in model.named_buffers()}
    for mod in model.modules():
        for key, p in list(mod._parameters.items()):
            if p is not None:
                mod._parameters[key] = params[id(p)]
        for key, b in list(mod._buffers.items()):
            if b is not None:
                mod._buffers[key] = buffers[id(b)]


class SyncEngine:
    """The synchronous epoch over W workers, for a (model, loss,
    optimizer, algorithm) tuple.

    This process's workers — all W, or with a ``mesh`` the slots of its
    ``axis`` this rank holds (``local_workers``) — are built from
    ``model.config()`` at the first call, on the device of the ``local``
    tree they are handed, and bound to it (``_bind``): worker k trains
    slice k of every stacked leaf in place.  Each worker has its own
    ``torch.Generator`` on that device (``rngs``), which feeds its
    Dropout draws: ``seed(s)`` seeds global worker g's with ``s + g·2³²``,
    so worker 0 draws what a ``SingleTrainer`` seeded with ``s`` draws.
    A window runs the workers one after another through
    ``make_window_fn`` (with the mesh current, for the layers that
    communicate inside a forward), then the rule at the edge; nothing in
    the window reads a value back to the host.
    """

    def __init__(self, model, loss_fn: Callable, optimizer,
                 algo: SyncAlgorithm, num_workers: int, window: int,
                 mesh=None, axis: str = "workers", compute_dtype=None,
                 remat: bool = False, aux_weight: float = 0.0):
        if mesh is not None and mesh.shape.get(axis) != int(num_workers):
            raise ValueError(
                f"mesh axis {axis!r} holds {mesh.shape.get(axis)} slots, "
                f"not the {num_workers} workers")
        self.mesh = mesh
        self.local_workers = int(num_workers) if mesh is None \
            else mesh.slots(axis)
        self.first_worker = 0 if mesh is None else mesh.axis_index(axis)
        self.worker_axis = STACK if mesh is None \
            else MeshWorkerAxis(mesh, axis)
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.algo = algo
        self.num_workers = int(num_workers)
        self.window = int(window)
        self.axis = axis
        self.compute_dtype = compute_dtype
        self.remat = bool(remat)
        self.aux_weight = float(aux_weight)
        self.workers: Optional[list] = None
        self.rngs: Optional[List[torch.Generator]] = None
        self._runs: list = []
        self._params: list = []
        self._bound: Optional[Tree] = None

    # -- workers --------------------------------------------------------------
    def _build(self, device) -> None:
        cfg = self.model.config()
        self.workers, self.rngs, self._runs = [], [], []
        for _ in range(self.local_workers):
            worker = type(self.model).from_config(cfg).init(0, device=device)
            gen = torch.Generator(device=device)
            self.workers.append(worker)
            self.rngs.append(gen)
            self._runs.append(make_window_fn(
                worker, self.loss_fn, self.optimizer, self.compute_dtype,
                self.remat, self.aux_weight, generator=gen))

    def bind(self, local: Tree) -> None:
        """Point the worker models at ``local`` (building them first)."""
        if self._bound is local:
            return
        leaf = next(iter(local["params"].values()))
        if self.workers is None or self.workers[0].device != leaf.device:
            self._build(leaf.device)
        for k, worker in enumerate(self.workers):
            _bind(worker, local, k)
        self._params = [model_params(w) for w in self.workers]
        self._bound = local

    def seed(self, seed: int) -> None:
        """Seed global worker g's generator with ``seed + g·2³²``."""
        for k, gen in enumerate(self.rngs):
            gen.manual_seed(int(seed) + ((self.first_worker + k) << 32))

    def init_opt_state(self) -> list:
        """A fresh optimizer state per worker (``jax.vmap(optimizer.init)``
        of the reference)."""
        return [self.optimizer.init(p) for p in self._params]

    # -- the window and its edge --------------------------------------------
    def edge(self, center: Tree, local: Tree) -> None:
        """The rule at the window edge, written into ``center`` and
        ``local`` in place."""
        with torch.no_grad():
            new_center, new_local = self.algo.communicate(
                center, local, self.worker_axis)
            _assign(center, new_center)
            _assign(local, new_local)

    def local_steps(self, local, opt_state, wx, wy) -> torch.Tensor:
        """One window of local steps on every worker, without the edge:
        worker k trains slice k of ``local`` on ``wx[k]``/``wy[k]``
        (window, batch, …), updating ``opt_state[k]``.  Returns the
        losses, (workers, window) on the device."""
        self.bind(local)
        losses = []
        with self.mesh if self.mesh is not None else contextlib.nullcontext():
            for k, run in enumerate(self._runs):
                _, opt_state[k], l = run(self._params[k], opt_state[k],
                                         wx[k], wy[k])
                losses.append(l)
        return torch.stack(losses)

    def _window(self, center, local, opt_state, wx, wy) -> torch.Tensor:
        losses = self.local_steps(local, opt_state, wx, wy)
        self.edge(center, local)
        return losses

    def epoch_fn(self):
        """``run(center, local, opt_state, xs, ys) -> EpochResult``: every
        window of an epoch.  ``xs``/``ys`` are (workers, n_windows,
        window, batch, …) on the device; ``center`` and ``local`` are
        updated in place (and returned), ``opt_state`` is the list of
        per-worker states."""
        def run(center, local, opt_state, xs, ys):
            self.bind(local)
            losses = [self._window(center, local, opt_state, xs[:, w],
                                   ys[:, w]) for w in range(xs.shape[1])]
            return EpochResult(center, local, opt_state,
                               torch.stack(losses, 1))
        return run

    def window_fn(self):
        """``run(center, local, opt_state, wx, wy) -> EpochResult`` with
        losses (workers, window): a single window, ``wx``/``wy`` (workers,
        window, batch, …) — the unit the disk-streaming trainers drive."""
        def run(center, local, opt_state, wx, wy):
            self.bind(local)
            return EpochResult(center, local, opt_state,
                               self._window(center, local, opt_state, wx,
                                            wy))
        return run
