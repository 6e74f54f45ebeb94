"""Switch mixture-of-experts feed-forward — the port of
``distkeras_tpu.ops.moe``'s single-device path.

E feed-forward experts (relu MLPs) sit behind a softmax router; every
token goes to its top-1 expert (switch routing, Fedus et al. 2021), and
its output is that expert's, scaled by the token's gate.
:func:`dense_moe` is the JAX package's dense formula: every token through
every expert, the picked one kept — no capacity limit, so no token is
dropped.  The products are torch ops (``einsum``, cuBLAS on the card), as
they are XLA code in the JAX package, not a Pallas kernel.

Load-balance auxiliary loss: ``aux = E · Σ_e f_e · p_e`` (fraction of
tokens routed to e × mean router probability of e).  ``MoEDense`` keeps
it two ways: its training forward holds the live value (in the autograd
graph) for ``parallel.sync.aux_losses``, which folds
``aux_weight · Σ aux`` into the objective as the JAX package's
``make_local_step`` does, and records its detached f32 value as the new
state of the 0-d buffer ``aux_loss``, which ``commit_state`` writes after
the update — the JAX package's ``state["aux_loss"]`` leaf, so variables
trees, checkpoints, the parameter server's center and the shard plan see
the same tree in both packages.

Expert parallelism (``switch_moe`` / ``switch_moe_sharded``): the E
experts are split over the ``ep`` axis of a mesh (``parallel.mesh``),
E/P on each rank.  Each rank routes its own token shard, sends each
expert at most C = ceil(n_loc/E · capacity_factor) tokens (overflow
tokens are dropped: zero output — callers add a residual), and the
tokens go to their expert's owner and back by two ``all_to_all``s; the
aux loss's statistics are ``pmean``ed over the axis.  Every step is
differentiable.  ``switch_moe_reference`` computes the same two-sided
dispatch in one process (capacity per shard, the same drops): the oracle
of a multi-rank run.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import Layer, register

Tree = Any

def init_moe_params(generator: torch.Generator, num_experts: int,
                    d_model: int, d_hidden: int) -> Tree:
    """Router and E expert FFNs, in the JAX package's layout: the router
    ``wg`` is (d, E); the experts' ``w1`` (E, d, h), ``b1`` (E, h), ``w2``
    (E, h, d) and ``b2`` (E, d), each with a leading (E,) axis.  Normal
    weights scaled by 1/√fan-in, from ``generator``; zero biases."""
    s1 = 1.0 / math.sqrt(d_model)
    s2 = 1.0 / math.sqrt(d_hidden)

    def normal(*shape):
        return torch.randn(shape, generator=generator)

    return {
        "router": {"wg": normal(d_model, num_experts) * s1},
        "experts": {
            "w1": normal(num_experts, d_model, d_hidden) * s1,
            "b1": torch.zeros(num_experts, d_hidden),
            "w2": normal(num_experts, d_hidden, d_model) * s2,
            "b2": torch.zeros(num_experts, d_model),
        },
    }


def route(params: Tree, x: torch.Tensor):
    """``(gates (n, E), expert index (n,))``: the router's softmax and
    each token's top-1 expert (the first of equal maxima, as
    ``jnp.argmax``)."""
    gates = torch.softmax(x @ params["router"]["wg"], dim=-1)
    return gates, torch.argmax(gates, dim=-1)


def dense_moe(params: Tree, x: torch.Tensor):
    """Every token (``x``: (n, d)) through its top-1 expert, no capacity
    limit: ``(out (n, d), aux scalar)``, in ``x``'s dtype (the parameters
    must be in it too).  The one-hot of the routing is in the token dtype,
    as in the JAX package."""
    ex = params["experts"]
    gates, idx = route(params, x)
    gate = torch.gather(gates, 1, idx[:, None])[:, 0]
    h = torch.relu(torch.einsum("nd,edh->neh", x, ex["w1"]) + ex["b1"])
    y = torch.einsum("neh,ehd->ned", h, ex["w2"]) + ex["b2"]
    picked = torch.gather(
        y, 1, idx[:, None, None].expand(-1, 1, y.shape[-1]))[:, 0]
    num_experts = gates.shape[-1]
    onehot = F.one_hot(idx, num_experts).to(x.dtype)
    aux = num_experts * torch.sum(onehot.mean(0) * gates.mean(0))
    return gate[:, None] * picked, aux


def _capacity(n_loc: int, num_experts: int, capacity_factor: float) -> int:
    return max(1, math.ceil(n_loc / num_experts * capacity_factor))


def _dispatch(gates, idx, num_experts: int, cap: int, dtype):
    """(dispatch (n, E, C), gate (n,), onehot (n, E)): each kept token's
    one slot in its expert's send buffer, in arrival order (int32 slot
    bookkeeping: a bf16 count is not exact past 256)."""
    onehot_i = F.one_hot(idx, num_experts).to(torch.int32)
    pos = (torch.cumsum(onehot_i, dim=0) - 1) * onehot_i
    keep = (pos < cap).to(dtype)
    onehot = onehot_i.to(dtype)
    slot = F.one_hot(pos.clamp(max=cap - 1).long(), cap).to(dtype)
    dispatch = onehot[..., None] * keep[..., None] * slot
    gate = torch.gather(gates, 1, idx[:, None])[:, 0]
    return dispatch, gate, onehot


def _experts(ex: Tree, tokens):
    """(E_loc, G, d) tokens through their experts' FFNs."""
    h = torch.relu(torch.einsum("egd,edh->egh", tokens, ex["w1"])
                   + ex["b1"][:, None])
    return torch.einsum("egh,ehd->egd", h, ex["w2"]) + ex["b2"][:, None]


def switch_moe(params: Tree, x, *, axis_name: str = "ep",
               capacity_factor: float = 1.25, mesh=None):
    """Switch-MoE block over this rank's shards: ``x`` (n_loc, d) tokens,
    ``params["experts"]`` leaves this rank's (E_loc, …) experts,
    ``params["router"]["wg"]`` the whole (d, E) router.  Returns ``(out
    (n_loc, d), aux scalar)``."""
    from ..parallel.mesh import all_to_all, axis_size, pmean
    p_size = axis_size(axis_name, mesh)
    ex = params["experts"]
    n_loc, d = x.shape
    gates, idx = route(params, x)
    num_experts = gates.shape[1]
    e_loc = ex["w1"].shape[0]
    if e_loc * p_size != num_experts:
        raise ValueError(f"router knows {num_experts} experts but shards "
                         f"hold {e_loc}×{p_size}")
    cap = _capacity(n_loc, num_experts, capacity_factor)
    dispatch, gate, onehot = _dispatch(gates, idx, num_experts, cap, x.dtype)

    send = torch.einsum("nec,nd->ecd", dispatch, x)          # (E, C, d)
    recv = all_to_all(send, axis_name, 0, 0, tiled=True, mesh=mesh)
    recv = recv.reshape(p_size, e_loc, cap, d).transpose(0, 1) \
        .reshape(e_loc, p_size * cap, d)
    y = _experts(ex, recv)
    back = y.reshape(e_loc, p_size, cap, d).transpose(0, 1) \
        .reshape(p_size * e_loc, cap, d)
    combined = all_to_all(back, axis_name, 0, 0, tiled=True, mesh=mesh)
    out = torch.einsum("nec,ecd->nd", dispatch * gate[:, None, None],
                       combined)

    frac = onehot.mean(0)                                    # tokens/expert
    prob = gates.mean(0)                                     # router mass
    aux = num_experts * torch.sum(pmean(frac, axis_name, mesh)
                                  * pmean(prob, axis_name, mesh))
    return out, aux


def _moe_specs(mesh, axis: str, n_tokens: int, num_experts: int):
    p_size = mesh.procs(axis)
    if n_tokens % p_size:
        raise ValueError(f"token count {n_tokens} not divisible by the "
                         f"{axis!r} axis size {p_size}")
    if num_experts % p_size:
        raise ValueError(f"{num_experts} experts not divisible by the "
                         f"{axis!r} axis size {p_size}")


def switch_moe_sharded(mesh, params: Tree, x, *, axis: str = "ep",
                       capacity_factor: float = 1.25):
    """Whole-array entry point: tokens (N, d), the same on every rank,
    sharded over ``mesh[axis]``; the expert leaves (whole, E first) split
    on their leading dim, the router replicated.  Returns ``(out (N, d),
    aux scalar)``, whole on every rank."""
    from functools import partial

    from ..parallel.mesh import P, shard_map
    _moe_specs(mesh, axis, x.shape[0], params["router"]["wg"].shape[1])
    specs = {"router": {k: P() for k in params["router"]},
             "experts": {k: P(axis) for k in params["experts"]}}
    fn = shard_map(partial(switch_moe, axis_name=axis,
                           capacity_factor=capacity_factor, mesh=mesh),
                   mesh, (specs, P(axis)), (P(axis), P()))
    return fn(params, x)


def _switch_moe_local_experts(mesh, params: Tree, x, *, axis: str,
                              capacity_factor: float):
    """:func:`switch_moe_sharded` for a layer that holds only this rank's
    experts: those enter as they are (``LocalSpec``: their gradients
    stay this rank's, summed over the mesh's other axes), the router and
    the tokens as in the whole-array entry point."""
    from functools import partial

    from ..parallel.mesh import LocalSpec, P, shard_map
    _moe_specs(mesh, axis, x.shape[0], params["router"]["wg"].shape[1])
    specs = {"router": {k: P() for k in params["router"]},
             "experts": {k: LocalSpec(axis) for k in params["experts"]}}
    fn = shard_map(partial(switch_moe, axis_name=axis,
                           capacity_factor=capacity_factor, mesh=mesh),
                   mesh, (specs, P(axis)), (P(axis), P()))
    return fn(params, x)


def switch_moe_reference(params: Tree, x, p_size: int,
                         capacity_factor: float = 1.25):
    """The dispatch of :func:`switch_moe_sharded` over ``p_size`` ranks,
    computed in one process: the tokens split into ``p_size`` shards,
    each routed with its own capacity (the same drops), every kept token
    through its expert (whole ``params``), and the aux loss from the
    shards' mean statistics.  ``(out (N, d), aux)``."""
    num_experts = params["router"]["wg"].shape[1]
    outs, fracs, probs = [], [], []
    for xs in x.chunk(p_size, dim=0):
        gates, idx = route(params, xs)
        cap = _capacity(xs.shape[0], num_experts, capacity_factor)
        dispatch, gate, onehot = _dispatch(gates, idx, num_experts, cap,
                                           xs.dtype)
        send = torch.einsum("nec,nd->ecd", dispatch, xs)
        outs.append(torch.einsum("nec,ecd->nd",
                                 dispatch * gate[:, None, None],
                                 _experts(params["experts"], send)))
        fracs.append(onehot.mean(0))
        probs.append(gates.mean(0))
    aux = num_experts * torch.sum(torch.stack(fracs).mean(0)
                                  * torch.stack(probs).mean(0))
    return torch.cat(outs), aux


class _Leaves(nn.Module):
    """A named group of parameters (the router's or the experts'), so the
    module tree nests as the JAX package's params dict does."""

    def __init__(self, tensors: dict):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t))

    def tree(self, dtype) -> dict:
        return {n: p.to(dtype) for n, p in self.named_parameters()}


@register
class MoEDense(Layer):
    """Switch-MoE feed-forward as a model layer: a drop-in for the
    transformer FF block (wrap in ``Residual`` like any FF).  Runs
    :func:`dense_moe` over the tokens of every position.

    ``mesh`` is runtime placement, not architecture, and is not part of
    the config.  With a mesh attached (``layer.mesh = mesh``, before or
    after ``init``), the layer keeps only this rank's E/P experts of the
    mesh's ``ep`` axis (the whole init, sliced: the same weights as the
    mesh-free layer's) and runs :func:`switch_moe` over the tokens, whole
    on every rank in and out; ``utils.weights.load_jax_variables`` still
    takes the whole JAX tree and keeps this rank's slice.

    The router's load-balance loss: see the module docstring.  The stock
    trainers optimize the task loss only unless ``aux_weight`` is given.
    """

    def __init__(self, num_experts: int, d_hidden: Optional[int] = None,
                 capacity_factor: float = 1.25):
        super().__init__()
        self.num_experts = int(num_experts)
        self.d_hidden = d_hidden if d_hidden is None else int(d_hidden)
        self.capacity_factor = float(capacity_factor)
        self._mesh = None  # runtime attachment, not config
        #: the last training forward's aux loss, in the autograd graph
        #: (``parallel.sync.aux_losses`` takes it)
        self.live_aux_loss: Optional[torch.Tensor] = None
        self.new_state: Optional[dict] = None

    @property
    def mesh(self):
        return self._mesh

    @mesh.setter
    def mesh(self, mesh):
        if mesh is None and self._sliced():
            raise ValueError("this MoEDense holds only its rank's experts; "
                             "build a new layer to run it without a mesh")
        self._mesh = mesh
        self._slice_experts()

    def _sliced(self) -> bool:
        experts = getattr(self, "experts", None)
        return experts is not None and \
            experts.w1.shape[0] != self.num_experts

    def _slice_experts(self) -> None:
        """Keep this rank's experts of the mesh's ``ep`` axis (each leaf's
        rows tagged ``_ep_rows`` for ``load_jax_variables``)."""
        experts = getattr(self, "experts", None)
        if self._mesh is None or experts is None or self._sliced():
            return
        p_size = self._mesh.procs("ep")
        if self.num_experts % p_size:
            raise ValueError(f"{self.num_experts} experts not divisible by "
                             f"the 'ep' axis size {p_size}")
        n = self.num_experts // p_size
        lo = self._mesh.coord("ep") * n
        for name, p in list(experts.named_parameters()):
            part = nn.Parameter(p.detach()[lo:lo + n].clone())
            part._ep_rows = (lo, lo + n, self.num_experts)
            setattr(experts, name, part)

    def build(self, in_shape, gen):
        d = in_shape[-1]
        hidden = self.d_hidden if self.d_hidden is not None else 4 * d
        params = init_moe_params(gen, self.num_experts, d, hidden)
        self.router = _Leaves(params["router"])
        self.experts = _Leaves(params["experts"])
        self.register_buffer("aux_loss", torch.zeros(()))
        self._slice_experts()
        return in_shape

    def forward(self, x):
        tokens = x.reshape(-1, x.shape[-1])
        params = {"router": self.router.tree(x.dtype),
                  "experts": self.experts.tree(x.dtype)}
        if self._mesh is not None:
            out, aux = _switch_moe_local_experts(
                self._mesh, params, tokens, axis="ep",
                capacity_factor=self.capacity_factor)
        else:
            out, aux = dense_moe(params, tokens)
        if self.training:
            aux = aux.float()
            self.live_aux_loss = aux
            self.new_state = {"aux_loss": aux.detach()}
        return out.reshape(x.shape)

    def get_config(self):
        return {"num_experts": self.num_experts, "d_hidden": self.d_hidden,
                "capacity_factor": self.capacity_factor}
