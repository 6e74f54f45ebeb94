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

Expert parallelism (``switch_moe`` / ``switch_moe_sharded``: tokens
exchanged by ``all_to_all`` over an ``ep`` mesh axis, with a capacity per
expert) spans cards, and raises here: ROADMAP Queue 1 item 8.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import Layer, register

Tree = Any

#: where expert parallelism over a mesh is ported
EP_ITEM = "ROADMAP Queue 1 item 8 (parallelism beyond one card)"


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


def switch_moe(params: Tree, x, *, axis_name: str = "ep",
               capacity_factor: float = 1.25):
    """The expert-parallel block (tokens exchanged over a mesh axis):
    not ported yet."""
    raise NotImplementedError(
        f"switch_moe (experts sharded over the {axis_name!r} mesh axis, "
        f"tokens exchanged by all_to_all) is not ported yet: {EP_ITEM}")


def switch_moe_sharded(mesh, params: Tree, x, *, axis: str = "ep",
                       capacity_factor: float = 1.25):
    """Whole-array entry point of :func:`switch_moe`: not ported yet."""
    return switch_moe(params, x, axis_name=axis,
                      capacity_factor=capacity_factor)


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
    the config; a mesh set on the layer raises at the forward (ROADMAP
    Queue 1 item 8).

    The router's load-balance loss: see the module docstring.  The stock
    trainers optimize the task loss only unless ``aux_weight`` is given.
    """

    def __init__(self, num_experts: int, d_hidden: Optional[int] = None,
                 capacity_factor: float = 1.25):
        super().__init__()
        self.num_experts = int(num_experts)
        self.d_hidden = d_hidden if d_hidden is None else int(d_hidden)
        self.capacity_factor = float(capacity_factor)
        self.mesh = None  # runtime attachment, not config
        #: the last training forward's aux loss, in the autograd graph
        #: (``parallel.sync.aux_losses`` takes it)
        self.live_aux_loss: Optional[torch.Tensor] = None
        self.new_state: Optional[dict] = None

    def build(self, in_shape, gen):
        d = in_shape[-1]
        hidden = self.d_hidden if self.d_hidden is not None else 4 * d
        params = init_moe_params(gen, self.num_experts, d, hidden)
        self.router = _Leaves(params["router"])
        self.experts = _Leaves(params["experts"])
        self.register_buffer("aux_loss", torch.zeros(()))
        return in_shape

    def forward(self, x):
        if self.mesh is not None:
            raise NotImplementedError(
                f"MoEDense with a mesh attached (experts sharded over its "
                f"'ep' axis) is not ported yet: {EP_ITEM}")
        tokens = x.reshape(-1, x.shape[-1])
        params = {"router": self.router.tree(x.dtype),
                  "experts": self.experts.tree(x.dtype)}
        out, aux = dense_moe(params, tokens)
        if self.training:
            aux = aux.float()
            self.live_aux_loss = aux
            self.new_state = {"aux_loss": aux.detach()}
        return out.reshape(x.shape)

    def get_config(self):
        return {"num_experts": self.num_experts, "d_hidden": self.d_hidden,
                "capacity_factor": self.capacity_factor}
