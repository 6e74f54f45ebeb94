"""The port's expert-parallel switch MoE (``ops.moe.switch_moe`` /
``switch_moe_sharded``, ``MoEDense`` with an ``ep`` mesh) against the JAX
package's, on the CPU.

The port's ranks are gloo child processes (``tests/test_torch_mesh_child.
py``: the port alone; one spawn of 4, where an ``ep`` mesh of 2 runs as
two replicas); the JAX reference runs here over the fake devices
of ``tests/conftest.py``, wrapped in ``jax.jit``.  At ep 2 and 4, with
capacity enough that nothing drops, the default 1.25 and a capacity that
drops most tokens (the cases of ``tests/test_moe.py``): the output, the
aux loss and the gradients of sum(out·w) + 0.01·aux with respect to the
tokens and every parameter, within rtol 1e-5 plus 1e-6 of the largest
|value| (gradients plus 1e-5: f32, the einsums sum in another order).
``switch_moe_reference`` — the one-process oracle of the chip smoke's
``mesh_moe`` — equals JAX's sharded block at the same ep.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.models import zoo as jax_zoo
from distkeras_tpu.ops import moe as jax_moe
from distkeras_tpu.ops.moe import MoEDense as JaxMoEDense
from distkeras_tpu.parallel.mesh import make_mesh as jax_make_mesh

from distkeras_tpu_torch.models import Model
from distkeras_tpu_torch.ops import moe
from distkeras_tpu_torch.utils import to_numpy_variables
from test_torch_mesh_child import run_ranks

D, HID, N = 8, 16, 32
CAPACITIES = (64.0, 1.25, 0.5)
LM = dict(vocab_size=32, dim=16, num_heads=2, num_blocks=1, seq_len=8,
          moe_experts=4)


def _close(got, ref, rtol=1e-5, atol=0.0, atol_of_max=1e-6):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    bound = atol + atol_of_max * float(np.max(np.abs(ref))) \
        + rtol * np.abs(ref)
    assert bool(np.all(np.abs(got - ref) <= bound)), \
        float(np.max(np.abs(got - ref)))


@functools.lru_cache(maxsize=None)
def _inputs(p, cf):
    """Router and 2P experts in the layout of ``init_moe_params`` (normal
    weights over √fan-in, small nonzero biases), tokens and the output
    cotangent, made with numpy."""
    experts = 2 * p
    rng = np.random.default_rng(int(10 * cf) + p)

    def normal(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)
    params = {"router": {"wg": normal(D, experts, scale=D ** -0.5)},
              "experts": {"w1": normal(experts, D, HID, scale=D ** -0.5),
                          "b1": normal(experts, HID, scale=0.1),
                          "w2": normal(experts, HID, D, scale=HID ** -0.5),
                          "b2": normal(experts, D, scale=0.1)}}
    return params, normal(N, D), normal(N, D)


@functools.lru_cache(maxsize=None)
def _jax_moe(p, cf):
    params, x, w = _inputs(p, cf)
    mesh = jax_make_mesh(p, ("ep",))

    @jax.jit
    def run(params, x):
        def loss(params, x):
            out, aux = jax_moe.switch_moe_sharded(mesh, params, x,
                                                  capacity_factor=cf)
            return (out * w).sum() + 0.01 * aux, (out, aux)
        (_, (out, aux)), grads = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(params, x)
        return out, aux, grads
    out, aux, (dparams, dx) = run(params, jnp.asarray(x))
    return out, aux, dparams, dx


@functools.lru_cache(maxsize=None)
def _lm_parts():
    """The JAX model, its initial variables (the port's ``init(0)``: an
    eager JAX init of the MoE model costs seconds on the CPU) and
    tokens."""
    model = jax_zoo.gpt_lm(**LM)
    inits = {0: to_numpy_variables(Model.from_config(model.config()).init(
        0, device="cpu"))}
    x = np.random.default_rng(5).integers(0, LM["vocab_size"],
                                          size=(4, LM["seq_len"]))
    return model, inits, x


@pytest.fixture(scope="module")
def ranks():
    _, inits, x = _lm_parts()
    cfg = jax_zoo.gpt_lm(**LM).config()
    cases = []
    for p in (2, 4):
        for cf in CAPACITIES:
            params, xs, w = _inputs(p, cf)
            cases.append((f"moe-{cf}-{p}", "moe",
                          dict(params=params, x=xs, w=w, aux_weight=0.01,
                               capacity_factor=cf, mesh_shape=(p,))))
        cases.append((f"layer-{p}", "moe_layer",
                      dict(config=cfg, inits=inits, x=x, mesh_shape=(p,))))
    # one spawn of 4 ranks: an ep mesh of 2 runs as two replicas of it
    return run_ranks(4, cases)


@pytest.mark.parametrize("cf", CAPACITIES)
@pytest.mark.parametrize("p", [2, 4])
def test_switch_moe_sharded_matches_jax(ranks, p, cf):
    out, aux, dparams, dx = _jax_moe(p, cf)
    for res in ranks:
        got = res[f"moe-{cf}-{p}"]
        _close(got["out"], out)
        _close(got["aux"], aux)
        _close(got["dx"], dx, atol=1e-5)
        for g, w in zip(jax.tree_util.tree_leaves(got["dparams"]),
                        jax.tree_util.tree_leaves(dparams)):
            _close(g, w, atol=1e-5)
    if cf == 0.5:
        # the capacity dropped tokens: their rows are exactly zero
        assert int((np.abs(np.asarray(out)).sum(1) == 0).sum()) > 0


@pytest.mark.parametrize("cf", CAPACITIES)
@pytest.mark.parametrize("p", [2, 4])
def test_one_process_reference_is_the_sharded_dispatch(p, cf):
    params, x, _ = _inputs(p, cf)
    out, aux, _, _ = _jax_moe(p, cf)
    tparams = jax.tree_util.tree_map(torch.from_numpy, params)
    got, got_aux = moe.switch_moe_reference(tparams, torch.from_numpy(x), p,
                                            capacity_factor=cf)
    _close(got, out)
    _close(got_aux, aux)


@pytest.mark.parametrize("p", [2, 4])
def test_mesh_attached_moe_layer_matches_jax(ranks, p):
    """``MoEDense`` with an ``ep`` mesh in a ``gpt_lm``: each rank keeps
    its E/P experts (loaded from the whole JAX tree) and the forward, the
    aux loss and the gradients equal the JAX layer's over a mesh."""
    model, inits, x = _lm_parts()
    mesh = jax_make_mesh(p, ("ep",))
    for lyr in model.iter_layers():
        if isinstance(lyr, JaxMoEDense):
            lyr.mesh = mesh

    @jax.jit
    def run(variables, x):
        def loss(params):
            out, state = model.apply({"params": params,
                                      "state": variables["state"]}, x,
                                     train=True)
            aux = sum(v for k, v in jax.tree_util.tree_flatten_with_path(
                state)[0] if "aux_loss" in jax.tree_util.keystr(k))
            return (out ** 2).mean() + 0.01 * aux, (out, aux)
        return jax.grad(loss, has_aux=True)(variables["params"])
    grads, (out, aux) = run(inits[0], jnp.asarray(x))
    from distkeras_tpu_torch.utils.weights import jax_leaf_names
    names = jax_leaf_names(Model.from_config(model.config()).init(
        0, device="cpu"))[0]
    by_name = dict(zip(names, jax.tree_util.tree_leaves(grads)))
    for res in ranks:
        got = res[f"layer-{p}"]
        _close(got["out"], out)
        assert abs(got["aux"] - float(aux)) <= 1e-6 * abs(float(aux))
        e_loc = LM["moe_experts"] // p
        rows = slice(got["rank"] * e_loc, (got["rank"] + 1) * e_loc)
        for name, g in got["grads"].items():
            want = np.asarray(by_name[name])
            if ".experts." in name:
                assert got["shapes"][name][0] == e_loc
                want = want[rows]
            _close(g, want, atol=1e-5)


def test_moe_layer_keeps_its_ranks_experts_and_refuses_a_detach():
    """Attaching a one-rank ``ep`` mesh keeps every expert; the dense path
    is untouched without a mesh."""
    from distkeras_tpu_torch.ops.moe import MoEDense
    from distkeras_tpu_torch.parallel.mesh import make_mesh
    model = Model.from_config(jax_zoo.gpt_lm(**LM).config()).init(
        0, device="cpu")
    layer = next(l for l in model.iter_layers() if isinstance(l, MoEDense))
    x = torch.from_numpy(_lm_parts()[2])
    dense = model(x)
    layer.capacity_factor = 64.0  # no drops: the dense formula
    layer.mesh = make_mesh(axis_names=("ep",), shape=(1,), devices="cpu")
    assert layer.experts.w1.shape[0] == LM["moe_experts"]
    torch.testing.assert_close(model(x), dense, rtol=1e-5, atol=1e-6)
    layer.mesh = None
    torch.testing.assert_close(model(x), dense, rtol=0, atol=0)
