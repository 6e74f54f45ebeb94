"""The port's ring attention (``distkeras_tpu_torch.parallel.ring``) and
mesh-attached ``MultiHeadAttention`` against the JAX package's, on the
CPU.

The port's ranks are gloo child processes (``tests/test_torch_mesh_child.
py``: the port alone; one spawn of 4, where a mesh of 2 runs as two
replicas under an axis no spec names); the JAX reference runs here, in
``shard_map`` over the fake devices of ``tests/conftest.py``, wrapped in
``jax.jit``.  At
P = 2 and 4: the contiguous and zigzag rings, causal and not, blockwise
and flash hops (the port's flash op is its plain version on CPU tensors,
held against JAX's blockwise hops: the same function, gradients through
the hops' lse merge included), Ulysses, the inner functions through each
package's ``shard_map``, and a dp × sp mesh of 4 ranks with
``batch_axis`` (zigzag).  Forward within rtol 1e-5 plus 1e-6 of the largest
|value|, the gradients of q, k and v within rtol 1e-5 plus 1e-5 (f32).

A mesh-attached ``gpt_lm``'s parameter gradients equal the mesh-free
model's (within 1e-5; not P times them), contiguous and zigzag, and the
model trains a few ``SingleTrainer`` steps as ``examples/longcontext.
py``'s stage 4 (adam, lr 3e-3, sparse cross-entropy; its causal layers
zigzag) against the JAX package's run, losses and trained variables
within rtol 1e-4 plus 1e-5 of the largest |value|.

Each JAX reference compiles once (about 1–3 s on the CPU, more beside
the suite's other workers), so the cases cover each function at P = 2
and 4, and each mask and layout, once rather than every product of
them: the zigzag schedule at P = 2 pre-shuffled, at P = 4 through the
inner function (blockwise) and the sharded entry point (flash).
"""

import zlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu as dk
from distkeras_tpu.data.datasets import load_lm_corpus
from distkeras_tpu.models import zoo as jax_zoo
from distkeras_tpu.ops.attention import MultiHeadAttention as JaxMHA
from distkeras_tpu.parallel import ring as jax_ring
from distkeras_tpu.parallel.mesh import make_mesh as jax_make_mesh
from distkeras_tpu.parallel.mesh import shard_map as jax_shard_map
from distkeras_tpu.parallel.sync import _shard_map_kw
from jax.sharding import PartitionSpec as JP

from distkeras_tpu_torch.models import Model
from distkeras_tpu_torch.parallel import ring
from test_torch_mesh_child import run_ranks

B, T, H, DH = 2, 32, 4, 8
LM = dict(vocab_size=64, dim=32, num_heads=4, num_blocks=1, seq_len=32)
TRAIN = dict(worker_optimizer="adam",
             loss="sparse_categorical_crossentropy",
             features_col="features", label_col="label", num_epoch=2,
             batch_size=8, learning_rate=3e-3)


def _close(got, ref, rtol=1e-5, atol=0.0, atol_of_max=1e-6):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    bound = atol + atol_of_max * float(np.max(np.abs(ref))) \
        + rtol * np.abs(ref)
    assert bool(np.all(np.abs(got - ref) <= bound)), \
        float(np.max(np.abs(got - ref)))


def _qkvo(seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(B, T, H, DH)).astype(np.float32)
                 for _ in range(4))


#: (id, P, mesh shape, axis names, impl, causal, layout, batch_axis,
#: inner function or None, pre_shuffled)
RING = [("blockwise-contiguous-1-P4", 4, (4,), ("sp",), "blockwise", True,
         "contiguous", None, None, False),
        ("flash-zigzag-1-P4", 4, (4,), ("sp",), "flash", True, "zigzag",
         None, None, False)]
for _p in (2, 4):
    # causal at 2, unmasked at 4
    RING.append((f"flash-contiguous-{int(_p == 2)}-P{_p}", _p, (_p,),
                 ("sp",), "flash", _p == 2, "contiguous", None, None,
                 False))
    RING.append((f"ulysses-{int(_p == 2)}-P{_p}", _p, (_p,), ("sp",),
                 "ulysses", _p == 2, "contiguous", None, None, False))
RING += [
    ("blockwise-contiguous-0-P2", 2, (2,), ("sp",), "blockwise", False,
     "contiguous", None, None, False),
    ("pre-shuffled-P2", 2, (2,), ("sp",), "blockwise", True, "zigzag", None,
     None, True),
    ("inner-ring-P2", 2, (2,), ("sp",), "blockwise", True, "contiguous",
     None, "ring_attention", False),
    ("inner-ulysses-P2", 2, (2,), ("sp",), "blockwise", False, "contiguous",
     None, "ulysses_attention", False),
    ("inner-zigzag-P4", 4, (4,), ("sp",), "blockwise", True, "zigzag", None,
     "zigzag_ring_attention", True),
    ("dpsp-zigzag", 4, (2, 2), ("dp", "sp"), "blockwise", True, "zigzag",
     "dp", None, False)]
RING_BY_ID = {r[0]: r for r in RING}


def _inputs(rid):
    """q, k, v and the output cotangent; zigzag-striped for a case whose
    shards arrive striped."""
    p, shuffled = RING_BY_ID[rid][1], RING_BY_ID[rid][9]
    arrays = _qkvo(zlib.crc32(rid.encode()))
    if shuffled:
        arrays = tuple(ring.zigzag_shuffle(torch.from_numpy(a), p).numpy()
                       for a in arrays)
    return arrays


def _ring_case(rid):
    _, p, shape, names, impl, causal, layout, batch_axis, inner, pre = \
        RING_BY_ID[rid]
    q, k, v, do = _inputs(rid)
    return (rid, "ring", dict(q=q, k=k, v=v, do=do, mesh_shape=shape,
                              axis_names=names, impl=impl, causal=causal,
                              layout=layout, batch_axis=batch_axis,
                              inner=inner, pre_shuffled=pre and not inner))


def _jax_ring(rid):
    _, p, shape, names, impl, causal, layout, batch_axis, inner, pre = \
        RING_BY_ID[rid]
    q, k, v, do = _inputs(rid)
    if len(shape) == 1:
        mesh = jax_make_mesh(p, names)
    else:
        mesh = jax_make_mesh(axis_names=names, shape=shape)
    # the port's flash hops are the plain version on the CPU: JAX's
    # blockwise hops compute the same function (its flash ones would run
    # Pallas in interpret mode, seconds a case)
    jimpl = "blockwise" if impl == "flash" else impl
    if impl == "ulysses":
        # JAX's sharded Ulysses picks the Pallas kernel when it imports;
        # its dense form is the same function without interpret mode
        inner = "ulysses_attention"
    if inner is None:
        def f(q, k, v):
            return jax_ring.ring_attention_sharded(
                mesh, q, k, v, axis="sp", batch_axis=batch_axis,
                causal=causal, impl=jimpl, layout=layout, pre_shuffled=pre)
    else:
        fn = {"ring_attention": partial(jax_ring.ring_attention,
                                        impl=jimpl, causal=causal),
              "zigzag_ring_attention": partial(
                  jax_ring.zigzag_ring_attention, impl=jimpl),
              "ulysses_attention": partial(jax_ring.ulysses_attention,
                                           causal=causal,
                                           impl="dense")}[inner]
        spec = JP(batch_axis, "sp")
        f = jax_shard_map(partial(fn, axis_name="sp"), mesh=mesh,
                          in_specs=(spec, spec, spec), out_specs=spec,
                          **_shard_map_kw())
    @jax.jit
    def run(q, k, v, do):
        out, vjp = jax.vjp(f, q, k, v)
        return (out, *vjp(do))
    outs = run(*(jnp.asarray(a) for a in (q, k, v, do)))
    return [np.asarray(o) for o in outs]


def _lm_parts():
    cfg = jax_zoo.gpt_lm(**LM).config()
    inits = {0: jax.tree_util.tree_map(
        np.asarray, jax_zoo.gpt_lm(**LM).init(0))}
    ds = load_lm_corpus(n_train=32, seq_len=LM["seq_len"],
                        vocab_size=LM["vocab_size"], seed=0)[0]
    return cfg, inits, np.asarray(ds["features"]), np.asarray(ds["label"])


@pytest.fixture(scope="module")
def lm():
    return _lm_parts()


@pytest.fixture(scope="module")
def ranks(lm):
    """Every rank-side case of this file, on 2 and on 4 gloo ranks."""
    cfg, inits, x, y = lm
    cases = [_ring_case(r[0]) for r in RING]
    for layout in ("contiguous", "zigzag"):
        cases.append((f"grad-{layout}", "mha_grad",
                      dict(config=cfg, inits=inits, x=x[:4], mesh_shape=(2,),
                           axis_names=("sp",), layout=layout)))
    cases.append(("train-zigzag", "lm_train",
                  dict(config=cfg, inits=inits, x=x, y=y, mesh_shape=(2,),
                       axis_names=("sp",), trainer_kw=TRAIN,
                       layout="zigzag")))
    # one spawn of 4 ranks: a mesh of 2 runs as two replicas of it
    results = run_ranks(4, cases)
    return {2: results, 4: results}


@pytest.mark.parametrize("rid", [r[0] for r in RING])
def test_ring_forms_and_gradients_match_jax(ranks, rid):
    p = RING_BY_ID[rid][1]
    ref = _jax_ring(rid)
    for res in ranks[p]:
        got = res[rid]
        _close(got["out"], ref[0])
        for name, r in zip(("dq", "dk", "dv"), ref[1:]):
            _close(got[name], r, atol=1e-5)


@pytest.mark.parametrize("p", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_schedule_flops_and_zigzag_order_are_the_jax_packages(
        p, layout, causal):
    assert ring.ring_schedule_flops(p, 16, causal=causal, layout=layout) \
        == jax_ring.ring_schedule_flops(p, 16, causal=causal, layout=layout)
    np.testing.assert_array_equal(ring.zigzag_order(p),
                                  jax_ring.zigzag_order(p))
    x = np.arange(2 * 4 * p * 3, dtype=np.float32).reshape(2, 4 * p, 3)
    got = ring.zigzag_shuffle(torch.from_numpy(x), p)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_ring.zigzag_shuffle(jnp.asarray(x), p)))
    np.testing.assert_array_equal(
        ring.zigzag_unshuffle(got, p).numpy(), x)


def test_skipped_hop_partials_carry_exactly_zero_weight():
    """exp(_NEG − lse) is exactly 0 in f32 and bf16, so a skipped hop's
    (0, _NEG) partials leave the merge and its gradient unchanged."""
    for dtype in (torch.float32, torch.bfloat16):
        o = torch.randn(1, 4, 2, 8).to(dtype).float().requires_grad_(True)
        lse = torch.randn(1, 2, 4).requires_grad_(True)
        skip_o = torch.zeros(1, 4, 2, 8)
        skip_lse = torch.full((1, 2, 4), ring._NEG)
        out, tot = ring._merge_lse(o, lse, skip_o, skip_lse)
        assert torch.equal(out, o.float()) and torch.equal(tot, lse)
        out.sum().backward()
        assert torch.equal(o.grad, torch.ones_like(o))


def test_mesh_attached_gradient_is_the_mesh_free_one_not_p_times(lm,
                                                                 ranks):
    cfg, inits, x, _ = lm
    model = Model.from_config(cfg).init(0, device="cpu")
    from distkeras_tpu_torch.utils import load_jax_variables
    load_jax_variables(model, inits[0])
    out = model(torch.from_numpy(x[:4]))
    loss = (out.float() ** 2).mean()
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in
                                       model.named_parameters()])
    for layout in ("contiguous", "zigzag"):
        for res in ranks[2]:
            got = res[f"grad-{layout}"]
            assert abs(got["loss"] - loss.item()) <= 1e-6 * abs(loss.item())
            for name, g in zip(names, grads):
                _close(got["grads"][name], g.numpy(), atol=1e-5)


def test_mesh_attached_lm_trains_as_the_jax_longcontext_recipe(lm, ranks):
    cfg, inits, x, y = lm
    ds = dk.Dataset({"features": x, "label": y})
    for layout in ("zigzag",):
        model = jax_zoo.gpt_lm(**LM)
        mesh = jax_make_mesh(2, ("sp",))
        for lyr in model.iter_layers():
            if isinstance(lyr, JaxMHA):
                lyr.mesh = mesh
                lyr.ring_layout = layout
        t = dk.SingleTrainer(model, **TRAIN)
        m = t.train(ds)
        want_hist = [np.asarray(h) for h in t.get_history()]
        want = jax.tree_util.tree_leaves(m.variables)
        for res in ranks[2]:
            got = res[f"train-{layout}"]
            assert len(got["history"]) == len(want_hist)
            for g, w in zip(got["history"], want_hist):
                _close(g, w, rtol=1e-4, atol_of_max=1e-5)
            for g, w in zip(jax.tree_util.tree_leaves(got["variables"]),
                            want):
                _close(g, np.asarray(w), rtol=1e-4, atol_of_max=1e-5)
        # every rank holds the same trained model
        first, *rest = (jax.tree_util.tree_leaves(
            r[f"train-{layout}"]["variables"]) for r in ranks[2])
        assert all(np.array_equal(u, v) for other in rest
                   for u, v in zip(first, other))
