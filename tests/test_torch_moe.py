"""The port's switch-MoE FF block (``ops.moe``) against the JAX package's,
on the CPU: ``dense_moe``'s routing, output and load-balance aux loss in
f32 and on bf16 tokens, its gradients, ``gpt_lm(moe_experts=4,
attention_impl="flash")``'s forward (JAX's Pallas kernel in interpret
mode, the port's plain version), a ``SingleTrainer`` trajectory with
``aux_weight`` and its checkpoint's leaves (the ``aux_loss`` state leaf
in place), ``Model.from_config`` and the serde blob of a JAX MoE model,
and the mesh that raises.

Weights cross as the JAX ``variables`` tree (``load_jax_variables``).
Routing is compared first: top-1 argmax flips an expert on a near-tie of
two gates, so a flip fails as a routing mismatch that names the token.
Tolerances: f32 rtol 1e-5, atol 1e-6; bf16 tokens within bf16 rounding
(rtol 1e-2 plus 1e-2 of the largest |value|); gradients and the LM's
forward rtol = atol = 1e-5 (``tests/test_torch_lm.py``); the trainer's
losses and every trained leaf rtol 1e-5 plus 1e-6 of the largest |value|
(``tests/test_torch_dist.py``)."""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu as dk
from distkeras_tpu.data.datasets import load_lm_corpus as jax_load_lm_corpus
from distkeras_tpu.models import zoo as jax_zoo
from distkeras_tpu.ops import moe as jax_moe
from distkeras_tpu.utils import serde as jax_serde

import distkeras_tpu_torch as dkt
from distkeras_tpu_torch.data import load_lm_corpus
from distkeras_tpu_torch.models import Model, zoo
from distkeras_tpu_torch.ops import moe
from distkeras_tpu_torch.utils import checkpoint, serde
from distkeras_tpu_torch.utils.weights import (jax_leaf_names,
                                               load_jax_variables,
                                               to_numpy_variables)

# pytest-xdist's workers share the cores: an intra-op pool of the
# workers' share each, not one of every core per worker
if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, os.cpu_count()
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

E, D, H, N = 4, 16, 32, 24
VOCAB, SEQ = 17, 16
LM = dict(vocab_size=VOCAB, dim=32, num_heads=2, num_blocks=2, seq_len=SEQ,
          attention_impl="flash", moe_experts=E)
SCE = "sparse_categorical_crossentropy"
TRAIN = dict(num_epoch=2, batch_size=8, learning_rate=0.1, aux_weight=0.01)


def _close(got, ref, rtol=1e-5, atol=0.0, atol_of_max=1e-6, largest=None):
    """|got − ref| ≤ rtol·|ref| + atol + atol_of_max·largest, ``largest``
    the largest |value| of ``ref`` unless given."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    if largest is None:
        largest = float(np.max(np.abs(ref))) if ref.size else 0.0
    bound = atol + atol_of_max * largest + rtol * np.abs(ref)
    assert bool(np.all(np.abs(got - ref) <= bound)), \
        float(np.max(np.abs(got - ref)))


def _assert_same_routing(ref_idx, got_idx, gates):
    """Equal top-1 experts, or a failure naming the first token routed
    apart and its two packages' gates."""
    ref_idx, got_idx = np.asarray(ref_idx), np.asarray(got_idx)
    apart = np.nonzero(ref_idx != got_idx)[0]
    assert apart.size == 0, (
        f"routing mismatch at token {int(apart[0])}: JAX expert "
        f"{int(ref_idx[apart[0]])}, port expert {int(got_idx[apart[0]])} "
        f"(gates {np.asarray(gates, np.float64)[apart[0]].tolist()})")


def _jax_params(dtype=jnp.float32, seed=3):
    p = jax_moe.init_moe_params(seed, E, D, H)
    # nonzero biases, so they are checked too
    rng = np.random.default_rng(seed)
    p["experts"]["b1"] = jnp.asarray(rng.normal(size=(E, H)) * 0.1)
    p["experts"]["b2"] = jnp.asarray(rng.normal(size=(E, D)) * 0.1)
    return jax.tree_util.tree_map(lambda a: a.astype(dtype), p)


def _torch_tree(tree):
    return jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a.astype(jnp.float32)))
        .to(torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32),
        tree)


def _tokens(dtype=jnp.float32, seed=0):
    x = np.random.default_rng(seed).normal(size=(N, D)).astype(np.float32)
    return jnp.asarray(x).astype(dtype)


@jax.jit
def _jax_dense_moe(p, x):
    """The JAX block's outputs and its router's gates, in one program."""
    return (jax_moe.dense_moe(p, x),
            jax.nn.softmax(x @ p["router"]["wg"], axis=-1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_moe_matches_jax(dtype):
    jd = getattr(jnp, dtype)
    jp, jx = _jax_params(jd), _tokens(jd)
    tp, tx = _torch_tree(jp), _torch_tree(jx)
    (jout, jaux), jgates = _jax_dense_moe(jp, jx)
    gates, idx = moe.route(tp, tx)
    _assert_same_routing(jnp.argmax(jgates, axis=-1), idx, jgates)
    assert len(set(np.asarray(idx).tolist())) > 1   # several experts used
    out, aux = moe.dense_moe(tp, tx)
    assert out.dtype == getattr(torch, dtype) and out.shape == (N, D)
    ref_out = np.asarray(jout.astype(jnp.float32))
    ref_aux = np.asarray(jaux.astype(jnp.float32))
    if dtype == "float32":
        _close(out, ref_out, rtol=1e-5, atol=1e-6, atol_of_max=0.0)
        _close(aux, ref_aux, rtol=1e-5, atol=1e-6, atol_of_max=0.0)
    else:
        _close(out.float(), ref_out, rtol=1e-2, atol_of_max=1e-2)
        _close(aux.float(), ref_aux, rtol=1e-2, atol_of_max=1e-2)


def test_dense_moe_gradients_match_jax():
    """The gradients of Σ out·c + 0.3·aux with respect to every parameter
    and the tokens (f32; the picked expert's path, the gate's and the
    router's through the aux loss)."""
    jp, jx = _jax_params(), _tokens()
    c = np.random.default_rng(5).normal(size=(N, D)).astype(np.float32)

    def jloss(p, x):
        out, aux = jax_moe.dense_moe(p, x)
        return jnp.sum(out * c) + 0.3 * aux

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jx)
    tp = jax.tree_util.tree_map(lambda t: t.requires_grad_(True),
                                _torch_tree(jp))
    tx = _torch_tree(jx).requires_grad_(True)
    out, aux = moe.dense_moe(tp, tx)
    (torch.sum(out * torch.from_numpy(c)) + 0.3 * aux).backward()
    _close(tx.grad, jgx, rtol=1e-5, atol=1e-5, atol_of_max=0.0)
    for (path, g), t in zip(jax.tree_util.tree_leaves_with_path(jgp),
                            jax.tree_util.tree_leaves(tp)):
        assert t.grad is not None, path
        _close(t.grad, g, rtol=1e-5, atol=1e-5, atol_of_max=0.0)


@pytest.fixture(scope="module")
def lm_pair():
    jm = jax_zoo.gpt_lm(**LM)
    jv = jax.tree_util.tree_map(np.asarray, jm.init(0))
    model = Model.from_config(json.loads(json.dumps(jm.config())))
    model.init(0, device="cpu")
    load_jax_variables(model, jv)
    return jm, jv, model


def test_flash_moe_lm_forward_matches_jax(lm_pair):
    jm, jv, model = lm_pair
    x = np.random.default_rng(1).integers(0, VOCAB, (2, SEQ)).astype(
        np.int32)
    ref = np.asarray(jm.predict_fn()(jv, x))
    with torch.no_grad():
        got = model(torch.from_numpy(x).long()).numpy()
    _close(got, ref, rtol=1e-5, atol=1e-5, atol_of_max=0.0)
    # an inference forward leaves the aux_loss state as it was, as JAX's
    # predict drops the new state
    state = to_numpy_variables(model)["state"]
    assert [float(a) for a in jax.tree_util.tree_leaves(state)] == [0.0] * 2


def test_moe_tree_config_and_serde_blob_cross_packages(lm_pair):
    """The port's tree of the MoE LM is the JAX package's (the router and
    experts nested, ``aux_loss`` in the state), its config reads back
    unchanged, and the model blob crosses both ways."""
    jm, jv, model = lm_pair
    mine = to_numpy_variables(model)
    assert jax.tree_util.tree_structure(mine) == \
        jax.tree_util.tree_structure(jv)
    for a, b in zip(jax.tree_util.tree_leaves(mine),
                    jax.tree_util.tree_leaves(jv)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert model.config() == json.loads(json.dumps(jm.config()))
    # the JAX package's blob into the port, the port's into JAX
    pm, pv = serde.deserialize_model(jax_serde.serialize_model(jm, jv))
    pm.init(0, device="cpu")
    load_jax_variables(pm, pv)
    back_m, back_v = jax_serde.deserialize_model(
        serde.serialize_model(pm, to_numpy_variables(pm)))
    assert back_m.config() == jm.config()
    for a, b in zip(jax.tree_util.tree_leaves(back_v),
                    jax.tree_util.tree_leaves(jv)):
        assert np.asarray(a).dtype == b.dtype and np.array_equal(a, b)
    # the blob's model is the one the config and weights built
    x = torch.from_numpy(np.random.default_rng(2).integers(
        0, VOCAB, (1, SEQ))).long()
    with torch.no_grad():
        assert torch.equal(pm(x), model(x))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``SingleTrainer`` on the flash MoE LM, SGD, ``aux_weight`` 0.01, 2
    epochs of 2 steps of batch 8, in both packages from the JAX init, each
    writing checkpoints; the port's run again under ``remat`` (the
    backward's recompute runs the MoE forward a second time); and the
    port's run at ``aux_weight`` 0."""
    tmp = tmp_path_factory.mktemp("moe_ckpt")
    ds_kw = dict(n_train=16, seq_len=SEQ, vocab_size=VOCAB)
    jm = jax_zoo.gpt_lm(**LM)
    jt = dk.SingleTrainer(jm, "sgd", SCE, checkpoint_dir=str(tmp / "jax"),
                          **TRAIN)
    jt.train(jax_load_lm_corpus(**ds_kw)[0])

    def port(checkpoint_dir=None, **kw):
        model = zoo.gpt_lm(**LM)
        build = model.init

        def init(seed=0, device=None):
            build(seed, device=device)
            load_jax_variables(model, jax.tree_util.tree_map(
                np.asarray, jm.init(seed)))
            return model
        model.init = init
        t = dkt.SingleTrainer(model, "sgd", SCE, device="cpu",
                              checkpoint_dir=checkpoint_dir,
                              **{**TRAIN, **kw})
        t.train(load_lm_corpus(**ds_kw)[0])
        return t

    return {"jax": jt, "port": port(str(tmp / "port")),
            "port_remat": port(remat=True),
            "port_no_aux": port(aux_weight=0.0), "tmp": tmp}


@pytest.mark.parametrize("run", ["port", "port_remat"])
def test_single_trainer_with_aux_weight_matches_jax(trained, run):
    jt, pt = trained["jax"], trained[run]
    assert [h.shape for h in pt.get_history()] == [(2,), (2,)]
    for a, b in zip(pt.get_history(), jt.get_history()):
        _close(a, b)
    ref = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        jt.trained_variables)]
    got = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        pt.trained_variables)]
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        _close(a, b)
    # the state holds each block's last training forward's aux loss
    aux = [float(a) for a in jax.tree_util.tree_leaves(
        pt.trained_variables["state"])]
    assert len(aux) == LM["num_blocks"] and all(a > 0.9 for a in aux)
    # and the aux term moved the trajectory
    no_aux = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        trained["port_no_aux"].trained_variables["params"])]
    pt_leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        pt.trained_variables["params"])]
    assert any(not np.array_equal(a, b) for a, b in zip(pt_leaves, no_aux))
    # no layer keeps a graph past its step, a remat recompute's included
    assert all(getattr(lyr, "live_aux_loss", None) is None
               for lyr in pt.model.iter_layers())
    copy.deepcopy(pt.model)


def test_checkpoint_leaf_order_with_the_aux_state(trained):
    """The port's checkpoint of the MoE run holds the JAX trainer's
    leaves, in its order (the ``aux_loss`` state leaves among them), and
    ``jax_leaf_names`` names them in that order."""
    def payload(directory):
        mgr = checkpoint.CheckpointManager(directory)
        with open(mgr.path(mgr.latest_step()), "rb") as f:
            return jax_serde.tree_from_bytes(f.read())
    want = payload(trained["tmp"] / "jax")["leaves"]
    got = payload(trained["tmp"] / "port")["leaves"]
    assert [(x.shape, x.dtype) for x in got] == \
        [(x.shape, x.dtype) for x in want]
    for x, y in zip(got[:-1], want[:-1]):   # all but the rng key
        _close(x, y)
    params, state = jax_leaf_names(trained["port"].model)
    assert state == [f"layer.layers.{i}.inner.layers.1.aux_loss"
                     for i in (3, 5)]
    assert params[-9:-3] == [
        "layer.layers.5.inner.layers.1.experts.b1",
        "layer.layers.5.inner.layers.1.experts.b2",
        "layer.layers.5.inner.layers.1.experts.w1",
        "layer.layers.5.inner.layers.1.experts.w2",
        "layer.layers.5.inner.layers.1.router.wg",
        "layer.layers.6.bias"]


def test_moe_with_a_mesh_raises_naming_item_8():
    model = zoo.gpt_lm(vocab_size=VOCAB, dim=16, num_heads=2, num_blocks=1,
                       seq_len=8, moe_experts=2).init(0, device="cpu")
    layer = next(lyr for lyr in model.iter_layers()
                 if isinstance(lyr, moe.MoEDense))
    layer.mesh = object()
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        model(torch.zeros((1, 8), dtype=torch.long))
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        moe.switch_moe_sharded(object(), {}, torch.zeros(4, 16))
