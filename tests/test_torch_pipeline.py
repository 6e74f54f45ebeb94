"""The port's GPipe pipeline (``parallel.pipeline``) and
``PipelineTrainer`` against the JAX package's, on the CPU.

The port's ranks are four gloo child processes spawned once
(``tests/test_torch_mesh_child.py``): pp 4, pp 2 × dp 2, and pp 2 as two
replicas (an outer axis no spec names).  The JAX reference runs over the
fake devices of ``tests/conftest.py``.  ``pipeline_apply_sharded``'s
forward and vjp (the residual MLP stage of ``tests/test_pipeline.py``)
within 1e-5; ``PipelineTrainer`` on the flash ``gpt_lm`` against JAX's:
losses within rtol 1e-4, trained parameters within 1e-4 of each leaf's
largest |value|; the schedule's M + S − 1 ticks read off the
``ppermute`` count and the attention's plain-version calls; each rank's
stage half the stack; resume (a port checkpoint resumed by the JAX
trainer too); mixed precision; and the refusals, in one process.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu as dk
from distkeras_tpu.data.datasets import load_lm_corpus
from distkeras_tpu.models.layers import BatchNorm as JaxBatchNorm
from distkeras_tpu.models.layers import Dense as JaxDense
from distkeras_tpu.models.layers import Residual as JaxResidual
from distkeras_tpu.models.layers import Sequential as JaxSequential
from distkeras_tpu.parallel.mesh import make_mesh as jax_make_mesh
from distkeras_tpu.parallel.pipeline import (
    find_stage_segment as jax_find_stage_segment)
from distkeras_tpu.parallel.pipeline import (
    pipeline_apply_sharded as jax_pipeline_apply_sharded)
from distkeras_tpu.parallel.pipeline import (
    stack_stage_params as jax_stack_stage_params)

import distkeras_tpu_torch as dkt
from distkeras_tpu_torch.models import Model
from distkeras_tpu_torch.parallel.pipeline import find_stage_segment
from test_torch_mesh_child import run_ranks

if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, os.cpu_count()
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

D = 16
#: (case id, mesh shape, axis names, S, M, dp axis, bf16 tokens)
APPLY = [("pp2_m2", (2,), ("pp",), 2, 2, None, False),
         ("pp2_m4", (2,), ("pp",), 2, 4, None, False),
         ("pp4_m2", (4,), ("pp",), 4, 2, None, False),
         ("pp4_m4", (4,), ("pp",), 4, 4, None, False),
         ("pp2xdp2", (2, 2), ("pp", "dp"), 2, 2, "dp", False),
         ("pp2_bf16", (2,), ("pp",), 2, 4, None, True)]
#: the trainer's meshes: pp 2 as two replicas, and pp 2 × dp 2
TRAIN = {"pp2": {"rep": 2, "pp": 2}, "pp2_dp2": {"pp": 2, "dp": 2}}
KW = dict(loss="sparse_categorical_crossentropy", features_col="features",
          label_col="label", num_epoch=2, batch_size=16,
          learning_rate=3e-3, seed=5)
M = 4
BLOCKS = 4


def _stage_params(s, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 0.5, (s, D, D)).astype(np.float32),
            rng.normal(0, 0.1, (s, D)).astype(np.float32))


def _jax_stage(params, x):
    return x + jnp.tanh(x @ params["w"] + params["b"])


def _lm(num_blocks=BLOCKS, impl="flash"):
    return dk.zoo.gpt_lm(vocab_size=17, dim=32, num_heads=2,
                         num_blocks=num_blocks, seq_len=16,
                         attention_impl=impl)


@pytest.fixture(scope="module")
def corpus():
    ds = load_lm_corpus(n_train=64, seq_len=16, vocab_size=17)[0]
    return np.asarray(ds["features"]), np.asarray(ds["label"])


@pytest.fixture(scope="module")
def lm_init():
    m = _lm()
    return m.config(), {KW["seed"]: jax.tree_util.tree_map(
        np.asarray, m.init(KW["seed"]))}


def _apply_inputs(s, bf16):
    w, b = _stage_params(s, seed=s)
    rng = np.random.default_rng(10 + s)
    x = rng.normal(size=(8, D)).astype(np.float32)
    ct = rng.normal(size=(8, D)).astype(np.float32)
    return w, b, x, ct


@pytest.fixture(scope="module")
def ranks(corpus, lm_init, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("pipe"))
    cases = []
    for cid, shape, names, s, m, dp, bf16 in APPLY:
        w, b, x, ct = _apply_inputs(s, bf16)
        cases.append((cid, "pipe_apply",
                      dict(w=w, b=b, x=x, ct=ct, mesh_shape=shape,
                           axis_names=names, num_microbatches=m,
                           dp_axis=dp, bf16=bf16)))
    x, y = corpus
    cfg, init = lm_init
    for cid, shape in TRAIN.items():
        cases.append((cid, "pipe_train",
                      dict(config=cfg, inits=init, x=x, y=y, kw=KW,
                           mesh_shape=shape, num_microbatches=M,
                           ckpt=tmp if cid == "pp2_dp2" else None)))
    cases.append(("bf16", "pipe_train",
                  dict(config=cfg, inits=init, x=x, y=y,
                       kw={**KW, "num_epoch": 4,
                           "compute_dtype": "bfloat16"},
                       mesh_shape=TRAIN["pp2"])))
    cases.append(("default_m", "pipe_train",
                  dict(config=cfg, inits=init, x=x, y=y,
                       kw={**KW, "num_epoch": 1}, mesh_shape={"pp": 4})))
    return run_ranks(4, cases)


@pytest.fixture(scope="module")
def jax_pipe():
    out = {}
    for cid, shape, names, s, m, dp, bf16 in APPLY:
        w, b, x, ct = _apply_inputs(s, bf16)
        mesh = jax_make_mesh(axis_names=names, shape=shape)
        stacked = jax_stack_stage_params(
            [{"w": jnp.asarray(w[i]), "b": jnp.asarray(b[i])}
             for i in range(s)])
        xj = jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)
        y, vjp = jax.vjp(lambda p, v: jax_pipeline_apply_sharded(
            mesh, _jax_stage, p, v, num_microbatches=m, dp_axis=dp),
            stacked, xj)
        dp_, dx = vjp(jnp.asarray(ct, y.dtype))
        out[cid] = {"out": np.asarray(y, np.float32),
                    "dw": np.asarray(dp_["w"]), "db": np.asarray(dp_["b"]),
                    "dx": np.asarray(dx, np.float32), "dtype": str(y.dtype)}
    return out


@pytest.fixture(scope="module")
def jax_trainers(corpus):
    x, y = corpus
    ds = dk.Dataset({"features": x, "label": y})
    out = {}
    for cid, shape in TRAIN.items():
        jshape = {k: v for k, v in shape.items() if k != "rep"}
        t = dk.PipelineTrainer(_lm(), "adam", mesh_shape=jshape,
                               num_microbatches=M, **KW)
        out[cid] = (t, t.train(ds))
    return out


@pytest.fixture(scope="module")
def port_single(corpus, lm_init):
    """The port's ``SingleTrainer`` on the trainer cases' model, init and
    data: GPipe reorders the compute and must not change the math."""
    from distkeras_tpu_torch.utils import load_jax_variables
    from distkeras_tpu_torch.utils import to_numpy_variables
    cfg, init = lm_init
    model = Model.from_config(cfg)
    build = model.init

    def init_jax(seed=0, device=None):
        build(seed, device=device)
        load_jax_variables(model, init[int(seed)])
        return model
    model.init = init_jax
    x, y = corpus
    t = dkt.SingleTrainer(model, "adam", device="cpu", **KW)
    t.train(dkt.Dataset({"features": x, "label": y}))
    return to_numpy_variables(model)


def _close_leaves(got, want, rel=1e-4, over_tree=False):
    """Leaf by leaf within ``rel`` of the reference leaf's largest |value|
    (``over_tree``: of the whole tree's)."""
    got, want = (jax.tree_util.tree_leaves(t) for t in (got, want))
    assert len(got) == len(want)
    top = max(float(np.max(np.abs(np.asarray(w)))) for w in want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape
        bound = rel * (top if over_tree else
                       max(float(np.max(np.abs(w))), 1e-30))
        assert float(np.max(np.abs(g - w))) <= bound, \
            (i, float(np.max(np.abs(g - w))), bound)


# ---------------------------------------------------------------------------
# the stage segment (one process)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stages", [4, 2, 7, 1])
def test_find_stage_segment_equals_jax(stages):
    """``gpt_lm``'s [Emb, Pos, (Res, FF)×4, LN, Dense]: 4 stages of the
    2-layer block, 2 of 4 layers, none at 7; pp = 1 extends the unit's
    run."""
    jm = _lm(impl="dense")
    pm = Model.from_config(jm.config())
    if stages == 7:
        for layers, fn in ((jm.layer.layers, jax_find_stage_segment),
                           (pm.layer.layers, find_stage_segment)):
            with pytest.raises(ValueError, match="homogeneous"):
                fn(layers, stages)
        return
    assert find_stage_segment(pm.layer.layers, stages) == \
        jax_find_stage_segment(jm.layer.layers, stages)


def test_find_stage_segment_pp1_single_occurrence():
    """pp = 1 on a stack whose unit occurs once: without a shape an
    error, with one the longest shape-preserving span, as JAX's."""
    jm = _lm(num_blocks=1, impl="dense")
    pm = Model.from_config(jm.config())
    with pytest.raises(ValueError, match="pp=1"):
        find_stage_segment(pm.layer.layers, 1)
    assert find_stage_segment(pm.layer.layers, 1,
                              input_shape=pm.input_shape) == \
        jax_find_stage_segment(jm.layer.layers, 1,
                               input_shape=jm.input_shape)


# ---------------------------------------------------------------------------
# pipeline_apply_sharded (ranks)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cid", [c[0] for c in APPLY])
def test_pipeline_apply_forward_and_vjp_equal_jax(ranks, jax_pipe, cid):
    want = jax_pipe[cid]
    s, m = next((c[3], c[4]) for c in APPLY if c[0] == cid)
    for res in ranks:
        got = res[cid]
        assert got["dtype"] == "torch.float32" and want["dtype"] == "float32"
        for k in ("out", "dw", "db", "dx"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-5, err_msg=k)
        # the GPipe schedule: M + S − 1 ticks, each a forward ppermute; the
        # backward permutes back every tick but the last (whose output no
        # tick reads)
        assert got["ppermutes"] == (m + s - 1) + (m + s - 2)


def test_pipeline_apply_validates_shapes():
    """A batch the microbatches do not divide, and a stack whose lead dim
    is not the stage count, are refused (one process: pp 1)."""
    from distkeras_tpu_torch.parallel.mesh import make_mesh
    from distkeras_tpu_torch.parallel.pipeline import pipeline_apply_sharded
    mesh = make_mesh(axis_names=("pp",), shape=(1,), devices="cpu")
    w, b = _stage_params(1)
    params = {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
    stage = lambda p, x: x + torch.tanh(x @ p["w"] + p["b"])  # noqa: E731
    with pytest.raises(ValueError, match="not divisible"):
        pipeline_apply_sharded(mesh, stage, params, torch.zeros(30, D),
                               num_microbatches=4)
    bad = {k: torch.cat([v, v]) for k, v in params.items()}
    with pytest.raises(ValueError, match="stages"):
        pipeline_apply_sharded(mesh, stage, bad, torch.zeros(8, D),
                               num_microbatches=4)


# ---------------------------------------------------------------------------
# PipelineTrainer (ranks)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cid", list(TRAIN))
def test_pipeline_trainer_matches_jax(ranks, jax_trainers, port_single,
                                      cid):
    """Losses within rtol 1e-4 of JAX's; trained parameters within 1e-4
    of each leaf's largest |value| of the port's ``SingleTrainer`` run
    (read 9e-6: the schedule changes no math) and within 1e-4 of the
    whole tree's largest |value| of JAX's pipeline (read 4.3e-5).  Leaf
    by leaf the port and JAX differ under Adam as much without a
    pipeline: their ``SingleTrainer`` runs read 1.6e-4 at the last FF
    block's second kernel, where the two JAX trainers read 4e-5."""
    t, m = jax_trainers[cid]
    hist = [np.asarray(h) for h in t.get_history()]
    for res in ranks:
        got = res[cid]
        assert len(got["history"]) == len(hist)
        for g, h in zip(got["history"], hist):
            np.testing.assert_allclose(g, h, rtol=1e-4)
        _close_leaves(got["variables"]["params"], port_single["params"])
        _close_leaves(got["variables"]["params"], m.variables["params"],
                      over_tree=True)
    a, b = (jax.tree_util.tree_leaves(r[cid]["variables"])
            for r in (ranks[0], ranks[3]))
    assert all(np.array_equal(u, v) for u, v in zip(a, b))


@pytest.mark.parametrize("cid", list(TRAIN))
def test_each_rank_holds_half_the_stack_and_runs_the_schedule(ranks,
                                                               lm_init,
                                                               cid):
    """A rank's stage parameters are 1/S of the stack's bytes, and its
    attention runs (M + S − 1) × (blocks a stage) times a step, forward
    and backward: bubble ticks included."""
    init = lm_init[1][KW["seed"]]["params"]
    stack = sum(np.asarray(leaf).nbytes for layer in init[2:2 + 2 * BLOCKS]
                for leaf in jax.tree_util.tree_leaves(layer))
    steps = KW["num_epoch"] * 64 // KW["batch_size"]
    S = 2
    for res in ranks:
        got = res[cid]
        assert got["stage_bytes"] * S == stack
        assert got["calls"] == {"fwd": (M + S - 1) * BLOCKS // S * steps,
                                "bwd": (M + S - 1) * BLOCKS // S * steps}


def test_num_microbatches_defaults_to_the_stage_count(ranks):
    steps = 64 // KW["batch_size"]
    for res in ranks:
        # pp 4, M = S = 4: 7 ticks of one attention block a stage
        assert res["default_m"]["calls"]["fwd"] == (4 + 4 - 1) * steps


def test_resume_equals_the_straight_run_and_jax_reads_the_file(
        ranks, corpus):
    """One epoch, a checkpoint (the whole stacked tree in the JAX
    trainer's format), then a resumed run: it equals the straight run,
    and the JAX trainer resumes from the port's file to the same
    losses."""
    x, y = corpus
    for res in ranks:
        got, straight = res["pp2_dp2"]["resumed"], res["pp2_dp2"]
        assert len(got["history"]) == 1
        np.testing.assert_allclose(got["history"][0],
                                   straight["history"][-1], rtol=1e-6)
        _close_leaves(got["variables"], straight["variables"], rel=1e-6)
    from distkeras_tpu_torch.utils.checkpoint import CheckpointManager
    cdir = ranks[0]["pp2_dp2"]["ckpt_dir"]
    ck = CheckpointManager(cdir)
    for step in ck.steps()[1:]:
        os.unlink(ck.path(step))  # keep the first epoch's file only
    t = dk.PipelineTrainer(_lm(), "adam", mesh_shape={"pp": 2, "dp": 2},
                           num_microbatches=M, **KW, checkpoint_dir=cdir)
    t.train(dk.Dataset({"features": x, "label": y}), resume=True)
    assert len(t.get_history()) == 1
    np.testing.assert_allclose(np.asarray(t.get_history()[0]),
                               ranks[0]["pp2_dp2"]["history"][-1],
                               rtol=1e-4)


def test_mixed_precision_trains_with_f32_masters(ranks):
    for res in ranks:
        got = res["bf16"]
        h = [float(np.mean(e)) for e in got["history"]]
        assert h[-1] < h[0] * 0.6, h
        assert got["params_dtypes"] == ["torch.float32"]


# ---------------------------------------------------------------------------
# refusals and pp = 1 (one process)
# ---------------------------------------------------------------------------

def _toy_ds(n=64, d=16):
    rng = np.random.default_rng(0)
    return dkt.Dataset({
        "features": rng.normal(size=(n, d)).astype(np.float32),
        "label_onehot": np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]})


def _blocks_model(block):
    return Model.from_config(dk.Model(JaxSequential(
        [JaxDense(16)] + [JaxResidual(JaxSequential(block()))
                          for _ in range(4)] + [JaxDense(3, "softmax")]),
        input_shape=(16,)).config())


@pytest.mark.parametrize("kind", ["stateful", "dropout", "sequential",
                                  "pp_axis", "microbatches"])
def test_pipeline_trainer_refusals(kind):
    from distkeras_tpu.models.layers import Dropout as JaxDropout
    kw = dict(features_col="features", label_col="label_onehot",
              device="cpu", mesh_shape={"pp": 1})
    if kind == "pp_axis":
        with pytest.raises(ValueError, match="'pp' axis"):
            dkt.PipelineTrainer(_blocks_model(lambda: [JaxDense(16)]),
                                mesh_shape={"dp": 1}, device="cpu")
        return
    if kind == "stateful":
        model, match = _blocks_model(
            lambda: [JaxDense(16), JaxBatchNorm()]), "stateless"
    elif kind == "dropout":
        model, match = _blocks_model(
            lambda: [JaxDense(16), JaxDropout(0.1)]), "rng-consuming"
    elif kind == "sequential":
        model, match = Model.from_config(dk.Model(
            JaxResidual(JaxSequential([JaxDense(16)])),
            input_shape=(16,)).config()), "Sequential"
    else:
        model, match = _blocks_model(lambda: [JaxDense(16)]), "divisible"
        kw["num_microbatches"] = 3
    t = dkt.PipelineTrainer(model, "sgd", "categorical_crossentropy", **kw)
    with pytest.raises(ValueError, match=match):
        t.train(_toy_ds())


def test_pipeline_trainer_pp1_single_block_matches_single_trainer(corpus,
                                                                   lm_init):
    """pp = 1 on ``gpt_lm(num_blocks=1)``: the degenerate pipeline (the
    shape-preserving span) trains as ``SingleTrainer`` does."""
    x, y = corpus
    ds = dkt.Dataset({"features": x, "label": y})
    cfg = _lm(num_blocks=1).config()
    kw = {**KW, "device": "cpu"}
    a = dkt.SingleTrainer(Model.from_config(cfg), "adam", **kw)
    a.train(ds)
    b = dkt.PipelineTrainer(Model.from_config(cfg), "adam",
                            mesh_shape={"pp": 1}, num_microbatches=2, **kw)
    b.train(ds)
    np.testing.assert_allclose(np.concatenate(b.get_history()),
                               np.concatenate(a.get_history()), rtol=1e-5)
