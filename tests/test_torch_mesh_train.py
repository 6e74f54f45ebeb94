"""The port's sync trainers over a mesh of processes, ``BatchNorm(
axis_name)`` and the async cluster (``ps.cluster``) against the JAX
package's, on the CPU.

The port's ranks are gloo child processes (``tests/test_torch_mesh_child.
py``: the port alone, its ``init`` loading the JAX model's
``init(seed)``); the JAX reference runs here, one process over the fake
devices of ``tests/conftest.py`` — the shape of ``tests/test_multiprocess.
py:396-452``, where JAX splits its 8 workers over two processes.  Every
sync algorithm trains 8 workers over a 2-process mesh (4 a rank): the
trained center (every member for ``EnsembleTrainer``) and the (8, steps)
loss history within rtol 1e-4 plus 1e-6 of the largest |value| (over the
whole tree for a center: the Dense bias before a BatchNorm is exactly 0
and holds rounding noise alone; the edge
sums each rank's stack, then over the ranks: another order than XLA's
all-reduce), the same on both ranks; ADAG also with per-rank checkpoints,
and streamed from shard files.  ``BatchNorm(axis_name="workers")`` at 2
ranks against a 2-device JAX mesh: the output, the new statistics and
each rank's gradients within rtol 1e-5 plus 1e-6 of the largest |value|;
and ADAG over a BatchNorm model at one worker a rank.  The async cluster
trains DOWNPOUR with the PS on process 0: the same center on both ranks,
exact commit counts, and a worker's failure raised on every rank.
"""

import os

import jax
import numpy as np
import pytest
import torch

import distkeras_tpu as dk
from distkeras_tpu.data.streaming import ShardedFileDataset as JaxSFD
from distkeras_tpu.models.layers import Activation as JaxActivation
from distkeras_tpu.models.layers import BatchNorm as JaxBatchNorm
from distkeras_tpu.models.layers import Dense as JaxDense
from distkeras_tpu.models.layers import Sequential as JaxSequential
from distkeras_tpu.parallel.mesh import make_mesh as jax_make_mesh
from distkeras_tpu.parallel.mesh import shard_map as jax_shard_map
from distkeras_tpu.parallel.sync import _shard_map_kw
from jax.sharding import PartitionSpec as JP

import distkeras_tpu_torch as dkt
from distkeras_tpu_torch.models import Model
from distkeras_tpu_torch.models.layers import BatchNorm
from distkeras_tpu_torch.parallel.mesh import make_mesh
from test_torch_mesh_child import free_port, run_ranks

W = 8
KW = dict(loss="categorical_crossentropy", features_col="features",
          label_col="label_onehot", num_epoch=2, batch_size=16,
          learning_rate=0.05, communication_window=2, device="cpu")
ALGOS = {"ADAG": {}, "DOWNPOUR": {}, "DynSGD": {},
         "AEASGD": dict(rho=1.0), "EAMSGD": dict(rho=1.0),
         "AveragingTrainer": {}, "EnsembleTrainer": {}}
#: the JAX package's cluster test (tests/test_multiprocess.py:200): its
#: toy problem of 2048 rows, DOWNPOUR at window 4, 4 epochs of batch 32
CLUSTER = dict(loss="categorical_crossentropy", features_col="features",
               label_col="label_onehot", num_epoch=4, batch_size=32,
               learning_rate=0.05, communication_window=4)
CLUSTER_ROWS = 2048


def _close(got, ref, rtol=1e-4, atol_of_max=1e-6):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    bound = atol_of_max * float(np.max(np.abs(ref))) + rtol * np.abs(ref)
    assert bool(np.all(np.abs(got - ref) <= bound)), \
        float(np.max(np.abs(got - ref)))


def _close_tree(got, want, rtol=1e-4, atol_of_max=1e-6):
    """Leaf by leaf, the absolute part over the whole tree's largest
    |value|: a leaf whose exact value is 0 (the bias before a BatchNorm,
    whose gradient is 0) holds rounding noise alone."""
    got, want = (list(jax.tree_util.tree_leaves(t)) for t in (got, want))
    assert len(got) == len(want)
    top = max(float(np.max(np.abs(np.asarray(w)))) for w in want)
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape
        assert bool(np.all(np.abs(g - w) <= atol_of_max * top
                           + rtol * np.abs(w))), float(np.max(np.abs(g - w)))


def _toy(n=512, d=10, k=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d, k)).astype(np.float32)
    y = np.argmax(x @ w + 0.1 * rng.normal(size=(n, k)), axis=-1)
    return x, np.eye(k, dtype=np.float32)[y]


def _mlp(bn=False):
    layers = [JaxDense(16)]
    if bn:
        layers.append(JaxBatchNorm(axis_name="workers"))
    layers += [JaxActivation("relu"), JaxDense(3, "softmax")]
    return dk.Model(JaxSequential(layers), input_shape=(10,))


def _inits(model, seeds):
    return {s: jax.tree_util.tree_map(np.asarray, model.init(s))
            for s in seeds}


def _jax_run(name, x, y, workers=W, bn=False, stream_dir=None):
    model = _mlp(bn)
    kw = {k: v for k, v in KW.items() if k != "device"}
    cls = getattr(dk, name)
    t = cls(model, num_ensembles=workers, **ALGOS[name], **kw) \
        if name == "EnsembleTrainer" else \
        cls(model, num_workers=workers, **ALGOS[name], **kw)
    ds = dk.Dataset({"features": x, "label_onehot": y})
    if stream_dir is not None:
        ds = JaxSFD.write(ds, stream_dir, rows_per_shard=64)
    out = t.train(ds)
    hist = [np.asarray(h) for h in t.get_history()]
    if isinstance(out, list):
        return hist, [jax.tree_util.tree_leaves(m.variables) for m in out]
    return hist, jax.tree_util.tree_leaves(out.variables)


@pytest.fixture(scope="module")
def data():
    return _toy()


@pytest.fixture(scope="module")
def ranks(data, tmp_path_factory):
    x, y = data
    cfg = _mlp().config()
    inits = _inits(_mlp(), range(W))
    bn_cfg = _mlp(bn=True).config()
    bn_inits = _inits(_mlp(bn=True), (0,))
    tmp = str(tmp_path_factory.mktemp("mesh_train"))
    cases = [(name, "sync_train",
              dict(name=name, config=cfg, inits=inits, x=x, y=y,
                   mesh_shape=(W,), kw={**KW, **ALGOS[name]},
                   ckpt=tmp if name == "ADAG" else None))
             for name in ALGOS]
    cases.append(("stream", "sync_train",
                  dict(name="ADAG", config=cfg, inits=inits, x=x, y=y,
                       mesh_shape=(W,), kw=KW, stream=tmp)))
    cases.append(("bn_adag", "sync_train",
                  dict(name="ADAG", config=bn_cfg, inits=bn_inits, x=x,
                       y=y, mesh_shape=(2,), kw=KW)))
    rng = np.random.default_rng(3)
    bn_in = dict(x=rng.normal(size=(2, 6, 4)).astype(np.float32) + 1.0,
                 w=rng.normal(size=(2, 6, 4)).astype(np.float32),
                 scale=rng.normal(size=(4,)).astype(np.float32),
                 bias=rng.normal(size=(4,)).astype(np.float32))
    cases.append(("bn", "bn", dict(mesh_shape=(2,), **bn_in)))
    cx, cy = _toy(CLUSTER_ROWS)
    cases.append(("cluster", "cluster",
                  dict(config=cfg, inits=inits, x=cx, y=cy, kw=CLUSTER,
                       port=free_port())))
    cases.append(("cluster_fail", "cluster",
                  dict(config=cfg, inits=inits, x=cx, y=cy, kw=CLUSTER,
                       port=free_port(), fail_rank=1)))
    return run_ranks(2, cases), bn_in, tmp


@pytest.mark.parametrize("name", list(ALGOS))
def test_sync_trainer_over_a_two_process_mesh_matches_jax(data, ranks,
                                                         name):
    hist, want = _jax_run(name, *data)
    results = ranks[0]
    for res in results:
        got = res[name]
        assert [h.shape for h in got["history"]] == \
            [h.shape for h in hist] == [(W, 4)] * KW["num_epoch"]
        for g, h in zip(got["history"], hist):
            _close(g, h)
        if name == "EnsembleTrainer":
            assert len(got["members"]) == W
            for member, ref in zip(got["members"], want):
                _close_tree(member, ref)
        else:
            _close_tree(got["center"], want)
    a, b = (jax.tree_util.tree_leaves(r[name].get("center",
                                                  r[name].get("members")))
            for r in results)
    assert all(np.array_equal(u, v) for u, v in zip(a, b))


def test_sync_checkpoints_are_written_on_every_rank(ranks):
    """Each rank writes every worker's leaves into its own directory (the
    JAX two-process test's per-rank ``checkpoint_dir``)."""
    results, _, tmp = ranks
    for r, res in enumerate(results):
        steps = res["ADAG"]["ckpt_steps"]
        assert steps and steps == sorted(os.listdir(
            os.path.join(tmp, f"rank{r}")))
    from distkeras_tpu_torch.utils import checkpoint
    a, b = (checkpoint.CheckpointManager(os.path.join(tmp, f"rank{r}"))
            for r in (0, 1))
    assert a.steps() == b.steps() == [0, 1]


def test_sync_streaming_over_a_two_process_mesh_matches_jax(data, ranks,
                                                           tmp_path,
                                                           monkeypatch):
    import distkeras_tpu.data.streaming as jax_streaming
    monkeypatch.setattr(jax_streaming, "_has_tf", lambda: False)
    hist, want = _jax_run("ADAG", *data, stream_dir=str(tmp_path / "s"))
    for res in ranks[0]:
        got = res["stream"]
        for g, h in zip(got["history"], hist):
            _close(g, h)
        _close_tree(got["center"], want)


def _jax_bn(x, w, scale, bias):
    mesh = jax_make_mesh(2, ("workers",))
    bn = JaxBatchNorm(axis_name="workers")
    state = {"mean": np.zeros(4, np.float32), "var": np.ones(4, np.float32)}

    def per(x, w):
        def loss(x, params):
            out, new = bn.apply(params, state, x[0], train=True)
            return (out * w[0]).sum(), (out, new)
        (gx, gp), (out, new) = jax.grad(loss, argnums=(0, 1), has_aux=True)(
            x, {"scale": scale, "bias": bias})
        return (out[None], new["mean"][None], new["var"][None], gx,
                gp["scale"][None], gp["bias"][None])
    f = jax_shard_map(per, mesh=mesh, in_specs=(JP("workers"),) * 2,
                      out_specs=(JP("workers"),) * 6, **_shard_map_kw())
    return [np.asarray(a) for a in jax.jit(f)(x, w)]


def test_batchnorm_over_the_workers_axis_matches_jax(ranks):
    results, bn_in, _ = ranks
    out, mean, var, gx, gs, gb = _jax_bn(**bn_in)
    for r, res in enumerate(results):
        got = res["bn"]
        for g, want in ((got["out"], out[r]), (got["state"]["mean"], mean[r]),
                        (got["state"]["var"], var[r]), (got["dx"], gx[r]),
                        (got["dscale"], gs[r]), (got["dbias"], gb[r])):
            _close(g, want, rtol=1e-5)


def test_adag_over_a_batchnorm_model_one_worker_a_rank_matches_jax(
        data, ranks):
    hist, want = _jax_run("ADAG", *data, workers=2, bn=True)
    for res in ranks[0]:
        got = res["bn_adag"]
        for g, h in zip(got["history"], hist):
            _close(g, h)
        _close_tree(got["center"], want)


def test_batchnorm_axis_name_refuses_several_workers_a_rank(data):
    """Workers that step one after another on a rank cannot share batch
    statistics mid-forward: the layer raises, naming that condition."""
    model = Model.from_config(_mlp(bn=True).config())
    t = dkt.ADAG(model, num_workers=2, mesh=make_mesh(2, devices="cpu"),
                 **KW)
    with pytest.raises(ValueError, match="holds 2 slots of the 'workers'"):
        t.train(dkt.Dataset({"features": data[0],
                             "label_onehot": data[1]}))
    bn = BatchNorm(axis_name="workers")
    bn.build((4,), None)
    bn.train(True)
    with pytest.raises(RuntimeError, match="needs a current mesh"):
        bn(torch.ones(3, 4))


def test_cluster_async_training_over_two_processes(ranks):
    results = ranks[0]
    a, b = (r["cluster"] for r in results)
    assert "error" not in a and "error" not in b
    # every process returns the center process 0's PS trained
    assert all(np.array_equal(u, v) for u, v in zip(
        jax.tree_util.tree_leaves(a["center"]),
        jax.tree_util.tree_leaves(b["center"])))
    # one commit per window: 2048 rows over 2 workers at batch 32 is 32
    # steps, 8 windows of 4, an epoch
    windows = CLUSTER_ROWS // 2 // CLUSTER["batch_size"] \
        // CLUSTER["communication_window"] * CLUSTER["num_epoch"]
    assert a["commits_by_worker"] == {0: windows, 1: windows}
    assert a["num_updates"] == 2 * windows
    assert len(a["history"]) == len(b["history"]) == CLUSTER["num_epoch"]
    # the center trained: it classifies the toy problem, as the JAX
    # package's cluster test asks (accuracy > 0.8)
    x, y = _toy(CLUSTER_ROWS)
    model = Model.from_config(_mlp().config()).init(0, device="cpu")
    from distkeras_tpu_torch.utils import load_jax_variables
    load_jax_variables(model, a["center"])
    with torch.no_grad():
        pred = model(torch.from_numpy(x)).argmax(-1).numpy()
    assert float((pred == y.argmax(-1)).mean()) > 0.8


def test_cluster_worker_failure_raises_on_every_process(ranks):
    a, b = (r["cluster_fail"] for r in ranks[0])
    assert a["error"].startswith("RuntimeError: async PS worker failed on "
                                 "process(es) [1]"), a
    assert b["error"] == "RuntimeError: injected worker crash", b
