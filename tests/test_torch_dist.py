"""The port's sync distributed trainers against the JAX package's, on the
CPU: ``ADAG``, ``DOWNPOUR``, ``DynSGD``, ``AEASGD``, ``EAMSGD``,
``AveragingTrainer`` and ``EnsembleTrainer``, the window-edge rules, and
the trainers' options and refusals.

JAX runs its workers on the 8 fake devices of ``tests/conftest.py`` (one
worker per device, ``lax.pmean``/``lax.psum`` at the edge); the port runs
them one after another on the CPU, with the edge a mean or sum over the
stacked worker axis.  Both start from the JAX model's ``init(seed)``
(``_init_from_jax``: the port's ``init`` loads it, for any seed, so an
ensemble's members ``seed + i`` match too) and see the same numpy data.

Tolerance: rtol 1e-5 plus 1e-6 of the largest |value| of the reference
(``_close``), on the trained center (or every member) and the per-worker
loss histories.  The reductions sum in another order (XLA's all-reduce
across devices against ``torch.sum`` over dim 0, and the matmuls' own
blocking): on the MLP toy problem, 2 epochs of 2 windows of 2 steps at 4
workers, the largest gap read 2.1e-7 of the largest |value| in the
trained variables (EnsembleTrainer's members; ADAG 1.5e-7) and 1.9e-7 in
the losses (AEASGD, AveragingTrainer).
"""

import inspect
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu as dk
from distkeras_tpu.data.transformers import OneHotTransformer as JaxOneHot
from distkeras_tpu.models import zoo as jax_zoo
from distkeras_tpu.models.layers import Dense as JaxDense
from distkeras_tpu.models.layers import Sequential as JaxSequential
from distkeras_tpu.parallel import sync as jax_sync
from distkeras_tpu.parallel.mesh import make_mesh, shard_map
from jax.sharding import PartitionSpec as P

import chip_smoke
import distkeras_tpu_torch as dkt
from distkeras_tpu_torch.data.transformers import OneHotTransformer
from distkeras_tpu_torch.models import Model, zoo
from distkeras_tpu_torch.models.layers import BatchNorm
from distkeras_tpu_torch.parallel import sync
from distkeras_tpu_torch.predictors import ModelPredictor
from distkeras_tpu_torch.ps.cluster import run_cluster_async_training
from distkeras_tpu_torch.utils import load_jax_variables, to_numpy_variables

# pytest-xdist's workers share the cores: an intra-op pool of the
# workers' share each, not one of every core per worker
if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, os.cpu_count()
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

W, WINDOW, EPOCHS = 4, 2, 2
COMMON = dict(loss="categorical_crossentropy", features_col="features",
              label_col="label_onehot", num_epoch=EPOCHS, batch_size=32,
              learning_rate=0.05, communication_window=WINDOW)
#: the algorithms and their own arguments (AEASGD's rho as the
#: reference's convergence test sets it)
ALGOS = {"ADAG": {}, "DOWNPOUR": {}, "DynSGD": {},
         "AEASGD": dict(rho=1.0), "EAMSGD": dict(rho=1.0),
         "AveragingTrainer": {}, "EnsembleTrainer": {}}
#: the JAX package's f32 BatchNorm run strays from the exact step by up
#: to this much in its trained parameters (tests/test_torch_zoo.py:46):
#: the reference is held at its own reading
JAX_F32_WITNESS_ATOL = 1.5e-3


def _close(got, ref, rtol=1e-5, atol_of_max=1e-6, atol=0.0):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    bound = atol + atol_of_max * float(np.max(np.abs(ref))) + \
        rtol * np.abs(ref)
    assert bool(np.all(np.abs(got - ref) <= bound)), \
        float(np.max(np.abs(got - ref)))


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _toy(n=512, d=10, k=3, seed=0):
    """``tests/test_trainers_sync.py:toy_problem`` at n rows: (features,
    labels) numpy arrays."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d, k)).astype(np.float32)
    y = np.argmax(x @ w + 0.1 * rng.normal(size=(n, k)), axis=-1)
    return x, y


@pytest.fixture(scope="module")
def data():
    x, y = _toy()
    jds = JaxOneHot(3, "label", "label_onehot").transform(
        dk.Dataset({"features": x, "label": y}))
    pds = OneHotTransformer(3, "label", "label_onehot").transform(
        dkt.Dataset({"features": x, "label": y}))
    return jds, pds


def _jax_mlp():
    return dk.Model(JaxSequential([JaxDense(32, "relu"),
                                   JaxDense(3, "softmax")]), input_shape=(10,))


def _init_from_jax(model, jax_init):
    """Make ``model.init(seed)`` load ``jax_init(seed)`` (the two
    packages' generators differ), so a trainer that initialises from its
    seed starts where the JAX trainer does."""
    build = model.init

    def init(seed=0, device=None):
        build(seed, device=device)
        load_jax_variables(model, jax.tree_util.tree_map(
            np.asarray, jax_init(seed)))
        return model
    model.init = init
    return model


def _port_twin(jm, jax_init=None):
    return _init_from_jax(Model.from_config(jm.config()),
                          jax_init or jm.init)


def _make(pkg, name, model, **kw):
    workers = dict(num_ensembles=W) if name == "EnsembleTrainer" \
        else dict(num_workers=W)
    return getattr(pkg, name)(model, **{**COMMON, **workers, **ALGOS[name],
                                        **kw})


@pytest.fixture(scope="module")
def jax_runs(data):
    """Each algorithm's JAX run: (trained variables or members, history).
    ``jax.jit`` runs inside the trainers; one module-scope run each."""
    out = {}
    for name in ALGOS:
        t = _make(dk, name, _jax_mlp())
        res = t.train(data[0])
        members = [m.variables for m in res] if isinstance(res, list) \
            else [t.trained_variables]
        out[name] = ([_leaves(v) for v in members],
                     [np.asarray(h) for h in t.get_history()])
    return out


@pytest.mark.parametrize("name", sorted(ALGOS))
def test_sync_trainer_matches_jax(name, data, jax_runs):
    """The trained center (every member, for the ensemble) and the
    per-worker loss histories against the JAX trainer's, within
    ``_close``'s bound."""
    jm = _jax_mlp()
    t = _make(dkt, name, _port_twin(jm), device="cpu")
    res = t.train(data[1])
    members = [to_numpy_variables(m) for m in res] \
        if isinstance(res, list) else [t.trained_variables]
    want_members, want_hist = jax_runs[name]
    assert len(members) == len(want_members)
    for got, want in zip(members, want_members):
        got = _leaves(got)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _close(a, b)
    hist = t.get_history()
    assert len(hist) == EPOCHS
    for got, want in zip(hist, want_hist):
        assert got.shape == want.shape == (W, 2 * WINDOW)
        _close(got, want)
    if name == "EnsembleTrainer":
        assert all(isinstance(m, Model) for m in res) and len(res) == W
        np.testing.assert_array_equal(
            _leaves(t.trained_variables)[0], _leaves(members[0])[0])
        # members start from seeds 0..W-1, so they differ
        assert not np.allclose(_leaves(members[0])[0],
                               _leaves(members[1])[0])


@pytest.fixture
def all_cores():
    """torch's intra-op pool on every core for one test, whatever the cap
    above.  oneDNN's f32 conv weight gradient splits its batch reduction
    over the pool's threads, and how it splits sets its error: against
    float64, ResNet-20's first conv kernel after two ADAG windows reads
    3.3e-7 with 8 threads and 9.6e-5 with 1 or 2.  Yields the capped
    pool size the test was given, for work whose result does not depend
    on the split (float64 convs: see the test below)."""
    before = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count())
    yield before
    torch.set_num_threads(before)


def test_float64_conv_gradients_do_not_depend_on_the_thread_count(
        all_cores):
    """Why the float64 witness below may run in the capped pool and the
    f32 run may not: the conv weight gradient at ResNet-20 width 4's
    shapes (batch 8) is bit-identical at 1 thread and on every core in
    float64, while in f32 (oneDNN splits the batch reduction over the
    pool) it is not, which an 8-core host shows (up to 4e-4 apart)."""
    shapes = ((3, 32, 4), (4, 32, 4), (8, 16, 8), (16, 8, 16))
    rng = np.random.default_rng(0)
    cases = []
    for c, h, k in shapes:
        cases.append((rng.uniform(0, 1, (8, c, h, h)),
                      rng.normal(size=(k, c, 3, 3)) * 0.1,
                      rng.normal(size=(8, k, h, h))))

    def weight_grads(threads, dtype):
        torch.set_num_threads(threads)
        out = []
        for x, w, g in cases:
            w = torch.tensor(w, dtype=dtype, requires_grad=True)
            y = torch.nn.functional.conv2d(torch.tensor(x, dtype=dtype), w,
                                           padding=1)
            out.append(torch.autograd.grad(
                y, w, torch.tensor(g, dtype=dtype))[0].numpy().tobytes())
        return out

    # ``all_cores`` restores the capped pool afterwards
    assert weight_grads(1, torch.float64) == \
        weight_grads(os.cpu_count(), torch.float64)
    if os.cpu_count() >= 8:
        # the control: the f32 split shows on 8 threads
        assert weight_grads(1, torch.float32) != \
            weight_grads(os.cpu_count(), torch.float32)


#: the f32 half of ``test_adag_moves_batchnorm_state_through_the_rule``,
#: run in a process of its own (argv: the pickled inputs, the pickled
#: outputs)
_F32_EVERY_CORE = """
import os, pickle, sys
import torch
import distkeras_tpu_torch as dkt
from distkeras_tpu_torch.models import Model
from distkeras_tpu_torch.utils import load_jax_variables

torch.set_num_threads(os.cpu_count())
with open(sys.argv[1], "rb") as f:
    cfg, variables, x, y, kw = pickle.load(f)
model = Model.from_config(cfg)
build = model.init


def init(seed=0, device=None):
    build(seed, device=device)
    load_jax_variables(model, variables)
    return model


model.init = init
pt = dkt.ADAG(model, device="cpu", **kw)
pt.train(dkt.Dataset({"features": x, "label_onehot": y}))
# every worker holds the center after the edge
held = all(torch.equal(stack, pt.center["state"][n].expand_as(stack))
           for n, stack in pt.local["state"].items())
with open(sys.argv[2], "wb") as f:
    pickle.dump((pt.trained_variables, pt.get_history()[0], held), f)
"""


def _adag_f32_on_every_core(cfg, variables, x, y, kw, tmp_path):
    """``ADAG`` over the model of ``cfg`` holding ``variables``, f32, with
    torch's pool on every core, in a child process whose OpenMP threads
    sleep at a barrier instead of spinning (``OMP_WAIT_POLICY=PASSIVE``,
    read only when OpenMP starts): beside five busy pytest-xdist workers
    the spinning pool took this run from about 1 s to 35-80 s.  The wait
    policy does not change how oneDNN splits its sums.  Returns (trained
    variables, the first epoch's losses, whether every worker's state
    equals the center's)."""
    import pickle
    import subprocess
    import sys
    src, out = tmp_path / "f32_in.pkl", tmp_path / "f32_out.pkl"
    with open(src, "wb") as f:
        pickle.dump((cfg, variables, x, y, kw), f)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_WAIT_POLICY="PASSIVE",
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    res = subprocess.run([sys.executable, "-c", _F32_EVERY_CORE, str(src),
                          str(out)], cwd=root, env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    with open(out, "rb") as f:
        return pickle.load(f)


def test_adag_moves_batchnorm_state_through_the_rule(all_cores, tmp_path):
    """ADAG on ``resnet20(width=4)``: BatchNorm's running statistics are
    float leaves of ``state`` and go through the mean at every edge.  From
    the same weights (the port's init, handed to JAX), 1 epoch of 2
    windows of 2 steps, batch 8, lr 0.01 (the yaml's DOWNPOUR ResNet-20
    rate): the port's center within 1e-5 of its own float64 run (the
    witness; read 1.6e-7), and within ``JAX_F32_WITNESS_ATOL`` of the JAX
    trainer's, whose f32 BatchNorm statistics stray from the witness by
    1.3e-4 here (up to 3e-3 at batch 4 or lr 0.05); losses within rtol
    1e-4 of JAX's.

    The float64 witness runs in the capped pool (``all_cores`` yields
    it): float64 convs take torch's own kernels, not oneDNN's split
    (``test_float64_conv_gradients_do_not_depend_on_the_thread_count``),
    and its trained variables read bit-identical at 1 and 8 threads,
    while 8 threads beside five busy workers took it from 2.7 s to
    117 s.  The f32 run takes every core in a child process whose
    threads do not spin (``_adag_f32_on_every_core``)."""
    jm = jax_zoo.resnet20(width=4)
    pm0 = Model.from_config(jm.config()).init(0, device="cpu")
    jv = jax.tree_util.tree_map(jnp.asarray, to_numpy_variables(pm0))
    jm.init = lambda seed=0: jv
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, size=(W * 8 * 4, 32, 32, 3)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, size=W * 8 * 4)]
    kw = dict(COMMON, num_workers=W, num_epoch=1, batch_size=8,
              learning_rate=0.01, communication_window=2)
    jt = dk.ADAG(jm, **kw)
    jt.train(dk.Dataset({"features": x, "label_onehot": y}))
    # the f32 run on every core (see ``all_cores``), in a child process
    got, losses, held = _adag_f32_on_every_core(
        jm.config(), to_numpy_variables(pm0), x, y, kw, tmp_path)
    m64 = _port_twin(jm)
    build = m64.init
    m64.init = lambda seed=0, device=None: build(seed, device).double()
    wt = dkt.ADAG(m64, device="cpu", **kw)
    capped = all_cores
    torch.set_num_threads(capped)
    try:
        wt.train(dkt.Dataset({"features": x.astype(np.float64),
                              "label_onehot": y.astype(np.float64)}))
    finally:
        torch.set_num_threads(os.cpu_count())
    for kind in ("params", "state"):
        for a, b, c in zip(_leaves(got[kind]),
                           _leaves(jt.trained_variables[kind]),
                           _leaves(wt.trained_variables[kind])):
            _close(a, c, rtol=0.0, atol_of_max=0.0, atol=1e-5)
            _close(a, b, rtol=0.0, atol_of_max=0.0,
                   atol=JAX_F32_WITNESS_ATOL)
    np.testing.assert_allclose(losses, jt.get_history()[0], rtol=1e-4)
    # the state moved, and every worker holds the center after the edge
    init_state = _leaves(to_numpy_variables(pm0)["state"])
    assert all(not np.allclose(a, b) for a, b in
               zip(_leaves(got["state"]), init_state))
    assert held


# -- the rules ----------------------------------------------------------------

def _rule_pair(name):
    alpha = 0.25
    return {"adag": (sync.AdagSync(), jax_sync.AdagSync()),
            "downpour": (sync.DownpourSync(), jax_sync.DownpourSync()),
            "dynsgd": (sync.DynSgdSync(), jax_sync.DynSgdSync()),
            "easgd": (sync.EasgdSync(alpha), jax_sync.EasgdSync(alpha)),
            "none": (sync.NoCommSync(), jax_sync.NoCommSync())}[name]


@pytest.mark.parametrize("name", ["adag", "downpour", "dynsgd", "easgd",
                                  "none"])
def test_rule_math_on_a_stacked_tree(name):
    """Every rule on a stacked (8, 4) tree, against its closed form and
    against the JAX rule under ``shard_map`` on the 8 fake devices.  An
    integer leaf passes every rule unchanged."""
    rng = np.random.default_rng(5)
    c = rng.normal(size=4).astype(np.float32)
    l = np.arange(32, dtype=np.float32).reshape(8, 4)
    n_c, n_l = np.zeros(4, np.int32), np.arange(32, dtype=np.int32).reshape(
        8, 4)
    port, ref = _rule_pair(name)
    center = {"params": {"w": torch.from_numpy(c)},
              "state": {"n": torch.from_numpy(n_c)}}
    local = {"params": {"w": torch.from_numpy(l)},
             "state": {"n": torch.from_numpy(n_l)}}
    c2, l2 = port.communicate(center, local)
    got_c, got_l = c2["params"]["w"].numpy(), l2["params"]["w"].numpy()
    assert got_l.shape == (8, 4)
    np.testing.assert_array_equal(c2["state"]["n"].numpy(), n_c)
    np.testing.assert_array_equal(l2["state"]["n"].numpy(), n_l)
    closed = {
        "adag": (l.mean(0), np.tile(l.mean(0), (8, 1))),
        "downpour": (c + (l - c).sum(0), np.tile(c + (l - c).sum(0), (8, 1))),
        "easgd": (c + (0.25 * (l - c)).sum(0), l - 0.25 * (l - c)),
        "none": (c, l)}
    closed["dynsgd"] = closed["downpour"]
    np.testing.assert_allclose(got_c, closed[name][0], rtol=1e-6)
    np.testing.assert_allclose(got_l, closed[name][1], rtol=1e-6)

    def f(cc, ll):
        c3, l3 = ref.communicate(cc, jax.tree_util.tree_map(
            lambda a: a[0], ll), "workers")
        return c3, jax.tree_util.tree_map(lambda a: a[None], l3)
    jc, jl = shard_map(f, mesh=make_mesh(8), in_specs=(P(), P("workers")),
                       out_specs=(P(), P("workers")),
                       **jax_sync._shard_map_kw())(
        {"params": {"w": c}, "state": {"n": n_c}},
        {"params": {"w": l}, "state": {"n": n_l}})
    _close(got_c, jc["params"]["w"])
    _close(got_l, jl["params"]["w"])
    np.testing.assert_array_equal(np.asarray(jl["state"]["n"]), n_l)


def test_tree_helpers_and_float_leaves():
    a = {"params": [torch.ones(2)], "state": {"n": torch.arange(2)}}
    b = {"params": [torch.full((2,), 3.0)], "state": {"n": torch.ones(2,
         dtype=torch.int64)}}
    assert sync.tree_add(a, b)["params"][0].tolist() == [4.0, 4.0]
    assert sync.tree_sub(b, a)["params"][0].tolist() == [2.0, 2.0]
    assert sync.tree_scale(b, 0.5)["params"][0].tolist() == [1.5, 1.5]
    merged = sync.adopt_float_leaves(b, a)
    assert merged["params"][0] is b["params"][0]
    assert merged["state"]["n"] is a["state"]["n"]
    assert sync._inexact(np.float32(1)) and not sync._inexact(np.int32(1))
    assert sync._inexact(torch.zeros(1, dtype=torch.bfloat16))


def test_worker_models_are_views_into_the_stack(data):
    """After a window, each worker model's parameters are its slice of the
    stacked local tree (the optimizer's in-place update wrote through), and
    under ADAG every slice equals the center."""
    t = dkt.ADAG(Model.from_config(_jax_mlp().config()), device="cpu",
                 **{**COMMON, "num_epoch": 1}, num_workers=W)
    t.train(data[1])
    engine = t._engine_cache[1]
    for k, worker in enumerate(engine.workers):
        for name, p in worker.named_parameters():
            stack = t.local["params"][name]
            assert p.data_ptr() == stack[k].data_ptr()
            assert torch.equal(p, t.center["params"][name])


def test_window_fn_drives_the_epoch_one_window_at_a_time(data):
    """``SyncEngine.window_fn`` (the streaming trainers' unit) over an
    epoch's windows gives the epoch program's losses and center, bit for
    bit."""
    def trainer():
        return dkt.ADAG(Model.from_config(_jax_mlp().config()), device="cpu",
                        num_workers=W, **{**COMMON, "num_epoch": 1})
    ref = trainer()
    ref.train(data[1])
    t = trainer()
    engine, _ = t._engine("epoch")
    xs, ys, n_windows = t._stage_data(data[1], WINDOW)
    center, local = t._init_variables()
    engine.bind(local)
    opt_state = engine.init_opt_state()
    engine.seed(t.seed + 1)
    run = engine.window_fn()
    losses = [run(center, local, opt_state, torch.from_numpy(xs[:, w]),
                  torch.from_numpy(ys[:, w])).losses
              for w in range(n_windows)]
    np.testing.assert_array_equal(torch.cat(losses, 1).numpy(),
                                  ref.get_history()[0])
    for a, b in zip(_leaves(to_numpy_variables(t.model)),
                    _leaves(ref.trained_variables)):
        np.testing.assert_array_equal(a, b)


# -- the trainers' own behaviour ---------------------------------------------

def test_downpour_with_one_worker_and_window_1_is_the_single_trainer(data):
    """DOWNPOUR(num_workers=1, communication_window=1): the center adds
    the one worker's change every step (center + (local − center)), so it
    follows SingleTrainer within that sum's rounding."""
    jm = _jax_mlp()
    kw = {k: v for k, v in COMMON.items() if k != "communication_window"}
    single = dkt.SingleTrainer(_port_twin(jm), "sgd", device="cpu", **kw)
    single.train(data[1])
    t = dkt.DOWNPOUR(_port_twin(jm), device="cpu", num_workers=1,
                     communication_window=1, **kw)
    t.train(data[1])
    for got, want in zip(t.get_history(), single.get_history()):
        assert got.shape == (1, want.shape[0])
        _close(got[0], want, rtol=1e-6, atol_of_max=1e-7)
    for a, b in zip(_leaves(t.trained_variables),
                    _leaves(single.trained_variables)):
        _close(a, b, rtol=1e-6, atol_of_max=1e-7)


def test_same_seed_runs_are_bitwise_identical(data):
    runs = []
    for _ in range(2):
        t = dkt.ADAG(Model.from_config(_jax_mlp().config()), device="cpu",
                     num_workers=W, **COMMON)
        t.train(data[1])
        runs.append((_leaves(t.trained_variables), t.get_history()))
    for a, b in zip(runs[0][0] + runs[0][1], runs[1][0] + runs[1][1]):
        np.testing.assert_array_equal(a, b)


def test_config_key_rebuilds_after_a_changed_learning_rate(data):
    """The cached engine must rebuild when a hyperparameter changes between
    ``train()`` calls: at lr 0 no loss moves."""
    t = dkt.ADAG(Model.from_config(_jax_mlp().config()), device="cpu",
                 num_workers=W, **COMMON)
    t.train(data[1])
    engine = t._engine_cache[1]
    h = t.get_averaged_history()
    assert h[-1] < h[0]
    t.history.clear()
    t.learning_rate = 0.0
    t.train(data[1])
    assert t._engine_cache[1] is not engine
    h = t.get_history()
    np.testing.assert_array_equal(h[0], h[-1])
    key = t._config_key()
    assert (W, WINDOW, None, None) == key[-4:]
    eam = dkt.EAMSGD(Model.from_config(_jax_mlp().config()), device="cpu",
                     rho=2.0, momentum=0.5)
    assert eam._config_key()[-2:] == (2.0, 0.5) and eam.alpha == 0.02


def test_stage_data_refuses_a_window_past_the_steps_and_warns_on_a_rest(
        data):
    t = dkt.ADAG(Model.from_config(_jax_mlp().config()), device="cpu",
                 num_workers=W, **{**COMMON, "communication_window": 5})
    with pytest.raises(ValueError, match="communication_window 5 exceeds "
                                         "the 4 steps available"):
        t.train(data[1])
    t.communication_window = 3
    with pytest.warns(UserWarning, match="1 of 4 per-worker batches don't "
                                         "fill a communication_window of 3"):
        xs, ys, n = t._stage_data(data[1], 3)
    assert xs.shape == (W, 1, 3, 32, 10) and ys.shape == (W, 1, 3, 32, 3)
    assert n == 1
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        t._stage_data(data[1], 2)


def test_unported_options_raise_naming_their_roadmap_item(data):
    model = Model.from_config(_jax_mlp().config())
    # the sharded PS is ported; the multi-host async runner is item 8's
    dkt.ADAG(model, mode="async", ps_shards=2, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        run_cluster_async_training(
            dkt.DOWNPOUR(model, mode="async", device="cpu"), data[1],
            ps_address=("127.0.0.1", 0))
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        dkt.DOWNPOUR(model, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        sync.SyncEngine(model, None, None, sync.AdagSync(), 2, 2,
                        mesh=object())
    for bad, match in ((dict(mode="spmd"), "mode must be"),
                       (dict(async_workers="fibers"), "async_workers"),
                       (dict(ps_shards=0), "ps_shards must be >= 1"),
                       (dict(comm_codec="zip"), "unknown comm_codec"),
                       (dict(comm_codec="topkx"), "fraction suffix"),
                       (dict(comm_codec="topk2"), r"in \(0, 1\]"),
                       (dict(comm_down="none2"), "unknown comm_codec"),
                       (dict(comm_down="bf16", comm_codec="bfloat16"), None)):
        if match is None:
            t = dkt.ADAG(model, device="cpu", **bad)
            assert t.comm_down == "bf16" and t.comm_codec == "bfloat16"
            continue
        with pytest.raises(ValueError, match=match):
            dkt.ADAG(model, device="cpu", **bad)
    assert dkt.ADAG(model, device="cpu", comm_down="topk0.5").comm_down == \
        "topk0.5"
    assert dkt.ADAG(model, device="cpu",
                    comm_down="adaptive").comm_down == "adaptive"
    with pytest.raises(ValueError, match="EAMSGD defines its own"):
        dkt.EAMSGD(model, "adam", device="cpu")


@pytest.mark.parametrize("name", ["DistributedTrainer", "ADAG", "DOWNPOUR",
                                  "DynSGD", "AEASGD", "EAMSGD",
                                  "AveragingTrainer", "EnsembleTrainer"])
def test_signatures_and_defaults_are_the_jax_packages(name):
    def params(cls):
        return [(p.name, p.default, p.kind) for p in
                inspect.signature(cls.__init__).parameters.values()]
    assert params(getattr(dkt, name)) == params(getattr(dk, name))
    assert getattr(dkt, name)._default_window == \
        getattr(dk, name)._default_window
    for rule in ("SyncEngine", "AdagSync", "DownpourSync", "DynSgdSync",
                 "EasgdSync", "NoCommSync"):
        assert getattr(dkt.parallel, rule) is getattr(sync, rule)


def test_model_predictor_keeps_its_devices_argument():
    model = Model.from_config(_jax_mlp().config()).init(0, device="cpu")
    pred = ModelPredictor(model, devices=["cpu"])
    assert pred._devices == ["cpu"]
    out = pred.predict(dkt.Dataset({"features": np.zeros((3, 10),
                                                         np.float32)}))
    assert out["prediction"].shape == (3, 3)
    assert ModelPredictor(model)._devices is None


def test_batchnorm_axis_name_points_at_the_multi_card_item():
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        BatchNorm(axis_name="workers")


def test_chip_smoke_dist_configs_are_the_yaml_files():
    """``chip_smoke.DIST_CONFIGS``, ``YAML_LM_CONFIGS`` and
    ``STREAM_CONFIGS`` (hard-coded: the card's machine has no yaml)
    against ``configs/bench_all.yaml``, ``quick`` and ``streaming``
    included where a config has them."""
    yaml = pytest.importorskip("yaml")
    with open("configs/bench_all.yaml") as f:
        cfgs = {c["name"]: c for c in yaml.safe_load(f)["configs"]}
    mine_all = {**chip_smoke.DIST_CONFIGS, **chip_smoke.YAML_LM_CONFIGS,
                **chip_smoke.STREAM_CONFIGS}
    assert len(mine_all) == len(chip_smoke.DIST_CONFIGS) + 3
    assert set(mine_all) <= set(cfgs)
    for name, mine in mine_all.items():
        ref = cfgs[name]
        for key in ("trainer", "model", "dataset", "onehot",
                    "dataset_kwargs", "trainer_kwargs"):
            assert mine[key] == ref.get(key), (name, key)
        assert mine["model_kwargs"] == ref.get("model_kwargs", {}), name
        for key in ("quick", "streaming"):
            if key in mine:
                assert mine[key] == ref[key], (name, key)
    assert all(c.get("streaming") for c in chip_smoke.STREAM_CONFIGS.values())
    assert "quick" in chip_smoke.YAML_LM_CONFIGS["GPT-LM flash T=256 (bf16)"]
    runs = {trainer for trainer, _ in chip_smoke.DIST_RUNS}
    assert runs == {"ADAG", "DOWNPOUR", "AEASGD", "EAMSGD", "DynSGD",
                    "AveragingTrainer", "EnsembleTrainer"}
    assert all(cfg in chip_smoke.DIST_CONFIGS
               for _, cfg in chip_smoke.DIST_RUNS)
