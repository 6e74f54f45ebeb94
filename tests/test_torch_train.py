"""The port's training slice against the JAX package, on the CPU: losses,
optimizers (against optax itself), the window loop, ``SingleTrainer``,
the data layer and the trainer's unported options.

Weights cross from JAX with ``load_jax_variables``; data are numpy arrays
handed to both packages.  JAX runs the Pallas flash kernels in interpret
mode, so the flash models here are small (T ≤ 32, dim 32, two blocks).
"""

import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import distkeras_tpu as dk
from distkeras_tpu.data.dataset import Dataset as JaxDataset
from distkeras_tpu.data.datasets import load_lm_corpus as jax_load_lm_corpus
from distkeras_tpu.models import zoo as jax_zoo
from distkeras_tpu.ops import losses as jax_losses
from distkeras_tpu.ops.optimizers import get_optimizer as jax_get_optimizer
from distkeras_tpu.parallel.sync import make_window_fn as jax_window_fn

import distkeras_tpu_torch as dkt
from distkeras_tpu_torch.data import Dataset, load_lm_corpus
from distkeras_tpu_torch.models import Model, zoo
from distkeras_tpu_torch.obs import Registry
from distkeras_tpu_torch.ops import losses
from distkeras_tpu_torch.ops.optimizers import get_optimizer
from distkeras_tpu_torch.parallel import make_window_fn, model_params
from distkeras_tpu_torch.utils import load_jax_variables, to_numpy_variables
from distkeras_tpu_torch.utils.metrics import MetricsLogger

# pytest-xdist's workers share the cores: an intra-op pool of the
# workers' share each, not one of every core per worker
if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, os.cpu_count()
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

VOCAB, SEQ = 17, 32
LM = dict(vocab_size=VOCAB, dim=32, num_heads=2, num_blocks=2, seq_len=SEQ,
          attention_impl="flash")
SCE = "sparse_categorical_crossentropy"


def _leaves(variables):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(
        variables["params"])]


def _port_of(jax_model, jax_vars):
    """The port's model of ``jax_model``'s config, holding ``jax_vars``."""
    model = Model.from_config(jax_model.config()).init(0, device="cpu")
    load_jax_variables(model, jax.tree_util.tree_map(np.asarray, jax_vars))
    return model


def _init_from_jax(model, jax_model):
    """Make ``model.init(seed)`` load the JAX model's ``init(seed)`` weights
    (the two packages' generators differ), so a trainer that initialises
    from its seed starts where the JAX trainer does."""
    build = model.init

    def init(seed=0, device=None):
        build(seed, device=device)
        load_jax_variables(model, jax.tree_util.tree_map(
            np.asarray, jax_model.init(seed)))
        return model
    model.init = init
    return model


@pytest.fixture(scope="module")
def lm_pair():
    jm = jax_zoo.gpt_lm(**LM)
    return jm, jm.init(0)


@pytest.fixture(scope="module")
def lm_batches():
    ds = load_lm_corpus(n_train=64, seq_len=SEQ, vocab_size=VOCAB)[0]
    stacked, _ = ds.stacked(["features", "label"], 16)
    return stacked["features"][0], stacked["label"][0]   # (4, 16, SEQ)


# -- losses -------------------------------------------------------------------

def _loss_inputs(name, probs):
    rng = np.random.default_rng(3)
    if name.startswith("sparse"):
        x = rng.normal(size=(4, 6, 5)).astype(np.float32)
        y = rng.integers(0, 5, size=(4, 6)).astype(np.int64)
    elif name.startswith("categorical"):
        x = rng.normal(size=(8, 5)).astype(np.float32)
        y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, size=8)]
    elif name.startswith("binary"):
        x = rng.normal(size=(8, 1)).astype(np.float32)
        y = rng.integers(0, 2, size=8).astype(np.float32)
    else:
        x = rng.normal(size=(8, 3)).astype(np.float32)
        y = rng.normal(size=(8, 3)).astype(np.float32)
    if probs:   # probabilities, some pushed into the clipped range
        if name.startswith("binary"):
            x = 1 / (1 + np.exp(-4 * x))
        else:
            x = np.exp(4 * x) / np.exp(4 * x).sum(-1, keepdims=True)
    return x, y


@pytest.mark.parametrize("name,probs", [
    *((n, False) for n in losses.LOSSES),
    ("categorical_crossentropy", True),
    ("sparse_categorical_crossentropy", True),
    ("binary_crossentropy", True)])
def test_loss_matches_jax(name, probs):
    x, y = _loss_inputs(name, probs)
    if probs:
        fn, ref_fn = losses.probs_loss_variant(name), \
            jax_losses.probs_loss_variant(name)
    else:
        fn, ref_fn = losses.get_loss(name), jax_losses.get_loss(name)
    got = fn(torch.from_numpy(x), torch.from_numpy(y))
    ref = ref_fn(jnp.asarray(x), jnp.asarray(y))
    assert got.ndim == 0
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)


def test_get_loss_passes_callables_and_no_variant_for_mse():
    assert losses.get_loss(losses.mean_squared_error) is \
        losses.mean_squared_error
    assert losses.probs_loss_variant("mse") is None


# -- optimizers -----------------------------------------------------------------

@pytest.mark.parametrize("name", ["sgd", "momentum", "nesterov", "adagrad",
                                  "adadelta", "rmsprop", "adam"])
def test_optimizer_matches_optax(name):
    """Five steps of each named rule on a small tree, against the optax
    transformation the JAX package resolves the same name to."""
    rng = np.random.default_rng(7)
    shapes = {"a": (3, 4), "b": (5,)}
    params = {n: rng.normal(size=s).astype(np.float32)
              for n, s in shapes.items()}
    grads = [{n: rng.normal(size=s).astype(np.float32)
              for n, s in shapes.items()} for _ in range(5)]
    ref_opt = jax_get_optimizer(name, 0.1)
    ref = {n: jnp.asarray(p) for n, p in params.items()}
    ref_state = ref_opt.init(ref)
    opt = get_optimizer(name, 0.1)
    got = {n: torch.from_numpy(p.copy()) for n, p in params.items()}
    state = opt.init(got)
    for g in grads:
        upd, ref_state = ref_opt.update(
            {n: jnp.asarray(x) for n, x in g.items()}, ref_state, ref)
        ref = optax.apply_updates(ref, upd)
        upd, state = opt.update({n: torch.from_numpy(x) for n, x in
                                 g.items()}, state, got)
        got = {n: got[n] + upd[n] for n in got}
        for n in shapes:
            np.testing.assert_allclose(got[n].numpy(), np.asarray(ref[n]),
                                       rtol=1e-6, atol=1e-7)


def test_optimizer_names():
    opt = get_optimizer("sgd", 0.1)
    assert get_optimizer(opt) is opt
    with pytest.raises(ValueError, match="unknown optimizer"):
        get_optimizer("lamb")


# -- the window loop ---------------------------------------------------------------

def _jax_window(jm, jv, opt_name, lr, xs, ys, compute_dtype=None):
    run = jax_window_fn(jm, jax_losses.get_loss(SCE),
                        jax_get_optimizer(opt_name, lr),
                        compute_dtype=compute_dtype)
    jv = jax.tree_util.tree_map(jnp.array, jv)   # run donates its carry
    opt = jax_get_optimizer(opt_name, lr)
    out, _, _, jl = run(jv, opt.init(jv["params"]), jax.random.PRNGKey(1),
                        jnp.asarray(xs), jnp.asarray(ys))
    return out, np.asarray(jl, np.float32)


def _port_window(jm, jv, opt_name, lr, xs, ys, **kw):
    model = _port_of(jm, jv)
    opt = get_optimizer(opt_name, lr)
    run = make_window_fn(model, losses.get_loss(SCE), opt, **kw)
    params = model_params(model)
    _, _, pl = run(params, opt.init(params), torch.from_numpy(xs),
                   torch.from_numpy(ys))
    assert pl.shape == (xs.shape[0],) and pl.dtype == torch.float32
    return model, pl.numpy()


def test_window_sgd_params_match_jax(lm_pair, lm_batches):
    """Four SGD steps of the flash LM from carried weights: the losses
    and every parameter equal the JAX package's window scan."""
    jm, jv = lm_pair
    ref_vars, ref_losses = _jax_window(jm, jv, "sgd", 0.1, *lm_batches)
    model, got_losses = _port_window(jm, jv, "sgd", 0.1, *lm_batches)
    np.testing.assert_allclose(got_losses, ref_losses, rtol=1e-4)
    for a, b in zip(_leaves(to_numpy_variables(model)), _leaves(ref_vars)):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_window_adam_losses_match_jax(lm_pair, lm_batches):
    jm, jv = lm_pair
    _, ref_losses = _jax_window(jm, jv, "adam", 3e-3, *lm_batches)
    _, got_losses = _port_window(jm, jv, "adam", 3e-3, *lm_batches)
    np.testing.assert_allclose(got_losses, ref_losses, rtol=1e-4)


def test_window_remat_equals_no_remat(lm_pair, lm_batches):
    jm, jv = lm_pair
    m1, l1 = _port_window(jm, jv, "adam", 3e-3, *lm_batches)
    m2, l2 = _port_window(jm, jv, "adam", 3e-3, *lm_batches, remat=True)
    np.testing.assert_allclose(l2, l1, rtol=1e-6)
    for a, b in zip(_leaves(to_numpy_variables(m2)),
                    _leaves(to_numpy_variables(m1))):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_window_bf16_compute_matches_jax(lm_pair, lm_batches):
    """``compute_dtype=bfloat16``: the forward runs on bf16 copies, the
    f32 masters take the gradients (they stay f32 and move)."""
    jm, jv = lm_pair
    _, ref_losses = _jax_window(jm, jv, "sgd", 0.1, *lm_batches,
                                compute_dtype=jnp.bfloat16)
    model, got_losses = _port_window(jm, jv, "sgd", 0.1, *lm_batches,
                                     compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(got_losses, ref_losses, rtol=2e-2)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    start = _leaves(jax.tree_util.tree_map(np.asarray, jv))
    moved = [not np.array_equal(a, b) for a, b in
             zip(_leaves(to_numpy_variables(model)), start)]
    assert all(moved)


# -- SingleTrainer ------------------------------------------------------------------

def test_single_trainer_matches_jax_trainer():
    """``SingleTrainer`` on the flash LM (shuffled, SGD, 2 epochs of 4
    steps) against the JAX package's trainer from the same init: the
    per-epoch mean losses and the trained parameters."""
    ds_kw = dict(n_train=128, seq_len=SEQ, vocab_size=VOCAB)
    kw = dict(num_epoch=2, batch_size=32, learning_rate=0.1)
    jm = jax_zoo.gpt_lm(**LM)
    jt = dk.SingleTrainer(jm, "sgd", SCE, **kw)
    jt.train(jax_load_lm_corpus(**ds_kw)[0], shuffle=True)
    model = _init_from_jax(zoo.gpt_lm(**LM), jm)
    t = dkt.SingleTrainer(model, "sgd", SCE, device="cpu", **kw)
    assert t.train(load_lm_corpus(**ds_kw)[0], shuffle=True) is model
    np.testing.assert_allclose(t.get_averaged_history(),
                               jt.get_averaged_history(), rtol=1e-4)
    assert [h.shape for h in t.get_history()] == [(4,), (4,)]
    for a, b in zip(_leaves(t.trained_variables),
                    _leaves(jt.trained_variables)):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_gpt_lm_trains_next_token():
    """Mirror of ``tests/test_lm.py::test_gpt_lm_trains_next_token`` on the
    flash model."""
    ds = load_lm_corpus(n_train=512, seq_len=SEQ, vocab_size=VOCAB)[0]
    t = dkt.SingleTrainer(zoo.gpt_lm(**LM), "adam", SCE,
                          features_col="features", label_col="label",
                          num_epoch=8, batch_size=64, learning_rate=3e-3,
                          device="cpu")
    m = t.train(ds)
    with torch.no_grad():
        pred = m(torch.from_numpy(ds["features"])).argmax(-1).numpy()
    assert float((pred == ds["label"]).mean()) > 0.95
    hist = t.get_averaged_history()
    assert hist[-1] < hist[0]


def test_transformer_classifier_trains_through_the_probs_loss():
    """The classifier ends in a softmax Dense: the trainer swaps in the
    from-probs loss, its forward equals JAX's, and two epochs from the
    same init give JAX's per-epoch losses."""
    cfg = dict(vocab_size=50, dim=32, num_heads=2, num_blocks=1,
               seq_len=16, num_classes=3)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 50, size=(96, 16)).astype(np.int32)
    y = (x.sum(-1) % 3).astype(np.int64)
    jm = jax_zoo.transformer_classifier(**cfg)
    jv = jm.init(0)
    model = _port_of(jm, jv)
    with torch.no_grad():
        got = model(torch.from_numpy(x[:8])).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.predict_fn()(jv, x[:8])),
                               rtol=2e-5, atol=1e-7)

    kw = dict(num_epoch=2, batch_size=32, learning_rate=0.05)
    jt = dk.SingleTrainer(jm, "sgd", SCE, **kw)
    jt.train(JaxDataset({"features": x, "label": y}))
    t = dkt.SingleTrainer(_init_from_jax(zoo.transformer_classifier(**cfg),
                                         jm), "sgd", SCE, device="cpu", **kw)
    assert t._resolve()[0] is losses.sparse_categorical_crossentropy_from_probs
    t.train(Dataset({"features": x, "label": y}))
    np.testing.assert_allclose(t.get_averaged_history(),
                               jt.get_averaged_history(), rtol=1e-4)


def test_trainer_records_epochs_spans_and_retraces():
    """Epoch records carry the history's means; the first window call runs
    under a ``jit_compile`` span; a second ``train()`` on the same shapes
    is warm, one on a new batch size counts a retrace."""
    sink = io.StringIO()
    t = dkt.SingleTrainer(zoo.gpt_lm(**LM), "sgd", SCE, num_epoch=2,
                          batch_size=32, learning_rate=0.1, metrics=sink,
                          device="cpu")
    t.tracer.registry = Registry()
    ds = load_lm_corpus(n_train=64, seq_len=SEQ, vocab_size=VOCAB)[0]
    t.train(ds)
    t.train(ds)
    reg = t.tracer.registry
    assert reg.counter("jit.compiles").value == 1
    assert reg.get("jit.retraces") is None   # created at the first retrace
    t.batch_size = 16
    t.train(ds)
    assert (reg.counter("jit.compiles").value,
            reg.counter("jit.retraces").value) == (2, 1)
    recs = [json.loads(line) for line in sink.getvalue().splitlines()]
    epochs = [r for r in recs if r["event"] == "epoch"]
    assert len(epochs) == 6 and all(r["samples_per_sec"] > 0 for r in epochs)
    np.testing.assert_allclose(epochs[-1]["mean_loss"],
                               t.get_averaged_history()[-1], rtol=1e-6)
    spans = [r["path"] for r in recs if r["event"] == "span"]
    assert spans.count("train/jit_compile") == 2 and spans.count("train") == 3
    assert any(r["event"] == "retrace" for r in recs)


# -- data -----------------------------------------------------------------------------

def test_dataset_stacked_and_shuffle_match_jax():
    rng = np.random.default_rng(2)
    cols = {"features": rng.normal(size=(37, 3)).astype(np.float32),
            "label": rng.integers(0, 4, size=37)}
    ours, ref = Dataset(cols, 3), JaxDataset(cols, 3)
    assert ours.partition_sizes() == ref.partition_sizes()
    for a, b in ((ours.shuffle(5), ref.shuffle(5)), (ours, ref)):
        got, steps = a.stacked(["features", "label"], 4)
        want, ref_steps = b.stacked(["features", "label"], 4)
        assert steps == ref_steps
        for c in want:
            np.testing.assert_array_equal(got[c], want[c])


def test_load_lm_corpus_matches_jax():
    for a, b in zip(load_lm_corpus(40, 12, 9, seed=3)[:2],
                    jax_load_lm_corpus(40, 12, 9, seed=3)[:2]):
        for c in ("features", "label"):
            np.testing.assert_array_equal(a[c], b[c])
            assert a[c].dtype == b[c].dtype


# -- what is not ported yet --------------------------------------------------------------

def test_unported_trainer_options_raise():
    model = zoo.gpt_lm(**LM)
    for profile in ("trace", {"step_split": True}):
        with pytest.raises(NotImplementedError, match="Queue 1 item 7 "):
            dkt.SingleTrainer(model, profile=profile, device="cpu")


def test_trainer_needs_a_card_or_an_explicit_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dkt.SingleTrainer(zoo.gpt_lm(**LM))


def test_metrics_logger_writes_strict_json():
    sink = io.StringIO()
    log = MetricsLogger(sink)
    log.log("x", v=float("nan"), t=torch.arange(3), a=np.ones(100))
    rec = json.loads(sink.getvalue())
    assert rec["v"] == "NaN" and rec["t"] == [0, 1, 2]
    assert rec["a"]["shape"] == [100] and log.records[-1]["event"] == "x"
