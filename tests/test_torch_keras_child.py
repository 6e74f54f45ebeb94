"""The Keras-on-torch side of ``tests/test_torch_keras.py``: holds no
tests.

    python tests/test_torch_keras_child.py WORKDIR

runs with ``KERAS_BACKEND=torch`` (``tests/conftest.py`` pins the JAX
backend in the pytest process).  It reads ``WORKDIR/inputs.pkl`` — each
architecture's initial weights from the Keras-JAX model (its
``trainable_variables`` and ``non_trainable_variables`` lists) and the
datasets — builds the same Keras models on torch, assigns those
weights, and drives them through the port (``KerasAdapter`` and the
port's trainers, on the CPU).  It writes ``WORKDIR/results.pkl``: the
forwards, the f32 trajectories, and what each training case read.
Imports neither JAX nor the JAX package.
"""

import os
import pickle
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def builders(keras):
    """Architecture name -> a function building the Keras model (the same
    code runs in the JAX process)."""
    L = keras.layers

    def mlp():
        return keras.Sequential([L.Input((10,)),
                                 L.Dense(32, activation="relu"),
                                 L.Dense(3, activation="softmax")])

    def dropout():
        return keras.Sequential([L.Input((10,)),
                                 L.Dense(32, activation="relu"),
                                 L.Dropout(0.25),
                                 L.Dense(3, activation="softmax")])

    def convbn():
        return keras.Sequential([L.Input((6, 6, 1)),
                                 L.Conv2D(8, 3, padding="same"),
                                 L.BatchNormalization(), L.ReLU(),
                                 L.GlobalAveragePooling2D(),
                                 L.Dense(2, activation="softmax")])

    def lstm():
        inp = L.Input((12,))
        h = L.Embedding(40, 16)(inp)
        h = L.LSTM(16)(h)
        return keras.Model(inp, L.Dense(3, activation="softmax")(h))

    def transformer(vocab=40, dim=16, seq=12):
        inp = L.Input((seq,))
        h = L.Embedding(vocab, dim)(inp)
        a = L.MultiHeadAttention(num_heads=2, key_dim=dim // 2)(h, h)
        h = L.LayerNormalization()(h + a)
        f = L.Dense(2 * dim, activation="gelu")(h)
        f = L.Dense(dim)(f)
        h = L.LayerNormalization()(h + f)
        h = L.GlobalAveragePooling1D()(h)
        return keras.Model(inp, L.Dense(3, activation="softmax")(h))

    return {"mlp": mlp, "dropout": dropout, "convbn": convbn, "lstm": lstm,
            "transformer": transformer}


#: which dataset each architecture trains on
DATA = {"mlp": "toy", "dropout": "toy", "convbn": "img", "lstm": "seq",
        "transformer": "seq"}
#: the f32 trajectory: SGD steps of batch 32 from the carried weights
STEPS = dict(num_epoch=1, batch_size=32, learning_rate=0.05)
STEP_ROWS = 128
COMMON = dict(loss="categorical_crossentropy", features_col="features",
              label_col="label_onehot", num_epoch=3, batch_size=32,
              learning_rate=0.05, device="cpu")


def main(workdir: str) -> int:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    import keras

    import distkeras_tpu_torch as dkt
    from distkeras_tpu_torch import job_deployment, job_runner
    from distkeras_tpu_torch.evaluators import AccuracyEvaluator
    from distkeras_tpu_torch.models.keras_adapter import KerasAdapter
    from distkeras_tpu_torch.utils import serde
    from distkeras_tpu_torch.utils.weights import (load_jax_variables,
                                                   to_numpy_variables)

    threads = os.environ.get("DKT_TEST_THREADS")
    if threads:
        torch.set_num_threads(int(threads))
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    build = builders(keras)
    data = {k: dkt.Dataset(v) for k, v in inputs["data"].items()}

    def adapter(name, weights=None):
        keras.utils.set_random_seed(0)
        kmodel = build[name]()
        if weights is not None:
            for v, a in zip(kmodel.trainable_variables, weights["params"]):
                v.assign(a)
            for v, a in zip(kmodel.non_trainable_variables, weights["state"]):
                v.assign(a)
        return KerasAdapter(kmodel)

    def accuracy(model, ds):
        pred = dkt.ModelPredictor(model, "features").predict(ds)
        return AccuracyEvaluator("prediction", "label").evaluate(pred)

    out = {"forward": {}, "train_forward": {}, "steps": {}, "shapes": {}}
    for name, weights in inputs["weights"].items():
        model = adapter(name, weights).init(device="cpu")
        x = torch.from_numpy(data[DATA[name]]["features"][:16])
        out["shapes"][name] = {
            k: [tuple(t.shape) for t in v]
            for k, v in to_numpy_variables(model).items()}
        with torch.no_grad():
            out["forward"][name] = model(x).numpy()
        if name == "convbn":
            model.train(True)
            with torch.no_grad():
                y = model(x).numpy()
            out["train_forward"][name] = (
                y, [v.numpy() for v in model.layer.new_state.values()])
            model.train(False)
        if name != "dropout":
            t = dkt.SingleTrainer(adapter(name, weights), "sgd",
                                  **{**COMMON, **STEPS})
            trained = t.train(data[DATA[name]].take(STEP_ROWS))
            out["steps"][name] = (np.concatenate(t.get_history()),
                                  to_numpy_variables(trained))

    # -- training through the port's trainers (accuracy anchors) -------
    toy, img, seq = data["toy"], data["img"], data["seq"]
    acc = out["accuracy"] = {}
    acc["mlp_single"] = accuracy(dkt.SingleTrainer(
        adapter("mlp"), "sgd", **COMMON).train(toy), toy)
    acc["mlp_adag"] = accuracy(dkt.ADAG(
        adapter("mlp"), "sgd", num_workers=8, communication_window=4,
        **{**COMMON, "num_epoch": 12}).train(toy), toy)
    m = adapter("dropout")
    t = dkt.SingleTrainer(m, "sgd", **{**COMMON, "num_epoch": 6})
    trained = t.train(toy)
    acc["dropout_single"] = accuracy(trained, toy)
    xs = torch.from_numpy(toy["features"][:64])
    with torch.no_grad():
        out["dropout_eval_repeats"] = bool(torch.equal(trained(xs),
                                                       trained(xs)))
    acc["dropout_adag"] = accuracy(dkt.ADAG(
        adapter("dropout"), "sgd", num_workers=8, communication_window=4,
        **{**COMMON, "num_epoch": 12}).train(toy), toy)
    m = adapter("convbn").init(device="cpu")
    before = [s.clone() for s in m.layer.state_tensors()]
    t = dkt.SingleTrainer(adapter("convbn"), "sgd",
                          **{**COMMON, "num_epoch": 5, "learning_rate": 0.1})
    trained = t.train(img)
    acc["convbn_single"] = accuracy(trained, img)
    out["convbn_state_moved"] = any(
        not torch.allclose(a, b)
        for a, b in zip(trained.layer.state_tensors(), before))
    acc["convbn_adag"] = accuracy(dkt.ADAG(
        adapter("convbn"), "sgd", num_workers=8, communication_window=2,
        **{**COMMON, "num_epoch": 14, "learning_rate": 0.1}).train(img), img)
    t = dkt.SingleTrainer(adapter("transformer"), "adam",
                          **{**COMMON, "num_epoch": 10,
                             "learning_rate": 3e-3})
    acc["transformer_single"] = accuracy(t.train(seq), seq)
    out["transformer_history"] = t.get_averaged_history()
    acc["transformer_adag"] = accuracy(dkt.ADAG(
        adapter("transformer"), "adam", num_workers=8,
        communication_window=4,
        **{**COMMON, "num_epoch": 16, "learning_rate": 3e-3}).train(seq), seq)
    acc["lstm_single"] = accuracy(dkt.SingleTrainer(
        adapter("lstm"), "adam",
        **{**COMMON, "num_epoch": 10, "learning_rate": 3e-3}).train(seq), seq)
    t = dkt.AEASGD(adapter("dropout"), "sgd", num_workers=2, mode="async",
                   communication_window=4, rho=1.0,
                   **{**COMMON, "num_epoch": 3})
    trained = t.train(toy)
    acc["dropout_aeasgd_async"] = accuracy(trained, toy)
    out["async_state_dtypes"] = [str(s.dtype)
                                 for s in trained.layer.state_tensors()]

    # -- the ensemble's decorrelated members ---------------------------
    m = adapter("mlp")
    w0 = m.init(0, device="cpu").layer.params[0].detach().clone()
    w42 = m.init(42, device="cpu").layer.params[0].detach().clone()
    r1 = m.reinit(1, device="cpu").layer.params[0].detach().clone()
    r1b = m.reinit(1, device="cpu").layer.params[0].detach().clone()
    members = dkt.EnsembleTrainer(adapter("mlp"), "sgd", num_ensembles=8,
                                  **{**COMMON, "num_epoch": 1}).train(toy)
    out["ensemble"] = {
        "init_ignores_seed": bool(torch.equal(w0, w42)),
        "reinit_differs": not bool(torch.allclose(w0, r1)),
        "reinit_deterministic": bool(torch.equal(r1, r1b)),
        "members": len(members),
        "all_adapters": all(isinstance(x, KerasAdapter) for x in members),
        "members_differ": not bool(torch.allclose(
            members[0].layer.params[0], members[1].layer.params[0]))}

    # -- serde and the job runner --------------------------------------
    m = adapter("convbn", inputs["weights"]["convbn"]).init(device="cpu")
    blob = serde.serialize_model(m, to_numpy_variables(m))
    m2, variables = serde.deserialize_model(blob)
    m2.init(0, device="cpu")
    load_jax_variables(m2, variables)
    x = torch.from_numpy(img["features"][:16])
    with torch.no_grad():
        out["serde"] = (type(m2).__name__, m(x).numpy(), m2(x).numpy())
    npz = os.path.join(workdir, "toy.npz")
    np.savez(npz, **{k: toy[k] for k in ("features", "label",
                                          "label_onehot")})
    job = job_deployment.Job(
        "keras-job", adapter("mlp"),
        trainer_spec={"class": "SingleTrainer",
                      "kwargs": {k: v for k, v in COMMON.items()
                                 if k != "device"}},
        dataset_spec={"npz": npz})
    pkg, res = os.path.join(workdir, "k.job"), os.path.join(workdir, "k.res")
    with open(pkg, "wb") as f:
        f.write(job.package())
    job_runner.run_package(pkg, res, device="cpu")
    with open(res, "rb") as f:
        payload = serde.tree_from_bytes(f.read())
    rebuilt, variables = serde.deserialize_model(payload["model"])
    rebuilt.init(0, device="cpu")
    load_jax_variables(rebuilt, variables)
    out["job"] = (type(rebuilt).__name__, len(payload["history"]),
                  accuracy(rebuilt, toy))

    with open(os.path.join(workdir, "results.pkl"), "wb") as f:
        pickle.dump(out, f)
    return 0


if __name__ == "__main__":
    os.environ["KERAS_BACKEND"] = "torch"
    sys.exit(main(sys.argv[1]))
