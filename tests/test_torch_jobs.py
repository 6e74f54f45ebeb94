"""The port's job deployment (``distkeras_tpu_torch.job_deployment``,
``job_runner``) against the JAX package's, on the CPU.

* ``Job.package()`` writes the JAX package's bytes (a native model and
  the yaml's flash LM config).
* A job packaged by the JAX package runs under the port's runner
  (``--device cpu``) and its result blob loads in the JAX
  ``deserialize_model``; a job packaged by the port runs under the JAX
  runner and its result loads in the port's.
* Mirrors ``tests/test_job_deployment.py``: the Punchcard, the local
  round trip through a subprocess and the ssh path through PATH shims
  for ``ssh``/``scp`` — the two runner processes this file spawns.
* The runner's launch-count record folds into the parent's counts.
"""

import importlib
import json
import os
import shlex
import sys

import numpy as np
import pytest
import torch

import distkeras_tpu as dk
from distkeras_tpu import job_deployment as jjobs
from distkeras_tpu import job_runner as jrunner
from distkeras_tpu.models.layers import Dense as JaxDense
from distkeras_tpu.models.layers import Sequential as JaxSequential
from distkeras_tpu.utils import serde as jserde

import distkeras_tpu_torch as dkt
from distkeras_tpu_torch import config as pcfg
from distkeras_tpu_torch import job_runner
from distkeras_tpu_torch.evaluators import AccuracyEvaluator
from distkeras_tpu_torch.job_deployment import LAUNCH_EVENT, Job, Punchcard
from distkeras_tpu_torch.models import Model
from distkeras_tpu_torch.utils import load_jax_variables, serde
from tests.test_trainers_sync import toy_problem

fa = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")

if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, os.cpu_count()
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINER = {"class": "SingleTrainer",
           "kwargs": {"worker_optimizer": "sgd",
                      "loss": "categorical_crossentropy",
                      "features_col": "features",
                      "label_col": "label_onehot",
                      "num_epoch": 3, "batch_size": 32,
                      "learning_rate": 0.05}}


def _jax_model():
    return dk.Model(JaxSequential([JaxDense(16, "relu"),
                                   JaxDense(3, "softmax")]),
                    input_shape=(10,))


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    ds = toy_problem(n=512)
    npz = str(tmp_path_factory.mktemp("toy") / "data.npz")
    np.savez(npz, features=ds["features"], label=ds["label"],
             label_onehot=ds["label_onehot"])
    return ds, npz


def _jobs(npz, name="toy-job", punchcard=None, jpunchcard=None):
    """The same job in both packages: (port Job, JAX Job)."""
    jm = _jax_model()
    spec = {"npz": npz}
    return (Job(name, Model.from_config(jm.config()), TRAINER, spec,
                punchcard=punchcard),
            jjobs.Job(name, jm, TRAINER, spec, punchcard=jpunchcard))


def _port_accuracy(model, ds):
    pred = dkt.ModelPredictor(model, "features").predict(
        dkt.Dataset({"features": np.asarray(ds["features"])}))
    return AccuracyEvaluator("prediction", "label").evaluate(
        pred.with_column("label", np.asarray(ds["label"])))


def _jax_accuracy(model, ds):
    pred = dk.ModelPredictor(model, "features").predict(ds)
    return dk.AccuracyEvaluator("prediction", "label").evaluate(pred)


def test_punchcard_parses(tmp_path):
    p = tmp_path / "punchcard.json"
    p.write_text(json.dumps({"host": "tpu-vm", "username": "ml",
                             "key_file": "/k", "remote_dir": "/jobs"}))
    pc = Punchcard(str(p))
    assert pc.target == "ml@tpu-vm"
    assert pc.remote_dir == "/jobs" and pc.python == "python3"
    p.write_text(json.dumps({"host": "h"}))
    assert Punchcard(str(p)).target == "h"


def test_package_bytes_equal_across_packages(toy):
    from distkeras_tpu import config as jcfg
    mine, ref = _jobs(toy[1])
    assert mine.package() == ref.package()
    yaml_path = os.path.join(ROOT, "configs", "bench_all.yaml")
    for a, b in zip(pcfg.load_file(yaml_path), jcfg.load_file(yaml_path)):
        assert pcfg.to_job(a).package() == jcfg.to_job(b).package(), a.name


@pytest.fixture(scope="module")
def local_run(toy):
    """The local round trip: a subprocess runs the port's runner on the
    CPU (``Job.run(device="cpu")``)."""
    job, _ = _jobs(toy[1])
    model = job.run(timeout=600, device="cpu")
    return job, model


def test_local_round_trip(toy, local_run):
    job, model = local_run
    assert job.result_model is model and model.device == torch.device("cpu")
    assert len(job.result_history) == 3
    assert all(np.isfinite(np.asarray(h)).all() for h in job.result_history)
    assert job.result_training_time > 0
    assert _port_accuracy(model, toy[0]) > 0.6


def test_jax_job_runs_under_the_port_runner(toy, tmp_path, capsys):
    """The JAX package's bytes, the port's runner on the CPU; its result
    loads in the JAX ``deserialize_model`` and predicts; the runner's
    stdout ends with its launch-count record (no launch on the CPU)."""
    _, jjob = _jobs(toy[1])
    pkg, out = tmp_path / "j.job", tmp_path / "j.result"
    pkg.write_bytes(jjob.package())
    assert job_runner.main([str(pkg), str(out), "--device", "cpu"]) == 0
    last = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert last["event"] == LAUNCH_EVENT
    assert set(last["counts"]) == {"wrappers", "kernels"}
    payload = jserde.tree_from_bytes(out.read_bytes())
    assert set(payload) == {"model", "history", "training_time"}
    assert len(payload["history"]) == 3
    model, variables = jserde.deserialize_model(payload["model"])
    model.variables = variables
    assert _jax_accuracy(model, toy[0]) > 0.6


def test_port_job_runs_under_the_jax_runner(toy, tmp_path):
    """The reverse: the port's package, the JAX runner; the result blob
    loads in the port's ``deserialize_model`` onto the CPU."""
    job, _ = _jobs(toy[1])
    pkg, out = tmp_path / "p.job", tmp_path / "p.result"
    pkg.write_bytes(job.package())
    jrunner.run_package(str(pkg), str(out))
    payload = serde.tree_from_bytes(out.read_bytes())
    model, variables = serde.deserialize_model(payload["model"])
    model.init(0, device="cpu")
    load_jax_variables(model, variables)
    assert _port_accuracy(model, toy[0]) > 0.6


def test_the_launch_record_folds_into_the_parent(capsys):
    """``Job`` folds the runner's ``kernel_launches`` record into this
    process's counts and echoes every other line."""
    fa.reset_launches()
    rec = {"event": LAUNCH_EVENT,
           "counts": {"wrappers": {"flash_fwd_cuda": 3,
                                   "flash_bwd_dq_cuda": 2},
                      "kernels": [["flash_fwd", "bfloat16", 32, 3]]}}
    try:
        Job._fold_output(f"training\n{json.dumps(rec)}\n")
        assert fa.flash_fwd_cuda.launches == 3
        assert fa.flash_bwd_dq_cuda.launches == 2
        assert fa.KERNEL_LAUNCHES[("flash_fwd", "bfloat16", 32)] == 3
    finally:
        fa.reset_launches()
    assert capsys.readouterr().out == "training\n"


def test_job_ssh_path_via_shim(toy, tmp_path, monkeypatch):
    """The SSH deployment leg end to end: fake ``ssh``/``scp`` shims on
    PATH execute locally, so the exact command lines ``Job.run()`` builds
    — scp ship, remote runner invocation with ``--device``, scp fetch,
    ``-i`` key plumbing — run without a network."""
    remote = tmp_path / "remote"
    remote.mkdir()
    log = tmp_path / "calls.log"
    key = tmp_path / "id_fake"
    key.write_text("not a real key")
    bindir = tmp_path / "bin"
    bindir.mkdir()
    (bindir / "scp").write_text(f"""#!/bin/bash
echo "scp $@" >> {shlex.quote(str(log))}
args=()
while [ $# -gt 0 ]; do
  case "$1" in
    -i) shift 2;;
    *) args+=("$1"); shift;;
  esac
done
src="${{args[0]#tester@fakehost:}}"
dst="${{args[1]#tester@fakehost:}}"
exec cp "$src" "$dst"
""")
    (bindir / "ssh").write_text(f"""#!/bin/bash
echo "ssh $@" >> {shlex.quote(str(log))}
args=()
while [ $# -gt 0 ]; do
  case "$1" in
    -i) shift 2;;
    *) args+=("$1"); shift;;
  esac
done
export PYTHONPATH={shlex.quote(ROOT)}:$PYTHONPATH
exec bash -c "${{args[@]:1}}"
""")
    for f in ("ssh", "scp"):
        os.chmod(bindir / f, 0o755)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    pc_path = tmp_path / "punchcard.json"
    pc_path.write_text(json.dumps({
        "host": "fakehost", "username": "tester", "key_file": str(key),
        "remote_dir": str(remote), "python": sys.executable}))

    job, _ = _jobs(toy[1], name="ssh-job",
                   punchcard=Punchcard(str(pc_path)))
    model = job.run(timeout=600, device="cpu")
    assert len(job.result_history) == 3
    assert _port_accuracy(model, toy[0]) > 0.6

    calls = log.read_text().splitlines()
    assert len(calls) == 3, calls
    assert calls[0].startswith("scp -i ") and \
        calls[0].endswith(f"tester@fakehost:{remote}/ssh-job.job")
    assert calls[1].startswith("ssh -i ") and "tester@fakehost" in calls[1] \
        and "distkeras_tpu_torch.job_runner" in calls[1] \
        and f"{remote}/ssh-job.job" in calls[1] \
        and f"{remote}/ssh-job.result" in calls[1] \
        and calls[1].endswith("--device cpu")
    assert calls[2].startswith("scp -i ") and \
        f"tester@fakehost:{remote}/ssh-job.result" in calls[2]
    assert (remote / "ssh-job.job").exists()
    assert (remote / "ssh-job.result").exists()


def test_job_run_needs_the_card_unless_a_device_is_named(toy):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    job, _ = _jobs(toy[1])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        job.run(timeout=60)
