"""Remote job deployment — the port of ``distkeras_tpu.job_deployment``.

A job package is the JAX package's msgpack blob (model config + trainer
spec + dataset spec, written by the port's codec, byte for byte),
executed by ``python -m distkeras_tpu_torch.job_runner`` on the target
host via ssh/scp, or in a local subprocess when the punchcard names no
host; the trained model blob is fetched back and loaded onto a device.
A package of either package's ``Job`` runs under either runner.

The runner's stdout ends with one ``kernel_launches`` record, its K1–K3
launch counts; ``Job.run`` folds it into this process's counts
(``ops.flash_attention.add_launches``), as the async runner folds a
worker process's, and echoes every other line.
"""

from __future__ import annotations

import json
import os
import shlex
import subprocess
import sys
import tempfile
from typing import Optional

from .obs import emit
from .utils import serde
from .utils.device import DeviceLike, default_device

#: the ``event`` of the runner's launch-count record on its stdout
LAUNCH_EVENT = "kernel_launches"


class Punchcard:
    """Credentials/targets file (parity: reference ``Punchcard``): JSON with
    ``host``, ``username``, ``key_file`` (optional), ``remote_dir``
    (optional), ``python`` (optional remote interpreter)."""

    def __init__(self, path: str):
        with open(path) as f:
            d = json.load(f)
        self.host: Optional[str] = d.get("host")
        self.username: Optional[str] = d.get("username")
        self.key_file: Optional[str] = d.get("key_file")
        self.remote_dir: str = d.get("remote_dir", "/tmp")
        self.python: str = d.get("python", "python3")

    @property
    def target(self) -> str:
        return f"{self.username}@{self.host}" if self.username else self.host


class Job:
    """A packaged training job (parity: reference ``Job``).

    ``trainer_spec``: ``{"class": "ADAG", "kwargs": {...}}`` — any trainer
    of ``distkeras_tpu_torch.trainers``.  ``dataset_spec``: either
    ``{"loader": "load_mnist", "kwargs": {...}}`` (a loader of
    ``distkeras_tpu_torch.data``) or ``{"npz": path, ...}``.
    """

    def __init__(self, job_name: str, model, trainer_spec: dict,
                 dataset_spec: dict, punchcard: Optional[Punchcard] = None,
                 shuffle: bool = False):
        self.job_name = job_name
        self.model = model
        self.trainer_spec = trainer_spec
        self.dataset_spec = dataset_spec
        self.punchcard = punchcard
        self.shuffle = shuffle
        self.result_model = None
        self.result_history = None
        self.result_training_time: Optional[float] = None

    # -- packaging ----------------------------------------------------------
    def package(self) -> bytes:
        return serde.tree_to_bytes({
            "job_name": self.job_name,
            "model_config": json.dumps(self.model.config()),
            "trainer": self.trainer_spec,
            "dataset": self.dataset_spec,
            "shuffle": bool(self.shuffle),
        })

    # -- execution ----------------------------------------------------------
    def run(self, timeout: Optional[float] = 3600,
            device: DeviceLike = None):
        """Ship, execute, fetch.  The runner trains on ``device`` (the
        target's card unless one is named) and the trained model is
        loaded onto it here; returns the model (also kept on
        ``self.result_model``)."""
        dev = default_device(device)
        with tempfile.TemporaryDirectory() as td:
            pkg = os.path.join(td, f"{self.job_name}.job")
            out = os.path.join(td, f"{self.job_name}.result")
            with open(pkg, "wb") as f:
                f.write(self.package())
            if self.punchcard is None or self.punchcard.host is None:
                self._run_local(pkg, out, timeout, device)
            else:
                self._run_ssh(pkg, out, timeout, device)
            with open(out, "rb") as f:
                payload = serde.tree_from_bytes(f.read())
        from .utils.weights import load_jax_variables
        model, variables = serde.deserialize_model(payload["model"])
        model.init(0, device=dev)
        load_jax_variables(model, variables)
        self.result_model = model
        self.result_history = payload.get("history")
        self.result_training_time = payload.get("training_time")
        return model

    @staticmethod
    def _runner_args(device: DeviceLike) -> list:
        return [] if device is None else ["--device", str(device)]

    @staticmethod
    def _fold_output(stdout: str) -> None:
        """Echo the runner's stdout, folding its launch-count record into
        this process's counts."""
        from .ops.flash_attention import add_launches
        for line in stdout.splitlines():
            try:
                rec = json.loads(line)
            except ValueError:
                rec = None
            if isinstance(rec, dict) and rec.get("event") == LAUNCH_EVENT:
                add_launches(rec.get("counts") or {})
            else:
                emit(line)

    def _run_local(self, pkg: str, out: str, timeout, device) -> None:
        env = dict(os.environ)
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        res = subprocess.run(
            [sys.executable, "-m", "distkeras_tpu_torch.job_runner", pkg,
             out, *self._runner_args(device)],
            check=True, timeout=timeout, env=env, stdout=subprocess.PIPE,
            text=True)
        self._fold_output(res.stdout)

    def _run_ssh(self, pkg: str, out: str, timeout, device) -> None:
        pc = self.punchcard
        ssh_base = ["ssh"]
        scp_base = ["scp"]
        if pc.key_file:
            ssh_base += ["-i", pc.key_file]
            scp_base += ["-i", pc.key_file]
        rdir = pc.remote_dir.rstrip("/")
        rpkg = f"{rdir}/{os.path.basename(pkg)}"
        rout = f"{rdir}/{os.path.basename(out)}"
        subprocess.run([*scp_base, pkg, f"{pc.target}:{rpkg}"],
                       check=True, timeout=timeout)
        remote_cmd = " ".join([
            shlex.quote(pc.python), "-m", "distkeras_tpu_torch.job_runner",
            shlex.quote(rpkg), shlex.quote(rout),
            *(shlex.quote(a) for a in self._runner_args(device))])
        res = subprocess.run([*ssh_base, pc.target, remote_cmd],
                             check=True, timeout=timeout,
                             stdout=subprocess.PIPE, text=True)
        self._fold_output(res.stdout)
        subprocess.run([*scp_base, f"{pc.target}:{rout}", out],
                       check=True, timeout=timeout)
