"""Job-package executor: ``python -m distkeras_tpu_torch.job_runner PKG
OUT [--device DEV]`` — the port of ``distkeras_tpu.job_runner``.

Loads a package (the JAX package's or the port's: the bytes are the
same), rebuilds model + trainer + dataset, trains on ``DEV`` (the card
unless one is named), and writes ``{"model", "history",
"training_time"}`` to OUT in the JAX package's result format: the model
blob holds the JAX-shaped ``variables`` tree.  Its last stdout line is a
``kernel_launches`` record of this process's K1–K3 launch counts, which
``Job.run`` folds into its own.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from . import trainers as trainers_mod
from .data import datasets as datasets_mod
from .data.dataset import Dataset
from .obs import emit
from .utils import serde
from .utils.device import DeviceLike


def _load_dataset(spec: dict) -> Dataset:
    if "loader" in spec:
        loader = getattr(datasets_mod, spec["loader"])
        train, _test, _meta = loader(**spec.get("kwargs", {}))
        return train
    if "npz" in spec:
        with np.load(spec["npz"]) as d:
            return Dataset({k: d[k] for k in d.files})
    raise ValueError(f"unrecognized dataset spec {spec!r}")


def run_package(pkg_path: str, out_path: str,
                device: DeviceLike = None) -> None:
    from .utils.weights import to_numpy_variables
    with open(pkg_path, "rb") as f:
        pkg = serde.tree_from_bytes(f.read())

    # serde's dispatch: native Model configs and KerasAdapter configs
    model = serde.model_from_config(json.loads(pkg["model_config"]))
    cls = getattr(trainers_mod, pkg["trainer"]["class"])
    kwargs = dict(pkg["trainer"].get("kwargs", {}))
    if device is not None:
        kwargs["device"] = device
    trainer = cls(model, **kwargs)
    ds = _load_dataset(pkg["dataset"])
    trained = trainer.train(ds, shuffle=pkg.get("shuffle", False))
    if isinstance(trained, list):  # EnsembleTrainer returns a list
        trained = trained[0]

    payload = {
        "model": serde.serialize_model(trained, to_numpy_variables(trained)),
        "history": [np.asarray(h) for h in trainer.get_history()],
        "training_time": trainer.get_training_time(),
    }
    with open(out_path, "wb") as f:
        f.write(serde.tree_to_bytes(payload))


def main(argv=None) -> int:
    from .job_deployment import LAUNCH_EVENT
    from .ops.flash_attention import launch_counts
    ap = argparse.ArgumentParser(
        prog="python -m distkeras_tpu_torch.job_runner",
        description="run a packaged training job")
    ap.add_argument("pkg")
    ap.add_argument("out")
    ap.add_argument("--device", default=None, metavar="DEV",
                    help="torch device to train on (default: the card)")
    args = ap.parse_args(argv)
    run_package(args.pkg, args.out, args.device)
    emit(json.dumps({"event": LAUNCH_EVENT, "counts": launch_counts()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
