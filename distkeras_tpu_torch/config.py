"""Config layer — the port of ``distkeras_tpu.config``: a ``RunConfig``
dataclass, the YAML file and a CLI, so one checked-in file reproduces a
whole benchmark table (``configs/bench_all.yaml``) or packages the same
run as a deployable ``Job``.

The file is read by the port's own reader of the YAML subset the configs
use (``utils._yaml``; the card's machine has no ``yaml``), which resolves
every scalar as ``yaml.safe_load`` does.  Models come from the port's
``models.zoo``, data from its ``data`` loaders, trainers from
``distkeras_tpu_torch.trainers``; they run on the card unless a device is
named (``device="cpu"``, ``--device cpu``).

YAML shape (one mapping per run; a top-level ``configs:`` list holds
several)::

    name: ADAG ConvNet/CIFAR-10
    trainer: ADAG                    # class in distkeras_tpu_torch.trainers
    model: convnet_cifar10           # factory in distkeras_tpu_torch.models.zoo
    model_kwargs: {num_classes: 10}
    dataset: load_cifar10            # loader in distkeras_tpu_torch.data
    dataset_kwargs: {n_train: 8192}
    onehot: 10                       # one-hot "label" -> "label_onehot"
    test_take: 1024                  # null -> skip accuracy eval
    trainer_kwargs: {num_workers: 8, batch_size: 64, num_epoch: 5}
    quick: {dataset_kwargs: {n_train: 2048}, trainer_kwargs: {num_epoch: 2}}

``num_workers: auto`` is 8 here, the cap the JAX package puts on its
device count: the port's sync engine steps its workers as views on one
card, so one card runs the reference examples' 8 workers (the JAX package
on a one-device TPU would resolve 1, on the 8-device CPU mesh 8).

``python -m distkeras_tpu_torch.config FILE [--quick] [--repeat N]
[--job OUT.job] [--device DEV]``.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Any, Optional

import numpy as np

from .obs import emit
from .utils import _yaml
from .utils.device import DeviceLike

_DEFAULT_TRAINER_KW = dict(loss="categorical_crossentropy",
                           features_col="features",
                           label_col="label_onehot")

#: what ``num_workers: auto`` resolves to: the JAX package's cap
#: (``min(8, devices)``) — the port steps its workers on one card
AUTO_WORKERS = 8


@dataclasses.dataclass
class RunConfig:
    """One benchmark/training run, fully reproducible from data."""

    name: str
    trainer: str = "SingleTrainer"
    model: str = "mlp_mnist"
    model_kwargs: dict = dataclasses.field(default_factory=dict)
    dataset: str = "load_mnist"
    dataset_kwargs: dict = dataclasses.field(default_factory=dict)
    onehot: Optional[int] = 10
    test_take: Optional[int] = 1024
    #: spill the train split to disk shards and stream it
    #: (``data.streaming.ShardedFileDataset``) instead of training from
    #: RAM.  An int is rows per shard; ``true`` uses the default size.
    streaming: Any = None
    trainer_kwargs: dict = dataclasses.field(default_factory=dict)
    quick: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict) -> "RunConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown RunConfig keys {sorted(unknown)} "
                             f"(known: {sorted(known)})")
        return cls(**d)

    def with_quick(self) -> "RunConfig":
        """Apply the config's ``quick`` overrides (smaller data / fewer
        epochs for smoke runs); dict fields merge, scalars replace."""
        if not self.quick:
            return self
        d = dataclasses.asdict(self)
        q = d.pop("quick")
        for k, v in q.items():
            if isinstance(v, dict) and isinstance(d.get(k), dict):
                d[k] = {**d[k], **v}
            else:
                d[k] = v
        return RunConfig(**d, quick={})


def load_file(path: str) -> list:
    """YAML file -> list of RunConfig (single mapping or ``configs:`` list)."""
    doc = _yaml.load_path(path)
    entries = doc["configs"] if isinstance(doc, dict) and "configs" in doc \
        else [doc]
    return [RunConfig.from_dict(e) for e in entries]


def _trainer_kwargs(cfg: RunConfig, device: DeviceLike) -> dict:
    kw = {**_DEFAULT_TRAINER_KW, **cfg.trainer_kwargs}
    if kw.get("num_workers") == "auto":
        kw["num_workers"] = AUTO_WORKERS
    if device is not None:
        kw["device"] = device
    return kw


def build(cfg: RunConfig, device: DeviceLike = None):
    """RunConfig -> (trainer, train_dataset, test_dataset_or_None); the
    trainer runs on ``device`` (the card unless one is named)."""
    from . import data, trainers
    from .data.transformers import OneHotTransformer
    from .models import zoo

    model = getattr(zoo, cfg.model)(**cfg.model_kwargs)
    train, test, _meta = getattr(data, cfg.dataset)(**cfg.dataset_kwargs)
    if cfg.onehot:
        enc = OneHotTransformer(int(cfg.onehot), "label", "label_onehot")
        train = enc.transform(train)
        test = enc.transform(test)
    test = test.take(int(cfg.test_take)) if cfg.test_take else None

    kw = _trainer_kwargs(cfg, device)
    trainer_cls = getattr(trainers, cfg.trainer)
    if cfg.streaming:
        import atexit
        import shutil
        import tempfile
        from .data.streaming import ShardedFileDataset
        if not issubclass(trainer_cls, (trainers.SingleTrainer,
                                        trainers.DistributedTrainer,
                                        trainers.SpmdTrainer)):
            # fail at build time with a clear message, not mid-train
            raise ValueError(
                f"streaming: trainer {cfg.trainer!r} has no "
                f"ShardedFileDataset path (supported: SingleTrainer, "
                f"SpmdTrainer and the distributed trainer family)")
        if isinstance(cfg.streaming, int) and \
                not isinstance(cfg.streaming, bool):
            rows = cfg.streaming
        else:
            # default shard size, capped so a distributed trainer gets at
            # least one shard per worker (partition == worker);
            # EnsembleTrainer sizes its workers from num_ensembles
            nw = int(kw.get("num_workers") or kw.get("num_ensembles") or 1)
            rows = min(4096, max(1, train.num_rows // max(1, nw)))
        spill_dir = tempfile.mkdtemp(prefix="dk_stream_")
        # the spill is run-scoped scratch: run() removes it eagerly;
        # atexit covers direct build() callers
        atexit.register(shutil.rmtree, spill_dir, ignore_errors=True)
        train = ShardedFileDataset.write(train, spill_dir,
                                         rows_per_shard=rows)

    return trainer_cls(model, **kw), train, test


def run(cfg: RunConfig, repeat: int = 1, device: DeviceLike = None) -> dict:
    """Build + train + evaluate; returns the measured row as a dict.

    ``repeat`` > 1 re-runs ``trainer.train()`` that many times on the
    SAME trainer and reports the MEDIAN samples/sec of the warm runs with
    the min–max spread (the first call is the cold one).  Rates come from
    the trainer's epoch records (``samples_per_sec``: device time of the
    call's last epoch); a one-epoch call reports its samples over its
    wall instead ("incl. compile")."""
    from .evaluators import AccuracyEvaluator
    from .predictors import ModelPredictor

    trainer, train, test = build(cfg, device)
    rates, walls = [], []
    model = None
    try:
        for _ in range(max(1, int(repeat))):
            n0 = len(trainer.metrics.records)
            h0 = len(trainer.get_history())
            t0 = time.time()
            model = trainer.train(train)
            wall = time.time() - t0
            walls.append(wall)
            recs = list(trainer.metrics.records)[n0:]  # deque: no slicing
            epochs = [r for r in recs if r["event"] == "epoch"]
            if len(epochs) > 1:
                # last epoch of the call: past the first-call warm-up
                rates.append((epochs[-1]["samples_per_sec"], "last epoch"))
            else:
                # THIS call's history only: the trainer accumulates
                # history across train() calls
                samples = sum(np.size(h)
                              for h in trainer.get_history()[h0:]) \
                    * trainer.batch_size
                rates.append((samples / wall, "incl. compile"))
    finally:
        if cfg.streaming:  # the spill is scratch; free the disk now
            import shutil
            shutil.rmtree(train.directory, ignore_errors=True)
    if isinstance(model, list):  # EnsembleTrainer
        model = model[0]
    # repeats after the first are warm: median over those when there
    # are any, else the single measurement; spread over >= 2 warm runs
    vals = [r for r, _ in (rates[1:] if len(rates) > 1 else rates)]
    if len(rates) == 1:
        note = rates[-1][1]
    elif len(vals) == 1:
        note = "single warm run, cold excluded"
    else:
        note = f"median of {len(vals)} warm runs"
    spread = (float(np.min(vals)), float(np.max(vals))) \
        if len(vals) > 1 else None
    acc = None
    if test is not None:
        pred = ModelPredictor(model, "features").predict(test)
        acc = AccuracyEvaluator("prediction", "label").evaluate(pred)
    return {"name": cfg.name,
            "samples_per_sec": float(np.median(vals)),
            "spread": spread,  # (min, max) over warm runs; None if < 2
            "rates": [float(r) for r, _ in rates],  # per-call, run order
            "note": note, "accuracy": acc,
            "wall_seconds": float(np.sum(walls))}


def to_job(cfg: RunConfig, punchcard=None):
    """RunConfig -> deployable ``job_deployment.Job`` (same spec, the
    JAX package's bytes)."""
    from .job_deployment import Job
    from .models import zoo

    model = getattr(zoo, cfg.model)(**cfg.model_kwargs)
    kw = {**_DEFAULT_TRAINER_KW, **cfg.trainer_kwargs}
    return Job(cfg.name.replace(" ", "-").replace("/", "-"), model,
               trainer_spec={"class": cfg.trainer, "kwargs": kw},
               dataset_spec={"loader": cfg.dataset,
                             "kwargs": cfg.dataset_kwargs},
               punchcard=punchcard)


def format_row(row: dict) -> str:
    """One table row of ``main``'s output."""
    acc = f"{row['accuracy']:.3f}" if row["accuracy"] is not None else "—"
    if row["spread"] is None:  # < 2 warm runs: no meaningful spread
        spread = "—"
    else:
        lo, hi = row["spread"]
        spread = f"{lo:,.0f}–{hi:,.0f}"
    return (f"| {row['name']} | {row['samples_per_sec']:,.0f} "
            f"({row['note']}) | {spread} | {acc} "
            f"| {row['wall_seconds']:.1f}s |")


TABLE_HEADER = ("| config | samples/sec/chip | spread | accuracy | wall |",
                "|---|---|---|---|---|")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="run every config in a YAML file, print a table")
    ap.add_argument("file")
    ap.add_argument("--quick", action="store_true",
                    help="apply each config's quick: overrides")
    ap.add_argument("--repeat", type=int, default=1, metavar="N",
                    help="train() calls per config; N>1 reports the "
                         "median of the warm runs with min-max spread")
    ap.add_argument("--job", metavar="OUT",
                    help="package the (single) config as a Job file "
                         "instead of running it")
    ap.add_argument("--device", default=None, metavar="DEV",
                    help="torch device to train on (default: the card)")
    args = ap.parse_args(argv)

    cfgs = load_file(args.file)
    if args.quick:
        cfgs = [c.with_quick() for c in cfgs]
    if args.job:
        if len(cfgs) != 1:
            emit("--job needs a file with exactly one config", err=True)
            return 2
        with open(args.job, "wb") as f:
            f.write(to_job(cfgs[0]).package())
        emit(f"wrote job package {args.job}")
        return 0

    for line in TABLE_HEADER:
        emit(line)
    for cfg in cfgs:
        emit(format_row(run(cfg, repeat=args.repeat, device=args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
