"""Benchmarks of the port on one card — the port of the JAX package's
``bench.py`` rows.

    python -m distkeras_tpu_torch.bench               # ResNet-20 samples/s
    python -m distkeras_tpu_torch.bench --mnist       # time to 99% MNIST
    python -m distkeras_tpu_torch.bench --continual   # train + deploy loop
    python -m distkeras_tpu_torch.bench --scenario smoke   # open loop

Prints ONE JSON row on stdout (or writes it to ``--out PATH``).

Default: ``SingleTrainer(zoo.resnet20(width=16), "sgd", lr 0.1,
compute_dtype="bfloat16")`` at batch 1024 on the JAX bench's numpy data
(``default_rng(0)``: uniform 32×32×3 images, one-hot labels), 32 steps
an epoch, 2 warm-up and 4 timed epochs; the value is the timed epochs'
samples over their seconds (the trainer's CUDA-event epoch times, on the
device's timeline).

``--mnist``: ``SingleTrainer(zoo.mlp_mnist(), "sgd"...)`` in bf16 at
batch 128 on the 16,384-row MNIST surrogate (``load_mnist(n_train=
16384)``), trained one epoch per ``train()`` call, each continuing from
the weights the last one left (sgd keeps no state and the MLP draws no
random numbers, so k calls are the k-epoch run); the value is the
summed wall seconds of the calls up to the first epoch after which
``AccuracyEvaluator`` on the test split reads 0.99.

``--continual`` (``continual_row``, the JAX package's ``bench_continual``):
``ContinualTrainer`` over ``synthetic_lm_feed`` with a live f32
``DecodeEngine`` of the same model as its deploy target and an abrupt
drift at interval ``CONTINUAL["drift_interval"]``; the model is the
``scripts/mfu.py`` flash LM probe (``PROBE``), trained in bf16.

``--scenario NAME`` (``scenario_row``, the JAX package's
``bench_scenario``): the named ``SCENARIO_TRACES`` (comma-separated, or
``all``) fired open-loop at a ``ServeRouter`` fleet of the probe in f32
shaped by ``SCENARIO_FLEET``, under ``OBS_BASELINE.json``'s alert rules
and, where the scenario says so, the autoscaler.  The JAX package's
scenario model (``SCENARIO_MODEL``) and its other scenario configs are
kept here as data.

The rows name the card and its power limit (nvidia-smi).  No row writes a
file unless ``--out`` names one.  Without a card they raise: the entry
points run on ``cuda``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
from typing import Optional

import numpy as np
import torch

from .continual import ContinualConfig, ContinualTrainer, synthetic_lm_feed
from .data import Dataset, load_mnist
from .evaluators import AccuracyEvaluator
from .models import zoo
from .obs import Registry, emit, snapshot_quantile
from .predictors import ModelPredictor
from .scenario import (AutoscalePolicy, AutoScaler, LengthModel, PrefixMix,
                       ScenarioRunner, SLOTarget, diurnal_trace,
                       poisson_trace, spike_trace)
from .serve import (DecodeEngine, RouterConfig, ServeClient, ServeConfig,
                    ServeRouter, ServeServer)
from .trainers import SingleTrainer
from .utils.device import default_device

BATCH = 1024
WIDTH = 16
LEARNING_RATE = 0.1
STEPS_PER_EPOCH = 32
WARMUP_EPOCHS = 2
TIMED_EPOCHS = 4

MNIST_ROWS = 16384
MNIST_BATCH = 128
MNIST_TARGET = 0.99
MNIST_MAX_EPOCHS = 10


def card() -> dict:
    """The card's name (torch) and name and power limit (nvidia-smi)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    return {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}


def resnet20_data(rows: int) -> Dataset:
    """The headline config's numpy data (the JAX package's
    ``bench.py:main``): uniform 32×32×3 images and one-hot labels from
    ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 10, size=rows)
    return Dataset({
        "features": rng.random((rows, 32, 32, 3), dtype=np.float32),
        "label": np.eye(10, dtype=np.float32)[labels],
    })


def resnet20_trainer(epochs: int, device=None, **overrides) -> SingleTrainer:
    """The headline config's trainer: ``resnet20(width=WIDTH)``, sgd at
    ``LEARNING_RATE``, bf16, batch ``BATCH``; ``overrides`` replace any of
    the last three (or add other ``SingleTrainer`` arguments)."""
    kw = dict(batch_size=BATCH, learning_rate=LEARNING_RATE,
              compute_dtype="bfloat16")
    kw.update(overrides)
    return SingleTrainer(zoo.resnet20(width=WIDTH), "sgd",
                         "categorical_crossentropy", num_epoch=epochs,
                         device=device, **kw)


def resnet20_row(device=None) -> dict:
    """The headline config's row: samples/s per chip over the timed
    epochs."""
    trainer = resnet20_trainer(WARMUP_EPOCHS + TIMED_EPOCHS, device)
    trainer.train(resnet20_data(STEPS_PER_EPOCH * BATCH))
    epochs = [r for r in trainer.metrics.records if r["event"] == "epoch"]
    seconds = [r["epoch_seconds"] for r in epochs[WARMUP_EPOCHS:]]
    samples = STEPS_PER_EPOCH * BATCH * len(seconds)
    losses = trainer.get_averaged_history()
    return {"metric": "samples/sec/chip (CIFAR-10 ResNet-20)",
            "value": samples / sum(seconds), "unit": "samples/s",
            "config": {"model": f"resnet20(width={WIDTH})",
                       "batch_size": BATCH,
                       "steps_per_epoch": STEPS_PER_EPOCH,
                       "warmup_epochs": WARMUP_EPOCHS,
                       "timed_epochs": TIMED_EPOCHS, "optimizer": "sgd",
                       "learning_rate": LEARNING_RATE,
                       "compute_dtype": "bfloat16"},
            "timed_epoch_seconds": seconds,
            "step_ms": 1e3 * sum(seconds) / (STEPS_PER_EPOCH * len(seconds)),
            "epoch_mean_loss": losses.tolist(),
            "train_wall_s": trainer.get_training_time()}


def mnist_row(device=None) -> dict:
    """Time to ``MNIST_TARGET`` test accuracy: one epoch per ``train()``,
    the test split evaluated after each; the value is the summed training
    wall seconds up to the first epoch that reaches it."""
    train, test, meta = load_mnist(n_train=MNIST_ROWS)
    trainer = SingleTrainer(
        zoo.mlp_mnist(), "sgd", "sparse_categorical_crossentropy",
        num_epoch=1, batch_size=MNIST_BATCH, learning_rate=0.1,
        compute_dtype="bfloat16", device=device)
    model, wall, checks = trainer.model, 0.0, []
    for epoch in range(1, MNIST_MAX_EPOCHS + 1):
        trainer.train(train)
        # later calls continue from these weights (sgd has no state)
        model.init = lambda seed=0, device=None: model
        wall += trainer.get_training_time()
        acc = AccuracyEvaluator().evaluate(
            ModelPredictor(model).predict(test))
        checks.append({"epochs": epoch, "test_accuracy": acc,
                       "train_wall_s": wall,
                       "epoch_seconds": [
                           r for r in trainer.metrics.records
                           if r["event"] == "epoch"][-1]["epoch_seconds"]})
        if acc >= MNIST_TARGET:
            break
    reached = checks[-1]["test_accuracy"] >= MNIST_TARGET
    return {"metric": "time-to-99% MNIST accuracy (SingleTrainer MLP)",
            "value": wall if reached else None,
            "unit": "s", "reached": reached, "epochs": checks[-1]["epochs"],
            "config": {"model": "mlp_mnist(hidden=500)", "rows": MNIST_ROWS,
                       "batch_size": MNIST_BATCH, "optimizer": "sgd",
                       "learning_rate": 0.1, "compute_dtype": "bfloat16",
                       "synthetic": meta["synthetic"],
                       "target": MNIST_TARGET},
            "checks": checks}


# ---------------------------------------------------------------------------
# continual learning: train forever, deploy drift-gated checkpoints
# ---------------------------------------------------------------------------

#: the ``scripts/mfu.py`` flash LM probe, the model the continual and
#: scenario rows run on the card
PROBE = dict(vocab_size=4000, dim=512, num_heads=8, num_blocks=4,
             seq_len=512, attention_impl="flash")
#: the JAX package's ``bench_continual`` cadence: 16 intervals of 4
#: windows of 4 batches of 16, rolling history 3 (deploys from 2
#: intervals on), adam at lr 1e-2, an abrupt drift at interval 10, and a
#: deploy-target engine of 2 slots answering up to 8 new tokens
CONTINUAL = dict(intervals=16, snapshot_every=4, window=4, batch=16,
                 history=3, min_history=2, drift_interval=10, lr=1e-2,
                 slots=2, max_new=8)
SCE = "sparse_categorical_crossentropy"


def continual_parts(model_cfg=None, device=None, compute_dtype="bfloat16",
                    checkpoint_dir=None, registry=None, deploy=True,
                    **overrides):
    """The continual loop's pieces: ``(trainer, engine, feed, c)``.  A
    live f32 ``DecodeEngine`` of the model (weights from seed 0, warmed
    and started; None when ``deploy`` is False) is the trainer's deploy
    target, both on ``registry``; ``feed(offset=0)`` builds the drifting
    ``synthetic_lm_feed`` (seed 0, abrupt drift at interval
    ``c["drift_interval"]``, None for none) fast-forwarded by ``offset``
    batches; ``c`` is ``CONTINUAL`` with ``overrides``."""
    c = dict(CONTINUAL, **overrides)
    mc = dict(PROBE if model_cfg is None else model_cfg)
    dev = default_device(device)
    reg = registry if registry is not None else Registry()
    engine = None
    if deploy:
        engine = DecodeEngine(
            zoo.gpt_lm(**mc).init(0, device=dev),
            ServeConfig(slots=c["slots"], max_new_tokens=c["max_new"]),
            registry=reg, device=dev).warmup()
        engine.start()
    cfg = ContinualConfig(batch_size=c["batch"], window_steps=c["window"],
                          snapshot_every=c["snapshot_every"],
                          history=c["history"],
                          min_history=c["min_history"])
    # the deploy gate runs on the built-in within-run thresholds
    # (baseline=None), as the JAX bench's does
    trainer = ContinualTrainer(zoo.gpt_lm(**mc), "adam", SCE, config=cfg,
                               learning_rate=c["lr"], registry=reg,
                               checkpoint_dir=checkpoint_dir,
                               deploy_to=engine,
                               compute_dtype=compute_dtype, device=dev)
    per_interval = c["snapshot_every"] * c["window"]
    drift_after = None if c["drift_interval"] is None else \
        int(c["drift_interval"]) * per_interval

    def feed(offset: int = 0):
        f = synthetic_lm_feed(mc["vocab_size"], mc["seq_len"], c["batch"],
                              seed=0, drift_after=drift_after)
        for _ in range(int(offset)):
            next(f)
        return f

    return trainer, engine, feed, c


def continual_summary(snap: dict, wall: float, intervals: int) -> dict:
    """The JAX ``bench_continual`` row's numbers from the shared
    registry's snapshot and the run's wall seconds."""
    def _c(name):
        return snap.get(name, {}).get("value", 0.0)

    return {
        "intervals": intervals,
        "windows": _c("continual.windows"),
        "samples_per_sec": _c("continual.samples") / wall,
        "deploys": _c("continual.deploys"),
        "deploys_rejected": _c("continual.deploys_rejected"),
        "rejected_dirty": _c("continual.rejected_dirty"),
        "rejected_warmup": _c("continual.rejected_warmup"),
        "deploy_errors": _c("continual.deploy_errors"),
        "verdicts": {k: _c(f"continual.verdicts_{k}")
                     for k in ("stable", "step", "trend")},
        "stream_lag_ms_p50": snapshot_quantile(
            snap["continual.stream_lag_seconds"], 0.5) * 1e3,
        "window_ms_p50": snapshot_quantile(
            snap["continual.window_seconds"], 0.5) * 1e3,
        "jit_retraces": snap["jit.retraces"]["value"],
        "promotions": _c("serve.promotions"),
    }


def continual_row() -> dict:
    """One bounded continual run (``CONTINUAL``) of the probe on the
    card: the trainer deploys drift-clean checkpoints into the live
    engine; the row holds deploy/rejection counts, the verdict tally,
    stream-lag and window-wall p50s and ``jit.retraces``."""
    trainer, engine, feed, c = continual_parts()
    t0 = time.perf_counter()
    try:
        trainer.run(feed(), intervals=c["intervals"])
    finally:
        engine.stop()
    wall = time.perf_counter() - t0
    return {"metric": f"continual train+deploy loop (gpt_lm d{PROBE['dim']} "
                      f"T{PROBE['seq_len']}, {c['intervals']} intervals)",
            "mode": "continual", "config": {"model": PROBE, **c},
            **continual_summary(trainer.registry.snapshot(), wall,
                                c["intervals"]),
            "verdict_log": trainer.gate.history_log(), "wall_s": wall}


# ---------------------------------------------------------------------------
# the scenario harness: open-loop traffic at a router fleet
# ---------------------------------------------------------------------------

#: the JAX package's scenario configs (its ``bench.py``), kept as data.
#: ``SCENARIO_MODEL`` is the JAX bench's fleet model; the port's row runs
#: the probe (``PROBE``) in its place.  slots=1 keeps per-engine service
#: bounded so a busy phase saturates a one-engine fleet and the
#: autoscaler has something to track.
SCENARIO_MODEL = dict(vocab=64, dim=64, heads=2, blocks=2, seq_len=96)
SCENARIO_FLEET = dict(engines=3, slots=1, queue=12, max_new=24, block=8,
                      cache_mb=16.0, prefill_buckets=(16, 48))
#: heavy-tail lognormal request sizes, clamped inside the seq budget
SCENARIO_LENGTHS = dict(prompt_median=12, new_median=8, prompt_sigma=0.5,
                        new_sigma=0.4, prompt_min=4, prompt_max=40,
                        new_min=2, new_max=20)
SCENARIO_MIX = dict(groups=6, share=0.7)
#: targets on ``TIME_BUCKETS`` bounds, so attainment is exact
SCENARIO_SLO = dict(ttft_s=0.5, e2e_s=2.5, attainment=0.95)
SCENARIO_POLICY = dict(min_engines=1, max_engines=3, interval_s=0.1,
                       queue_high=2.0, queue_low=0.5,
                       attainment_low=0.92, attainment_high=0.96,
                       up_after=2, down_after=4, cooldown_s=0.5,
                       min_samples=12)
SCENARIO_TRACES = dict(
    smoke=dict(kind="poisson", rate=25.0, duration_s=1.5, seed=5,
               engines=1, start_engines=1, autoscale=False, workers=6),
    diurnal=dict(kind="diurnal", base_rate=10.0, peak_rate=220.0,
                 period_s=12.0, seed=17, engines=3, start_engines=1,
                 autoscale=True, workers=24),
    spike=dict(kind="spike", base_rate=40.0, spike_rate=300.0,
               duration_s=9.0, spike_start=3.0, spike_duration=2.0,
               seed=23, engines=3, start_engines=2, autoscale=True,
               workers=24),
    chaos=dict(kind="poisson", rate=60.0, duration_s=6.0, seed=29,
               engines=3, start_engines=3, autoscale=False,
               kill_at=2.5, workers=16),
)
#: the JAX package's committed trio (in this order)
SCENARIO_COMMITTED = ("diurnal", "spike", "chaos")
#: seconds an autoscaled scenario's autoscaler may keep ticking on the
#: idle fleet after the trace drained: a fleet that saturates until the
#: trace's end (the probe's, on one card) scales down only there
SCENARIO_IDLE_TAIL_S = 10.0

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def baseline_alerts() -> list:
    """The alert rules of the committed ``OBS_BASELINE.json`` (read as
    JSON)."""
    with open(os.path.join(_REPO, "OBS_BASELINE.json")) as f:
        return json.load(f).get("alerts") or []


def scenario_spec(name: str, sc: dict):
    """The named scenario's arrival schedule, with the committed lengths
    and prefix mix."""
    lengths = LengthModel(**SCENARIO_LENGTHS)
    mix = PrefixMix(**SCENARIO_MIX)
    kind = sc["kind"]
    if kind == "poisson":
        return poisson_trace(sc["rate"], sc["duration_s"], seed=sc["seed"],
                             lengths=lengths, mix=mix, name=name)
    if kind == "diurnal":
        return diurnal_trace(sc["base_rate"], sc["peak_rate"],
                             sc["period_s"], seed=sc["seed"],
                             lengths=lengths, mix=mix, name=name)
    if kind == "spike":
        return spike_trace(sc["base_rate"], sc["spike_rate"],
                           sc["duration_s"], spike_start=sc["spike_start"],
                           spike_duration=sc["spike_duration"],
                           seed=sc["seed"], lengths=lengths, mix=mix,
                           name=name)
    raise ValueError(f"unknown trace kind {kind!r}")


def scenario_run(name: str, model, target, before_traffic=None,
                 trace: Optional[dict] = None):
    """One named scenario end to end: a fresh fleet of ``sc["engines"]``
    in-process servers over copies of ``model`` (``SCENARIO_FLEET``,
    fabric off), the spares parked, the router's alert engine on
    ``OBS_BASELINE.json``'s rules, the open-loop
    storm (the autoscaler on when the scenario says so, one engine
    stopped at ``kill_at`` in the chaos one), then one merged snapshot
    with every reachable engine re-admitted.  ``before_traffic(servers)``
    runs once the fleet is warm, just before the first arrival.  Once the
    trace has drained, the autoscaler keeps ticking on the idle fleet
    until it is back at ``min_engines``, for up to
    ``SCENARIO_IDLE_TAIL_S`` (the JAX package's harness stops it at the
    drain).  ``trace`` overrides settings of the named trace (a shorter
    ``period_s``, say).  Returns ``(row, part, servers)``."""
    import copy

    sc = {**SCENARIO_TRACES[name], **(trace or {})}
    spec = scenario_spec(name, sc)
    f = SCENARIO_FLEET
    servers, router, scaler, killer, stats_client = [], None, None, None, \
        None
    try:
        for _ in range(int(sc["engines"])):
            cfg = ServeConfig(
                slots=f["slots"], max_queue=f["queue"],
                max_new_tokens=f["max_new"],
                prefill_buckets=tuple(f["prefill_buckets"]),
                prefix_cache=True, prefix_cache_mb=f["cache_mb"],
                prefix_block=f["block"])
            servers.append(ServeServer(DecodeEngine(
                copy.deepcopy(model), cfg, registry=Registry(),
                device=model.device).warmup()).start())
        # fabric off: async spill transfers would add scheduling-
        # dependent cold prefills to the accounting
        router = ServeRouter(
            [("127.0.0.1", s.port) for s in servers],
            config=RouterConfig(affinity_block=f["block"],
                                stats_interval_s=0.5,
                                kv_fabric=False)).start()
        start_n = int(sc.get("start_engines", sc["engines"]))
        for be in router.backends[start_n:]:
            parked = router.scale_down(be.addr)
            if not parked.get("ok"):
                raise RuntimeError(f"scenario setup park failed: {parked}")
        router.enable_alerts(baseline_alerts())
        sreg = Registry()
        if sc.get("autoscale"):
            scaler = AutoScaler(router, AutoscalePolicy(**SCENARIO_POLICY),
                                target=target, registry=sreg,
                                alerts=router.alerts)
        stats_client = ServeClient("127.0.0.1", router.port, registry=sreg)
        runner = ScenarioRunner(
            spec,
            make_client=lambda: ServeClient("127.0.0.1", router.port,
                                            registry=sreg),
            snap=lambda: stats_client.stats()["stats"],
            registry=sreg, target=target, workers=int(sc["workers"]),
            deadline_s=10.0, vocab=_vocab(model),
            prefix_len=int(f["block"]) * 2)
        if sc.get("kill_at") is not None:
            victim = servers[-1]

            def _kill():
                # abrupt in-process death: outstanding requests abort
                # with recorded rejections, the router evicts the corpse
                runner.mark_eviction()
                victim.stop(drain=False)

            killer = threading.Timer(float(sc["kill_at"]), _kill)
            killer.daemon = True
        if before_traffic is not None:
            before_traffic(servers)
        if killer is not None:
            killer.start()
        if scaler is not None:
            scaler.start()
        row = runner.run()
        tail_t0 = time.perf_counter()
        if scaler is not None:
            floor = SCENARIO_POLICY["min_engines"]
            while time.perf_counter() - tail_t0 < SCENARIO_IDLE_TAIL_S \
                    and sum(b.alive for b in router.backends) > floor:
                time.sleep(0.05)
        row["idle_tail_s"] = time.perf_counter() - tail_t0
    finally:
        if killer is not None:
            killer.cancel()
        if scaler is not None:
            scaler.stop()
        st = None
        if router is not None and stats_client is not None:
            # re-admit every reachable parked engine BEFORE the part
            # snapshot, so it covers a deterministic engine set
            for be in router.backends:
                if not be.alive:
                    router.scale_up(be.addr)
            st = stats_client.stats()
            stats_client.close()
        if router is not None:
            router.stop()
        for s in servers:
            s.stop()
    part = Registry.merge_snapshots(st["stats"], sreg.snapshot())

    def _v(metric):
        return part.get(metric, {}).get("value", 0)

    h_rec = part.get("scenario.recovery_seconds", {})
    row.update(
        engines=int(sc["engines"]), engines_alive_end=st["engines_alive"],
        scale_up=int(_v("scenario.scale_up")),
        scale_down=int(_v("scenario.scale_down")),
        scale_events=scaler.history if scaler is not None else [],
        shed=int(_v("serve.router.rejected_no_backend")),
        jit_retraces=int(_v("jit.retraces")),
        recovery_s_p50=snapshot_quantile(h_rec, 0.5)
        if h_rec.get("count") else None,
        alerts=(router.alerts.counts() if router.alerts is not None
                else None),
        alert_rules_evaluated=(router.alerts is not None
                               and router.alerts._last_eval is not None),
    )
    return row, part, servers


def _vocab(model) -> int:
    return int(model.layer.layers[0].vocab_size)


def scenario_row(names=None) -> dict:
    """The named scenarios (default: the JAX package's committed trio)
    through the open-loop harness against a fleet of the probe in f32 on
    the card; one row with a part per scenario."""
    names = tuple(names) if names else SCENARIO_COMMITTED
    for n in names:
        if n not in SCENARIO_TRACES:
            raise ValueError(
                f"unknown scenario {n!r} (have "
                f"{', '.join(sorted(SCENARIO_TRACES))})")
    model = zoo.gpt_lm(**PROBE).init(0)
    target = SLOTarget(**SCENARIO_SLO)
    scenarios = {name: scenario_run(name, model, target)[0]
                 for name in names}
    return {"metric": "scenario harness (open-loop SLO attainment)",
            "mode": "scenario", "model": PROBE, "slo": dict(SCENARIO_SLO),
            "scenarios": scenarios,
            "autoscaler_tracked": (
                scenarios.get("diurnal", {}).get("scale_up", 0) > 0
                and scenarios.get("diurnal", {}).get("scale_down", 0) > 0),
            "jit_retraces": sum(s["jit_retraces"]
                                for s in scenarios.values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mnist", action="store_true",
                    help="time to 99%% MNIST accuracy instead")
    ap.add_argument("--continual", action="store_true",
                    help="the continual train+deploy loop instead")
    ap.add_argument("--scenario", default=None, metavar="NAME",
                    help="open-loop scenarios instead: a name of "
                         "SCENARIO_TRACES, a comma-separated list, or all")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="write the row to PATH instead of stdout")
    args = ap.parse_args(argv)
    if sum(map(bool, (args.mnist, args.continual, args.scenario))) > 1:
        ap.error("--mnist, --continual and --scenario are mutually "
                 "exclusive")
    if not torch.cuda.is_available():
        emit("bench: no CUDA device", err=True)
        return 1
    t0 = time.perf_counter()
    if args.scenario:
        names = None if args.scenario == "all" else tuple(
            n.strip() for n in args.scenario.split(",") if n.strip())
        try:
            row = scenario_row(names)
        except ValueError as e:
            ap.error(str(e))
    elif args.continual:
        row = continual_row()
    else:
        row = mnist_row() if args.mnist else resnet20_row()
    row.update(card(), wall_s=time.perf_counter() - t0)
    line = json.dumps(row)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    else:
        emit(line)
    return 0 if row.get("value", 0) is not None else 1


if __name__ == "__main__":
    sys.exit(main())
