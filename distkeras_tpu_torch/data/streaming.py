"""Disk-backed streaming input — the port of ``distkeras_tpu.data.
streaming``, in its ``.npz`` shard layout.

The in-memory ``Dataset`` holds every column as one ndarray: fine for
MNIST or CIFAR, wrong for ImageNet-scale inputs.  A ``ShardedFileDataset``
is a directory of row-aligned ``.npz`` shards and a ``meta.json``;
batches stream from it with bounded host memory: at any moment only the
current shard and a small prefetch queue are resident.  Either package
reads a directory the other wrote, and yields the same batches for the
same seed.

Engines: ``"thread"`` — a producer thread reads shards and slices
batches into a bounded queue, so disk reads overlap device work;
``"raw"`` — the same batches, synchronously.  ``"auto"`` means
``"thread"``: the JAX package's ``"tfdata"`` engine needs TensorFlow,
which the card's machine does not have.

The trainers accept a ``ShardedFileDataset`` directly: ``SingleTrainer``
streams ``stream_window`` batches a window, the sync distributed trainers
one window of every worker's own shard partition at a time.

Instrumented (process-wide default registry, the JAX package's names):
``stream.batches`` counts batches handed to consumers,
``stream.stall_seconds`` accumulates the time a consumer sat blocked on
an empty prefetch queue (the disk-bound signal), ``stream.
prefetch_occupancy`` gauges the queue's depth at each hand-over (the
``stream.prefetch_depth`` histogram keeps every such reading, so a run's
mean depth is its sum over its count), and
``stream.producer_leaks`` counts producer threads still alive after
their bounded join.
"""

from __future__ import annotations

import itertools
import json
import os
import queue
import threading
import time
import zipfile
from typing import Iterator, Optional, Sequence

import numpy as np

from ..obs.registry import default_registry

_META = "meta.json"


class ShardedFileDataset:
    """A directory of row-aligned ``.npz`` shards + a ``meta.json``.

    Create one with :meth:`write` (from any in-memory ``Dataset``) or
    point it at a directory another writer produced (each shard one
    ``.npz`` with the same keys; meta lists the shards in order).
    """

    def __init__(self, directory: str):
        self.directory = directory
        with open(os.path.join(directory, _META)) as f:
            meta = json.load(f)
        self.shards: list = meta["shards"]
        self.num_rows: int = int(meta["num_rows"])
        self.column_names: list = meta["columns"]
        self._shard_rows: Optional[list] = meta.get("shard_rows")

    # -- construction -------------------------------------------------------
    @staticmethod
    def write(dataset, directory: str,
              rows_per_shard: int = 4096) -> "ShardedFileDataset":
        """Spill an in-memory ``Dataset`` to disk shards."""
        os.makedirs(directory, exist_ok=True)
        shards, shard_rows = [], []
        for i, lo in enumerate(range(0, dataset.num_rows, rows_per_shard)):
            hi = min(lo + rows_per_shard, dataset.num_rows)
            name = f"shard_{i:05d}.npz"
            np.savez(os.path.join(directory, name),
                     **{c: dataset[c][lo:hi] for c in dataset.column_names})
            shards.append(name)
            shard_rows.append(hi - lo)
        with open(os.path.join(directory, _META), "w") as f:
            json.dump({"shards": shards, "num_rows": dataset.num_rows,
                       "columns": dataset.column_names,
                       "shard_rows": shard_rows}, f)
        return ShardedFileDataset(directory)

    # -- iteration ----------------------------------------------------------
    def steps_per_epoch(self, batch_size: int) -> int:
        return self.num_rows // batch_size

    def shard_rows(self) -> list:
        """Per-shard row counts: from ``meta.json`` (``write`` puts them
        there), else probed once from each shard's first ``.npy`` header
        (no array data is read)."""
        if self._shard_rows is None:
            col0 = self.column_names[0] + ".npy"
            rows = []
            for name in self.shards:
                with zipfile.ZipFile(
                        os.path.join(self.directory, name)) as z, \
                        z.open(col0) as f:
                    version = np.lib.format.read_magic(f)
                    if version == (1, 0):
                        shape, _, _ = np.lib.format.read_array_header_1_0(f)
                    else:
                        shape, _, _ = np.lib.format.read_array_header_2_0(f)
                    rows.append(int(shape[0]))
            self._shard_rows = rows
        return self._shard_rows

    # -- per-worker partitioning: worker k streams only its own shards -------
    def worker_shard_indices(self, worker: int, num_workers: int) -> list:
        """Round-robin shard → worker assignment (shard i → worker i % P).
        With ``rows_per_shard = num_rows // P`` this is the in-memory
        ``Dataset.repartition(P)`` contiguous split exactly."""
        if not (0 <= worker < num_workers):
            raise ValueError(f"worker {worker} outside [0, {num_workers})")
        if len(self.shards) < num_workers:
            raise ValueError(
                f"{len(self.shards)} shards cannot feed {num_workers} "
                f"workers (need >= one shard per worker; re-write with "
                f"rows_per_shard <= {self.num_rows // num_workers})")
        return list(range(worker, len(self.shards), num_workers))

    def worker_rows(self, worker: int, num_workers: int) -> int:
        rows = self.shard_rows()
        return sum(rows[i] for i in
                   self.worker_shard_indices(worker, num_workers))

    def worker_steps_per_epoch(self, batch_size: int,
                               num_workers: int) -> int:
        """The step count every worker runs an epoch: the least over the
        workers (all run the same number of steps)."""
        return min(self.worker_rows(k, num_workers) // batch_size
                   for k in range(num_workers))

    def worker_batches(self, cols: Sequence[str], batch_size: int,
                       worker: int, num_workers: int,
                       engine: str = "thread", prefetch: int = 4,
                       seed: Optional[int] = None) -> Iterator[tuple]:
        """Batches drawn only from ``worker``'s shard partition; ``seed``
        is decorrelated per worker (``seed * P + worker + 1``).
        ``engine="thread"`` prefetches in a producer thread, ``"raw"``
        iterates synchronously."""
        idx = self.worker_shard_indices(worker, num_workers)
        wseed = None if seed is None else (seed * num_workers + worker + 1)
        src = self._batch_source(cols, batch_size, wseed, shard_indices=idx)
        if engine == "thread":
            return _prefetched(src, prefetch)
        if engine == "raw":
            return src
        raise ValueError(f"engine must be thread|raw, got {engine!r}")

    def _load(self, name: str) -> dict:
        with np.load(os.path.join(self.directory, name)) as d:
            return {k: d[k] for k in d.files}

    def _batch_source(self, cols: Sequence[str], batch_size: int,
                      seed: Optional[int],
                      shard_indices: Optional[Sequence[int]] = None
                      ) -> Iterator[tuple]:
        """Sequential batches: shards in order (shuffled by
        ``default_rng(seed)`` when seeded, each shard's rows permuted by
        ``default_rng((seed, shard index))``), rows carried across shard
        boundaries, the remainder dropped (every batch has one shape)."""
        order = list(shard_indices) if shard_indices is not None \
            else list(range(len(self.shards)))
        if seed is not None:
            np.random.default_rng(seed).shuffle(order)
        carry = None
        for si in order:
            shard = self._load(self.shards[si])
            if seed is not None:
                perm = np.random.default_rng((seed, si)).permutation(
                    len(shard[cols[0]]))
                shard = {k: v[perm] for k, v in shard.items()}
            arrs = [shard[c] for c in cols]
            if carry is not None:
                arrs = [np.concatenate([c, a]) for c, a in zip(carry, arrs)]
            n = arrs[0].shape[0]
            nb = n // batch_size
            for b in range(nb):
                yield tuple(a[b * batch_size:(b + 1) * batch_size]
                            for a in arrs)
            rem = n - nb * batch_size
            carry = [a[n - rem:] for a in arrs] if rem else None

    def batches(self, cols: Sequence[str], batch_size: int,
                engine: str = "auto", prefetch: int = 4,
                seed: Optional[int] = None) -> Iterator[tuple]:
        """Stream ``(col_0, col_1, ...)`` batch tuples from disk."""
        if engine in ("auto", "thread"):
            return _prefetched(self._batch_source(cols, batch_size, seed),
                               prefetch)
        if engine == "tfdata":
            raise ValueError("engine 'tfdata' needs TensorFlow, which the "
                             "port does not use; use 'thread'")
        raise ValueError(f"engine must be auto|tfdata|thread, got {engine!r}")


def window_batches(it: Iterator[tuple], window: int) -> Iterator[tuple]:
    """Group ``window`` consecutive batch tuples into one tuple of stacked
    arrays with a leading ``(window,)`` axis; a trailing partial window
    is dropped.  Closing this generator closes ``it``."""
    try:
        while True:
            group = list(itertools.islice(it, window))
            if len(group) < window:
                return
            yield tuple(np.stack(col) for col in zip(*group))
    finally:
        # a consumer that abandons the epoch early releases the source's
        # prefetch thread and shard now
        if hasattr(it, "close"):
            it.close()


def worker_windows_per_epoch(source: ShardedFileDataset, batch_size: int,
                             num_workers: int, window: int) -> int:
    """The window count every worker runs an epoch, validated."""
    steps = source.worker_steps_per_epoch(batch_size, num_workers)
    n = steps // window
    if n == 0:
        raise ValueError(
            f"communication_window {window} exceeds the {steps} steps "
            f"available per worker (decrease window/batch_size or add data)")
    return n


def worker_window_factory(source: ShardedFileDataset, cols: Sequence[str],
                          batch_size: int, worker: int, num_workers: int,
                          window: int, base_seed: int, shuffle: bool):
    """``factory(epoch) -> iterator`` of stacked ``(window, batch, ...)``
    column tuples over ``worker``'s shard partition, epoch e of a
    shuffled run seeded ``base_seed + 1000 + e`` (the JAX package's one
    recipe for every streaming consumer)."""
    def make(epoch: int):
        seed = (base_seed + 1000 + epoch) if shuffle else None
        return window_batches(
            source.worker_batches(cols, batch_size, worker, num_workers,
                                  seed=seed), window)
    return make


#: seconds a producer blocks on a full queue before it looks at ``stop``
_PUT_TIMEOUT = 0.1
#: seconds the consumer's teardown waits for the producer to exit
_JOIN_TIMEOUT = 2.0
#: ``stream.prefetch_depth``'s buckets: queue depths, in items
DEPTH_BUCKETS = (0, 1, 2, 4, 8, 16, 32)


def _prefetched(it: Iterator, depth: int) -> Iterator:
    """Run ``it`` in a producer thread with a bounded queue: disk reads
    overlap the consumer's work; memory stays bounded at ``depth`` items.

    The consumer may abandon the iterator mid-epoch: closing it (or its
    collection) sets ``stop``, the producer's blocked ``put`` times out
    and the thread exits instead of pinning its shard; a bounded ``join``
    then confirms the exit, and a producer still alive after it is
    counted in ``stream.producer_leaks``."""
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    end = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=_PUT_TIMEOUT)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for item in it:
                if not put(item):
                    return
            put(end)
        except BaseException as e:  # surfaced on the consumer side
            put(e)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    reg = default_registry()
    c_batches = reg.counter("stream.batches")
    c_stall = reg.counter("stream.stall_seconds")
    g_occ = reg.gauge("stream.prefetch_occupancy")
    h_depth = reg.histogram("stream.prefetch_depth", DEPTH_BUCKETS)
    try:
        while True:
            t0 = time.perf_counter()
            item = q.get()  # blocks only when the producer is behind
            c_stall.inc(time.perf_counter() - t0)
            depth_now = q.qsize()
            g_occ.set(depth_now)
            h_depth.observe(depth_now)
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            c_batches.inc()
            yield item
    finally:
        stop.set()
        t.join(timeout=_JOIN_TIMEOUT)
        if t.is_alive():  # pragma: no cover - pathological IO stall
            reg.counter("stream.producer_leaks").inc()
