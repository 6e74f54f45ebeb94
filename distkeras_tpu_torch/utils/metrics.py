"""Structured metrics — the port's copy of ``distkeras_tpu.utils.metrics``
(``json_safe`` and the ``MetricsLogger`` JSONL sink; ``profile_trace``
and ``StepTimer`` come with the profiler readings).

The trainers emit per-epoch records (loss, samples/sec, epoch seconds)
and their spans into one ``MetricsLogger``, with the JAX package's record
fields.
"""

from __future__ import annotations

import collections
import json
import math
import threading
import time
from typing import IO, Union

import numpy as np
import torch

from ..obs.logging import get_logger

#: arrays at or below this many elements serialize as nested lists; larger
#: ones as a shape/dtype/stats summary
_ARRAY_INLINE_MAX = 64


def json_safe(x):
    """Coerce a logged value into strictly-valid JSON data.

    ndarrays (and tensors, read back to the host) become nested lists
    (small) or a summary dict (large); numpy scalars become Python scalars;
    non-finite floats become the strings ``"NaN"`` / ``"Infinity"`` /
    ``"-Infinity"``; anything else goes through ``np.asarray`` and finally
    ``str``.
    """
    if x is None or isinstance(x, (bool, int, str)):
        return x
    if isinstance(x, float):
        if math.isfinite(x):
            return x
        if math.isnan(x):
            return "NaN"
        return "Infinity" if x > 0 else "-Infinity"
    if isinstance(x, dict):
        return {str(k): json_safe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [json_safe(v) for v in x]
    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, np.floating):
        return json_safe(float(x))
    if isinstance(x, np.bool_):
        return bool(x)
    if isinstance(x, torch.Tensor):
        return json_safe(x.detach().float().cpu().numpy()
                         if x.is_floating_point() else x.detach().cpu().numpy())
    if isinstance(x, np.ndarray):
        if x.dtype == object:
            return str(x)
        if x.size <= _ARRAY_INLINE_MAX:
            return json_safe(x.tolist())
        out = {"shape": list(x.shape), "dtype": str(x.dtype)}
        if x.size and np.issubdtype(x.dtype, np.number):
            xf = np.asarray(x, dtype=np.float64)
            out.update(mean=json_safe(float(xf.mean())),
                       min=json_safe(float(xf.min())),
                       max=json_safe(float(xf.max())))
        return out
    try:
        return json_safe(np.asarray(x))
    except (TypeError, ValueError, RuntimeError) as e:
        get_logger("utils.metrics").warning(
            "json_safe: %s is not array-coercible (%s); logging str()",
            type(x).__name__, e)
        return str(x)


class MetricsLogger:
    """Append-only JSONL metrics sink.

    ``MetricsLogger("train.jsonl")`` or ``MetricsLogger(sys.stdout)``;
    ``log(event, **fields)`` writes one line with a wall-clock timestamp.
    The most recent ``keep_records`` records are also kept in ``.records``
    so callers can read trainer-emitted metrics back without parsing the
    sink.
    """

    def __init__(self, sink: Union[str, IO, None] = None,
                 keep_records: int = 100_000):
        self._own = False
        self.records: collections.deque = collections.deque(
            maxlen=keep_records)
        #: one lock keeps JSONL lines whole across threads
        self._lock = threading.Lock()
        if sink is None:
            self._fh = None
        elif isinstance(sink, str):
            self._fh = open(sink, "a", buffering=1)
            self._own = True
        else:
            self._fh = sink

    def log(self, event: str, **fields) -> dict:
        rec = {"ts": time.time(), "event": event, **fields}
        # raw values stay in .records; only the serialized line is coerced
        line = None
        if self._fh is not None:
            line = json.dumps(json_safe(rec), allow_nan=False) + "\n"
        with self._lock:
            self.records.append(rec)
            if line is not None and self._fh is not None:
                self._fh.write(line)
        return rec

    def close(self) -> None:
        with self._lock:
            if self._own and self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
