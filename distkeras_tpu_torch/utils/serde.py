"""Tree and model serialization — the port of ``distkeras_tpu.utils.serde``
in its byte formats.

Two encodings share one ndarray leaf convention (a map of ``dtype`` — the
numpy dtype string, or ``"bfloat16"`` — ``shape`` and the tensor's
C-order bytes), written by the port's own msgpack codec
(``utils._msgpack``), byte for byte as the JAX package writes them:

* **v1, inline** (``tree_to_bytes`` / ``tree_from_bytes``): one
  self-contained blob; every tensor's bytes are copied into it under the
  marker key ``__nd__``.  The model-blob and checkpoint format.
* **v2, framed** (``tree_to_frames`` / ``tree_from_frames``): the header
  holds ``__ndseg__`` stubs (segment index, dtype, shape) and the tensor
  bytes travel as out-of-band segments, buffer views of the arrays' own
  memory (a non-contiguous leaf is compacted first).

Leaves may be numpy arrays or torch tensors; a tensor on the card comes
to the host in one copy.  Decoded leaves are numpy arrays, read-only
views over the blob's bytes (v1) or over the segments (v2), with one
exception: bfloat16 travels as its uint16 bit pattern, as in the JAX
package, and decodes to a CPU ``torch.bfloat16`` tensor, because numpy
has no bfloat16 of its own (the JAX package decodes to ``ml_dtypes``'
type, which the card's machine does not have).

``serialize_model`` / ``deserialize_model`` carry a model's config JSON
and its variables tree (``{"arch": json, "variables": tree}``).
``deserialize_model`` returns the built model, without parameters, and
the variables; the caller places them on a device with
``model.init(0, device=...)`` and ``utils.weights.load_jax_variables``.
"""

from __future__ import annotations

import json
from typing import Any, List, Tuple

import numpy as np
import torch

from . import _msgpack

_ND = "__nd__"        # v1: inline ndarray marker key
_NDSEG = "__ndseg__"  # v2: out-of-band segment stub marker key
_BF16 = "bfloat16"


def _host_array(obj) -> np.ndarray:
    """A leaf as a host numpy array; a bfloat16 leaf (a torch tensor, or
    a numpy array of ``ml_dtypes``' type) as its uint16 bits."""
    if torch.is_tensor(obj):
        t = obj.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        return t.numpy(), None
    arr = np.asarray(obj)
    if arr.dtype.name == _BF16:
        return arr.view(np.uint16), _BF16
    return arr, None


def _is_leaf(obj) -> bool:
    return isinstance(obj, np.ndarray) or torch.is_tensor(obj)


def _default(obj):
    if _is_leaf(obj):
        arr, tag = _host_array(obj)
        return {_ND: 1, "dtype": tag or arr.dtype.str,
                "shape": list(arr.shape), "data": arr.tobytes()}
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    raise TypeError(f"cannot serialize {type(obj)}")


def _leaf(buf, dtype: str, shape):
    """The decoded leaf over ``buf``'s bytes."""
    if dtype == _BF16:
        bits = np.frombuffer(buf, dtype=np.int16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)


def _object_hook(obj):
    if _ND in obj:
        return _leaf(obj["data"], obj["dtype"], obj["shape"])
    return obj


def tree_to_bytes(tree: Any) -> bytes:
    """Serialize a tree of arrays / tensors / scalars / dicts / lists."""
    return _msgpack.packb(tree, default=_default)


def tree_from_bytes(data: bytes) -> Any:
    return _msgpack.unpackb(data, object_hook=_object_hook)


# ---------------------------------------------------------------------------
# v2 framed encoding: zero-copy tensor segments
# ---------------------------------------------------------------------------

def tree_to_frames(tree: Any) -> Tuple[bytes, List[Any]]:
    """``(header, segments)``: ``header`` has every leaf replaced by a
    ``{__ndseg__: i, dtype, shape}`` stub and ``segments[i]`` is a
    buffer view of the i-th leaf's bytes, not a copy (a non-contiguous
    leaf is compacted first, and a leaf on the card copied to the
    host)."""
    segments: List[Any] = []

    def default(obj):
        if _is_leaf(obj):
            arr, tag = _host_array(obj)
            if not arr.flags.c_contiguous:  # ascontiguousarray would also
                arr = np.ascontiguousarray(arr)  # promote 0-d to 1-d
            stub = {_NDSEG: len(segments), "dtype": tag or arr.dtype.str,
                    "shape": list(arr.shape)}
            segments.append(arr)
            return stub
        return _default(obj)

    header = _msgpack.packb(tree, default=default)
    return header, segments


def tree_from_frames(header: bytes, segments: List[Any]) -> Any:
    """Inverse of :func:`tree_to_frames`; ``segments`` may be any
    buffer-protocol objects, and numpy leaves are views over them."""

    def hook(obj):
        if _NDSEG in obj:
            return _leaf(segments[obj[_NDSEG]], obj["dtype"], obj["shape"])
        return _object_hook(obj)

    return _msgpack.unpackb(header, object_hook=hook)


# ---------------------------------------------------------------------------
# model-level serde
# ---------------------------------------------------------------------------

def serialize_model(model, variables: Any = None) -> bytes:
    """Architecture config + variables blob (parity: reference
    ``distkeras/utils.py:serialize_keras_model``)."""
    return tree_to_bytes({"arch": json.dumps(model.config()),
                          "variables": variables})


def model_from_config(cfg: dict):
    """Rebuild a model from its config dict: an ingested Keras-3 model's
    (its ``keras_json`` key) through ``KerasAdapter``, any other through
    ``Model``."""
    if "keras_json" in cfg:
        from ..models.keras_adapter import KerasAdapter
        return KerasAdapter.from_config(cfg)
    from ..models.model import Model
    return Model.from_config(cfg)


def deserialize_model(data: bytes):
    """``(model, variables)``: the model built from the blob's config
    (without parameters: ``model.init(0, device=...)`` builds them) and
    its variables tree, None if none was saved."""
    payload = tree_from_bytes(data)
    model = model_from_config(json.loads(payload["arch"]))
    return model, payload.get("variables")
