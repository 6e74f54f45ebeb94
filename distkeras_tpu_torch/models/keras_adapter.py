"""Keras-3 model ingestion — train *actual Keras models* with the port's
trainers (the port of ``distkeras_tpu.models.keras_adapter``).

Keras 3 runs on a torch backend with a stateless functional API, so an
unmodified Keras model trains in the port's eager steps:

    kmodel = keras.Sequential([...])        # any Keras 3 model
    model = KerasAdapter(kmodel)
    SingleTrainer(model, "sgd", "categorical_crossentropy",
                  device="cpu").train(ds)

``KerasAdapter`` is an ``nn.Module`` with the port's model protocol
(``init(seed, device)``, ``forward``, ``iter_layers``, ``config`` /
``from_config``) plus ``reinit``.  Its ``layer`` holds the wrapped
model's variables as its own parameters (``trainable_variables``, in
order) and buffers (``non_trainable_variables``: BatchNorm statistics,
seed-generator counters), so the trainers' optimizers, window rules and
worker views act on them as on a native model's; the forward is
``keras.Model.stateless_call`` over them, and a training forward records
the new non-trainable values for ``commit_state``.  The JAX ``variables``
tree of an adapter is ``{"params": [...], "state": [...]}``, the JAX
adapter's.

Keras needs its torch backend (``KERAS_BACKEND=torch`` before the first
``import keras``); it is imported lazily, so importing this module needs
no Keras.  The card's machine has no ``keras``: the adapter runs where
Keras is installed (the CPU here).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
from torch import nn

from ..utils.device import DeviceLike, default_device

_KERAS = None


def _keras():
    """Import keras lazily with the torch backend enforced."""
    global _KERAS
    if _KERAS is not None:
        return _KERAS
    os.environ.setdefault("KERAS_BACKEND", "torch")
    import keras
    if keras.backend.backend() != "torch":
        raise RuntimeError(
            f"keras backend is {keras.backend.backend()!r}; "
            f"distkeras_tpu_torch needs the torch backend (set "
            f"KERAS_BACKEND=torch before importing keras)")
    _KERAS = keras
    return keras


def _snapshot(variables, device) -> list:
    return [v.value.detach().clone().to(device) for v in variables]


class _KerasLayerShim(nn.Module):
    """The wrapped model as one layer: its trainable variables are
    ``params.<i>``, its non-trainable ones the buffers ``state_<i>``, and
    the forward is ``stateless_call`` over them.  A training forward
    records the new non-trainable values in ``new_state``
    (``models.layers.commit_state`` copies them in after the update)."""

    def __init__(self, adapter: "KerasAdapter"):
        super().__init__()
        self.__dict__["_adapter"] = adapter  # the owner, not a child
        self.params = nn.ParameterList()
        self.state_names: list = []
        self.new_state: Optional[dict] = None

    def load(self, trainable: list, non_trainable: list) -> None:
        """Make ``trainable`` / ``non_trainable`` (tensors) this layer's
        parameters and buffers."""
        self.params = nn.ParameterList(
            [nn.Parameter(t, requires_grad=True) for t in trainable])
        for name in self.state_names:
            delattr(self, name)
        self.state_names = [f"state_{i}" for i in range(len(non_trainable))]
        for name, t in zip(self.state_names, non_trainable):
            self.register_buffer(name, t)

    def state_tensors(self) -> list:
        return [getattr(self, n) for n in self.state_names]

    def forward(self, x):
        kmodel = self._adapter.keras_model
        out, new = kmodel.stateless_call(list(self.params),
                                         self.state_tensors(), x,
                                         training=self.training)
        if self.training:
            self.new_state = {n: v.detach()
                              for n, v in zip(self.state_names, new)}
        return out

    def jax_tree(self, leaf):
        """``(params, state)`` as the JAX adapter's variables: lists in
        ``trainable_variables`` / ``non_trainable_variables`` order, with
        ``leaf(tensor)`` at each leaf."""
        return ([leaf(p) for p in self.params],
                [leaf(t) for t in self.state_tensors()])


class KerasAdapter(nn.Module):
    """Wrap a built Keras 3 model (torch backend) into the port's model
    protocol."""

    def __init__(self, keras_model,
                 input_shape: Optional[Sequence[int]] = None):
        super().__init__()
        _keras()
        if not keras_model.built:
            if input_shape is None:
                raise ValueError("pass input_shape= for an unbuilt model")
            keras_model.build((None, *input_shape))
        # the Keras model is itself a torch module: kept out of this
        # module's children, so its own variables are not parameters here
        self.__dict__["keras_model"] = keras_model
        self.input_shape = tuple(int(s) for s in keras_model.input_shape[1:])
        self.output_shape = tuple(
            int(s) for s in keras_model.output_shape[1:])
        self.name = keras_model.name
        self.layer = _KerasLayerShim(self)
        self.train(False)

    # -- model protocol ------------------------------------------------------
    def init(self, seed: int = 0, device: DeviceLike = None) -> "KerasAdapter":
        """The wrapped model's weights as this model's, on ``device``.

        ``seed`` is accepted for signature parity but IGNORED: the
        wrapped model's weights (possibly pretrained) are the init —
        trainers pass their seed here and must never silently discard a
        pretrained snapshot.  Deliberately decorrelated fresh inits
        (ensembles) come from :meth:`reinit`.  Returns the model."""
        device = default_device(device)
        km = self.keras_model
        self.layer.load(_snapshot(km.trainable_variables, device),
                        _snapshot(km.non_trainable_variables, device))
        return self

    def reinit(self, seed: int, device: DeviceLike = None) -> "KerasAdapter":
        """A deterministic FRESH initialization keyed on ``seed`` (a
        seeded clone's weights; ``EnsembleTrainer``'s decorrelated
        members).  Seeds Keras' global RNG as a side effect of cloning.
        Returns the model."""
        keras = _keras()
        device = default_device(device)
        keras.utils.set_random_seed(int(seed) & 0x7FFFFFFF)
        clone = keras.models.model_from_json(self.keras_model.to_json())
        clone.build((None, *self.input_shape))
        self.layer.load(_snapshot(clone.trainable_variables, device),
                        _snapshot(clone.non_trainable_variables, device))
        return self

    @property
    def device(self) -> Optional[torch.device]:
        return next((p.device for p in self.parameters()), None)

    def forward(self, x):
        return self.layer(x)

    def iter_layers(self):
        """An ingested Keras graph has no native layers to traverse:
        callers get the shim only (configure Keras layers on the Keras
        side)."""
        yield self.layer

    # -- serde ---------------------------------------------------------------
    def config(self) -> dict:
        return {"keras_json": self.keras_model.to_json(),
                "input_shape": list(self.input_shape)}

    @classmethod
    def from_config(cls, cfg: dict) -> "KerasAdapter":
        keras = _keras()
        kmodel = keras.models.model_from_json(cfg["keras_json"])
        return cls(kmodel, input_shape=cfg.get("input_shape"))

    def __repr__(self):
        return (f"KerasAdapter({self.name!r}, in={self.input_shape}, "
                f"out={self.output_shape})")
