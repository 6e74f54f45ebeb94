"""Device selection for the port's entry points.

Every entry point (``Model.init``, ``DecodeEngine``, ``generate_tokens``)
runs on the card unless the caller names another device.  With no card
and no explicit device it raises: a run never drifts silently onto the
CPU, where its numbers would mean something else.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def default_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; None means ``cuda``, which must
    exist (RuntimeError otherwise — pass ``device="cpu"`` explicitly)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' explicitly "
                "to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        # name the card, so it compares equal to a tensor's device
        device = torch.device("cuda", torch.cuda.current_device())
    return device

