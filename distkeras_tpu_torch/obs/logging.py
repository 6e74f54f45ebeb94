"""Library logging under the ``distkeras_tpu_torch`` namespace (the port's
copy of ``distkeras_tpu.obs.logging.get_logger``).  A ``NullHandler`` is
installed so importing the package never configures global logging."""

from __future__ import annotations

import logging
from typing import Optional

_ROOT = "distkeras_tpu_torch"

logging.getLogger(_ROOT).addHandler(logging.NullHandler())


def get_logger(name: Optional[str] = None) -> logging.Logger:
    """Namespaced library logger (``distkeras_tpu_torch`` or a child)."""
    if not name:
        return logging.getLogger(_ROOT)
    if not name.startswith(_ROOT):
        name = f"{_ROOT}.{name}"
    return logging.getLogger(name)
