"""Library logging under the ``distkeras_tpu_torch`` namespace (the port's
copy of ``distkeras_tpu.obs.logging``'s ``get_logger`` and ``emit``).  A
``NullHandler`` is installed so importing the package never configures
global logging; ``emit`` is the one deliberate console write (usage
lines of the entry points)."""

from __future__ import annotations

import logging
import sys
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


def emit(msg: str = "", *, err: bool = False, flush: bool = True) -> None:
    """Deliberate console output (usage strings).  The only sanctioned
    stdout/stderr write in library code."""
    stream = sys.stderr if err else sys.stdout
    stream.write(str(msg) + "\n")
    if flush:
        try:
            stream.flush()
        except OSError:  # broken pipe on teardown
            pass
