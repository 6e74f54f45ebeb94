"""Library logging under the ``distkeras_tpu_torch`` namespace (the port's
copy of ``distkeras_tpu.obs.logging``).  A ``NullHandler`` is installed
so importing the package never configures global logging;
``enable_stderr_logging()`` opts a script into visible output; ``emit``
is the one deliberate console write (usage lines of the entry points)."""

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


def enable_stderr_logging(level: int = logging.INFO) -> logging.Logger:
    """Attach a stderr handler to the package logger (idempotent) — the
    opt-in for scripts that want diagnostics on the terminal."""
    logger = logging.getLogger(_ROOT)
    if not any(isinstance(h, logging.StreamHandler)
               and not isinstance(h, logging.NullHandler)
               for h in logger.handlers):
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(h)
    logger.setLevel(level)
    return logger


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
