"""Continuous-batching decode serving on the port (plain mode)."""

from .config import ServeConfig  # noqa: F401
from .engine import DecodeEngine, ServeRejected, ServeRequest  # noqa: F401
