"""Device selection, cache trees and weights carried across from JAX."""

from .device import default_device  # noqa: F401
from .weights import load_jax_variables, to_numpy_variables  # noqa: F401
