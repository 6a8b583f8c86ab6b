"""Hand-written CUDA kernels of the port (sources in ``csrc/``)."""

from .build import LAUNCHES, check, library

__all__ = ["LAUNCHES", "check", "library"]
