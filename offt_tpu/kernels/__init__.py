"""Local transform kernels: the mixed-radix matmul chain, r2c/c2r helpers."""

from . import dft
from .stockham import fft, fft_1d, ifft

__all__ = ["dft", "fft", "fft_1d", "ifft"]
