"""offt-tpu: an auto-tuned distributed FFT framework in JAX.

Re-expression of the capabilities of UMD's OFFT (rchyena/offt: auto-tuned
parallel 3-D FFT over a 2-D pencil MPI decomposition with comm/compute
overlap and an Active Harmony tuner) as an idiomatic JAX/XLA library:

- local transforms: XLA's FFT (cuFFT on the GPU) or a mixed-radix matmul
  chain (:mod:`offt_tpu.kernels`)
- distribution: ``jax.sharding.Mesh`` + ``shard_map`` + ``lax.all_to_all``
  slab/pencil plans (:mod:`offt_tpu.dist`)
- plans & tuning: discrete parameter space + strategies + persistent plan
  cache (:mod:`offt_tpu.plan`, :mod:`offt_tpu.tune`)
"""

__version__ = "0.1.0"

from . import fft
from .kernels import fft_1d
from .kernels.rfft import pack_rfft3d, unpack_rfft3d
from .plan.api import (
    Plan,
    fft2d,
    rfft2d,
    irfft2d,
    fft3d,
    from_planar,
    ifft2d,
    ifft3d,
    irfft3d,
    plan,
    rfft3d,
    to_planar,
)

__all__ = [
    "Plan",
    "fft2d",
    "rfft2d",
    "irfft2d",
    "ifft2d",
    "fft3d",
    "from_planar",
    "ifft3d",
    "rfft3d",
    "irfft3d",
    "plan",
    "fft",
    "fft_1d",
    "pack_rfft3d",
    "unpack_rfft3d",
    "to_planar",
    "__version__",
]
