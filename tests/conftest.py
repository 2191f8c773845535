"""Test harness config: the suite runs on the CPU with 8 virtual devices,
so distributed (mesh) paths run without GPUs — the answer to the
reference's "mpirun -n N on one host" testing story (SURVEY.md §4.5).

Tests marked ``gpu`` need a card and skip elsewhere (the ``gpu`` fixture
decides at run time); ``python chip_smoke.py`` runs the same paths on the
card.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import tempfile

os.environ.setdefault("OFFT_TPU_CACHE_DIR",
                      tempfile.mkdtemp(prefix="offt_test_cache_"))

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided when the test runs)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this path "
                    "on the card")
