"""Test configuration: run JAX on a virtual 8-device CPU mesh.

SURVEY.md §4 "Multi-device without a cluster": tests exercise the sharded
engine on `--xla_force_host_platform_device_count=8` CPU devices. These env
vars must be set before the first `import jax` anywhere in the test process.

Tests that need an NVIDIA GPU carry the ``gpu`` marker and take the
``gpu_device`` fixture, which skips them when JAX finds no GPU. They run on
a GPU machine with ``PPRX_TEST_GPU=1 python -m pytest tests/ -m gpu`` (that
variable leaves the platform to JAX instead of forcing the CPU, and keeps
float64 off).
"""

import os

_ON_GPU = os.environ.get("PPRX_TEST_GPU", "0") == "1"

if not _ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
import jax  # noqa: E402

if not _ON_GPU:
    # float64 for the oracle-parity tests. Not on the GPU: there XLA's
    # compiler rejects the engines' inverse-permutation argsort under x64
    # (an s32/s64 mismatch after its permutation-sort rewrite), and the
    # GPU tests run in float32 anyway.
    jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu_device():
    """The first GPU, or skip: decided when the test runs, never at import."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX found {dev.platform!r}")
    return dev


def random_multigraph(rng, n, m):
    """Random directed multigraph COO without self-loops."""
    src = rng.integers(0, n, size=m)
    dst = (src + 1 + rng.integers(0, n - 1, size=m)) % n
    return src.astype(np.int64), dst.astype(np.int64)
