"""Test configuration: run JAX on CPU with 8 virtual devices.

Multi-chip sharding logic is validated on a virtual 8-device CPU mesh.
Tests that need an NVIDIA GPU carry the ``gpu`` marker and skip where
JAX's default device is not one; run them on a card with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.  Must run before
the first `import jax` anywhere.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import pathlib

import jax
import pytest

# persist compiled kernels across test runs (first run pays the compile)
_CACHE = pathlib.Path(__file__).parent.parent / ".jax_cache"
jax.config.update("jax_compilation_cache_dir", str(_CACHE))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

CORPUS_DIR = pathlib.Path(__file__).parent / "corpus"


@pytest.fixture(scope="session")
def corpus_files():
    return sorted(CORPUS_DIR.iterdir())


@pytest.fixture(scope="session")
def small_corpus():
    """A few small/medium corpus files for fast roundtrip tests."""
    names = ["progc", "obj1", "paper1", "rfc5322.txt"]
    return [(n, (CORPUS_DIR / n).read_bytes()) for n in names]


@pytest.fixture
def gpu():
    """The GPU the test runs on; skips the test where there is none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX's default device is {dev}")
    return dev


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running multi-process tests")
    config.addinivalue_line(
        "markers", "gpu: runs compiled kernels on an NVIDIA GPU; skips elsewhere")
