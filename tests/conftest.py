"""Test configuration.

Tests run on CPU by default with 8 virtual devices, so the multi-device
sharding paths (parallel/) are exercised without a GPU and the chunk
kernel runs in Pallas' interpreter.  Set ``MRI_GPU_TESTS=1`` to run on the
GPU instead, in ONE process (several processes cannot share the card's
memory):

    MRI_GPU_TESTS=1 python -m pytest tests/ -m gpu -p no:xdist

Tests that need the card carry the ``gpu`` marker; whether a card is
present is decided per test by the ``_gpu_gate`` fixture, never at
collection time, so every xdist worker collects the same tests.

Environment variables must be set before jax initializes its backends,
hence the top-of-file manipulation.
"""

import os

_USE_GPU = os.environ.get("MRI_GPU_TESTS", "0") == "1"
if not _USE_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: test needs an NVIDIA GPU (run with MRI_GPU_TESTS=1)")
    config.addinivalue_line(
        "markers", "slow: long-running test; deselect with -m 'not slow'")


def _slow_prefixes():
    """Durations-informed slow tier: tests/slow_tests.txt lists the
    node-id prefixes (function level, parametrizations included) of the
    longest-running tests.  The per-commit gate is ``pytest -m "not
    slow"``; regenerate the list from a ``--durations=0`` run when the
    distribution shifts."""
    path = os.path.join(os.path.dirname(__file__), "slow_tests.txt")
    if not os.path.exists(path):
        return ()
    with open(path) as f:
        return tuple(line.strip() for line in f if line.strip())


def pytest_collection_modifyitems(config, items):
    slow = _slow_prefixes()
    for item in items:
        if item.nodeid.split("[")[0] in slow:
            item.add_marker(pytest.mark.slow)


@pytest.fixture(autouse=True)
def _gpu_gate(request):
    """Skip ``gpu``-marked tests unless this process runs on a GPU."""
    if request.node.get_closest_marker("gpu") is not None \
            and jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (MRI_GPU_TESTS=1)")


@pytest.fixture(scope="session")
def f64():
    """Enable float64 for oracle-precision tests (CPU only)."""
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)
