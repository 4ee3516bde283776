import os
import sys

# tests must see exactly ONE device (dry-run subprocesses set their own flags)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "requires_cuda: needs an NVIDIA GPU (skipped without one)")


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)
