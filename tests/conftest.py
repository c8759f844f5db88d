import jax
import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def key():
    return jax.random.key(0)


@pytest.fixture
def gpu():
    """JAX's first device if it is a GPU; otherwise the test is skipped.
    Decided here, at run time, never at collection."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(
            f"needs a GPU (JAX's first device is {dev.platform}); run with "
            "JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu"
        )
    return dev
