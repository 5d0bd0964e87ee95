"""Test config: CPU backend with 8 virtual devices for sharding tests.

Must run before jax is imported anywhere.
"""

import os
import tempfile

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("ASTROBURST_CONFIG_DIR", os.path.join(
    tempfile.gettempdir(), "astroburst_test_config"))
os.environ.setdefault("ASTROBURST_DATA_DIR", os.path.join(
    tempfile.gettempdir(), "astroburst_test_data"))

import jax

# Tests run on the local CPU backend (8 virtual devices) even where a
# card is present; the card runs the gpu-marked bodies via chip_smoke.py.
jax.config.update("jax_platforms", "cpu")
# The api turns the persistent compilation cache on at import; tests
# compile afresh and write nothing into the checkout.
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is a GPU. Decided when the test
    runs, never at import: every xdist worker collects the same tests."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: `python chip_smoke.py` runs these test "
                    "bodies on the card")


@pytest.fixture(autouse=True)
def _clear_cache():
    yield
    from astroburst_tpu.runtime.cache import GLOBAL_IMAGE_CACHE
    GLOBAL_IMAGE_CACHE.clear()


# Reference oracles live in tests/reference_impl (one function per
# reference file, with Rust line citations and pinned fixtures);
# re-exported here for the older tests that import them from conftest.
from tests.reference_impl import ref_median, ref_stats, ref_valid  # noqa: E402,F401
