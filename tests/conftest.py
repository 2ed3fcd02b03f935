"""Test configuration: JAX on a virtual multi-device CPU backend.

The suite runs on the CPU (``JAX_PLATFORMS=cpu``, the default set here), with
8 virtual devices so the multi-device sharding tests run without cards
(SURVEY.md §4). Tests marked ``gpu`` need a card: on a machine with one, run
``JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu``; the ``gpu`` fixture
skips them elsewhere.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# XLA flags are read lazily at backend init, so setting them here still works.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

from metta_tpu.utils.device import enable_compile_cache  # noqa: E402

# Persistent compilation cache: test configs re-trace identical programs across
# runs. Kept where JAX_COMPILATION_CACHE_DIR says, else in <checkout>/.jax_cache.
enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


@pytest.fixture
def gpu():
    """The first GPU, or a skip: decided when the test runs, not at import,
    so every xdist worker collects the same tests."""
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip("needs a GPU: run with JAX_PLATFORMS=cuda,cpu on a machine with a card")
    return device
