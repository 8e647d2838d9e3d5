"""Test environment: force CPU JAX with 8 virtual devices.

The tier-1 suite never needs a GPU: the traversal kernel runs in the
Pallas interpreter on the CPU (kernels/walk.py ``kernel_interpret``), and
sharding tests use an 8-device virtual CPU mesh (SURVEY.md §4 test plan).
The platform is forced through jax.config as well as the environment, in
case something imported jax before this conftest ran.

Tests marked ``card`` need the GPU; they skip here through the ``card``
fixture.  ``chip_smoke.py`` runs them on the card in its own process with
``MRT_CARD_TESTS=1``, which leaves the platform alone.
"""

import os

if os.environ.get("MRT_CARD_TESTS") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if os.environ.get("MRT_CARD_TESTS") != "1":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)


import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Cap process memory growth over the ~200-test suite: XLA:CPU
    compile artifacts accumulate per module.  Shapes rarely cross module
    boundaries, so per-module clearing costs little recompilation."""
    yield
    import jax

    jax.clear_caches()


@pytest.fixture
def card():
    """Skip unless JAX runs on a GPU (tests marked ``card``)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs the GPU: run through chip_smoke.py on the card")
    return jax.devices()[0]
