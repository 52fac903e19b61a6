"""Test configuration.

Tests run on a virtual 8-device CPU mesh so sharding paths are exercised
without accelerator hardware.  Environment must be set before JAX initializes its
backends, hence module-level assignment here (pytest imports conftest first).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# The config update wins even where JAX_PLATFORMS was already read.  The
# CPU is the default; `JAX_PLATFORMS=cuda pytest -m gpu` runs the tests
# marked gpu on a card.
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from pvot.io.synthetic import SyntheticSpec, generate_gray_video  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop JAX's in-process executable caches after each test module.

    The full suite (but no file subset — bisected) deterministically
    segfaults inside jaxlib's native deserialize_executable
    (compilation_cache.get_executable_and_time) when a persistent-cache
    READ happens late in a long process: ~200 tests of accumulated live
    CPU executables, then the big serving program's warm-cache hit crashes
    (fds=11, threads=20, RSS 6.7 GB at crash — not resource exhaustion;
    the same entry deserializes fine at low accumulation).  Clearing the
    in-process caches between modules keeps every module's accumulation at
    the level the bisect runs proved safe; recompiles across modules stay
    cheap through the persistent cache."""
    yield
    jax.clear_caches()


@pytest.fixture
def need_devices():
    """need_devices(n) skips the test unless JAX sees n devices (decided
    when the test runs, never at import)."""

    def need(n: int) -> None:
        if jax.device_count() < n:
            pytest.skip(f"needs {n} devices, JAX sees {jax.device_count()}")

    return need


@pytest.fixture
def eight_devices(need_devices):
    need_devices(8)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Tests marked `gpu` run only where JAX's default device is a GPU."""
    if request.node.get_closest_marker("gpu") is not None:
        if jax.devices()[0].platform != "gpu":
            pytest.skip("needs an NVIDIA GPU (run: python chip_smoke.py)")


@pytest.fixture(scope="session")
def small_spec():
    """Small clip: fast on CPU, still exercises real geometry."""
    return SyntheticSpec(
        width=320, height=240, num_frames=40, target_w=32, target_h=32, seed=7
    )


@pytest.fixture(scope="session")
def small_video(small_spec):
    return generate_gray_video(small_spec)


@pytest.fixture(scope="session")
def reenter_spec():
    """Clip where the target exits and re-enters the frame (global search)."""
    return SyntheticSpec(
        width=320,
        height=240,
        num_frames=60,
        target_w=32,
        target_h=32,
        seed=3,
        exit_and_reenter=True,
    )


@pytest.fixture(scope="session")
def reenter_video(reenter_spec):
    return generate_gray_video(reenter_spec)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
