"""Test configuration.

Tests run on CPU with 8 virtual devices so multi-device sharding paths
are exercised without a GPU. The one exception is the chip-marked tests
(tests/test_chip.py), which chip_smoke.py runs in its own process on
the GPU: it sets PSI_CHIP_TESTS=1, and then this file leaves the
platform alone.
"""

import os
import pathlib

#: set by chip_smoke.py, which runs the chip tests on the GPU it holds
ON_CHIP = os.environ.get("PSI_CHIP_TESTS") == "1"

if not ON_CHIP:
    # jax may already be imported (its config read JAX_PLATFORMS
    # then), so pin the live config as well as the env
    os.environ["JAX_PLATFORMS"] = "cpu"
    xla_flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in xla_flags:
        os.environ["XLA_FLAGS"] = (
            xla_flags + " --xla_force_host_platform_device_count=8"
        ).strip()

    import jax  # noqa: E402

    jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402

#: Reference test data (tiny/small/multi graphs + reads). Read-only mount.
TEST_DATA_DIR = pathlib.Path(
    os.environ.get("PSI_TEST_DATA", "/root/reference/test/data")
)


@pytest.fixture(scope="session")
def data_dir():
    if not TEST_DATA_DIR.exists():
        pytest.skip("reference test data not available")
    return TEST_DATA_DIR


def require_data():
    return pytest.mark.skipif(
        not TEST_DATA_DIR.exists(), reason="reference test data not available"
    )
