import os
import sys

# Run all tests on a virtual 8-device CPU mesh so multi-device sharding
# paths are exercised without a GPU.  jax may already be imported when this
# file runs, but the backend only initializes on first use, so jax.config
# still switches us to CPU.  XLA_FLAGS must be in the environment before
# the CPU client initializes.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Many reference test programs are float64; the numpy oracle handles those,
# and the JAX paths need x64 enabled to match on CPU.
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402

STENCILS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "stencils")


@pytest.fixture
def stencils_dir():
    return STENCILS_DIR
