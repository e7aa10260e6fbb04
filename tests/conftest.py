"""Test configuration: run the suite on a virtual 8-device CPU mesh.

The env vars must be set before jax initializes its backends, so this
happens at conftest import time (pytest imports conftest before test
modules). JAX_PLATFORMS defaults to cpu; the `gpu`-marked tests skip
there and run on the card from chip_smoke.py. Sharding tests use the 8
virtual CPU devices.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

# XLA compiles are slow-ish on the CPU; persist them across test runs.
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "-1")

import pathlib  # noqa: E402
import sys  # noqa: E402

import pytest  # noqa: E402

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

from funky_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

REFERENCE_MODELS = pathlib.Path("/root/reference/models")


@pytest.fixture(scope="session")
def duck_gltf_path():
    p = REFERENCE_MODELS / "scene.gltf"
    if not p.exists():
        pytest.skip("reference Duck assets not available")
    return p
