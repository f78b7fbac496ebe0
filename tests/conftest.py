"""Test harness: the CPU backend with a virtual 8-device mesh.

The tests run on the CPU (``JAX_PLATFORMS=cpu`` or not: the config update
below pins it), with ``--xla_force_host_platform_device_count=8`` so the
sharded paths run on a real (virtual) mesh.  Backends initialize lazily,
so setting XLA_FLAGS here, before the first ``jax.devices()``, still
takes effect.  Kernels run here in interpret mode; their GPU form runs in
``python chip_smoke.py`` on the card.

The compile cache is ``aefs_tpu.utils.platform.enable_compile_cache``'s:
``JAX_COMPILATION_CACHE_DIR`` when set, else the checkout's .jax_cache/.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax

jax.config.update("jax_platforms", "cpu")

from aefs_tpu.utils.platform import enable_compile_cache

enable_compile_cache()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips elsewhere (run on the card by chip_smoke.py)"
    )


@pytest.fixture
def gpu():
    """For tests marked ``gpu``: the GPU device, or a skip when this
    process has none (decided at run time, never at import)."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU; runs on the card via chip_smoke.py")
    return devs[0]
