"""Runtime platform selection and the compile cache.

The program runs on the GPU (an NVIDIA H100) and on the CPU, which is
where the tests run.  ``AEFS_PLATFORM`` (or a ``--platform`` option)
picks the backend for the server and CLI entry points:

    AEFS_PLATFORM=cpu    — the host CPU (development, tests)
    AEFS_PLATFORM=gpu    — the GPU; a missing GPU is an error

Unset, JAX uses its default: the GPU where one is found.  Call
``select_platform()`` before the first jax dispatch.
"""

from __future__ import annotations

import os

PLATFORMS = ("cpu", "gpu")

# The checkout-local compile cache (listed in .gitignore).
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def select_platform(requested: str | None = None) -> str:
    """Pin JAX to ``requested`` (or ``AEFS_PLATFORM``) and return the
    default backend.  A requested platform that JAX cannot start raises
    RuntimeError instead of falling back to another one."""
    import jax

    choice = requested or os.environ.get("AEFS_PLATFORM", "")
    if choice:
        if choice not in PLATFORMS:
            raise ValueError(f"unknown platform {choice!r}; expected one of {PLATFORMS}")
        jax.config.update("jax_platforms", choice)
        try:
            platform = jax.devices()[0].platform
        except RuntimeError as e:
            raise RuntimeError(f"requested platform {choice!r} is not available: {e}") from e
        if platform != choice:
            raise RuntimeError(f"requested platform {choice!r}, JAX started {platform!r}")
    return jax.default_backend()


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX already reads it and
    nothing is set here; otherwise the cache goes to the fixed
    checkout-local ``CACHE_DIR``."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return CACHE_DIR


def card_name_and_power_limit() -> str:
    """The first card's ``name, power.limit`` as nvidia-smi prints them
    (a card below its 700 W maximum runs slower under load, so every
    number measured on it carries this line)."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=30,
    )
    return out.stdout.strip().splitlines()[0]
