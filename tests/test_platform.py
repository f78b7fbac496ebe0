"""Platform selection and compile-cache placement (utils/platform.py).

Each case runs in a fresh interpreter: JAX reads its cache and platform
settings once per process, and this test process is already pinned to
the CPU by conftest.py."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, **env):
    e = {k: v for k, v in os.environ.items()
         if k not in ("JAX_COMPILATION_CACHE_DIR", "AEFS_PLATFORM", "JAX_PLATFORMS")}
    e.update(env)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=e,
                          capture_output=True, text=True, timeout=300)


CACHE = ("import jax; from aefs_tpu.utils.platform import enable_compile_cache; "
         "m0 = jax.config.jax_persistent_cache_min_compile_time_secs; "
         "d = enable_compile_cache(); "
         "print(d); print(jax.config.jax_compilation_cache_dir); "
         "print(m0 == jax.config.jax_persistent_cache_min_compile_time_secs)")


def test_cache_goes_to_the_env_dir_and_nothing_else_is_set(tmp_path):
    res = _run(CACHE, JAX_COMPILATION_CACHE_DIR=str(tmp_path), JAX_PLATFORMS="cpu")
    assert res.returncode == 0, res.stderr
    ret, cfg, untouched = res.stdout.split()
    assert ret == cfg == str(tmp_path)
    assert untouched == "True"  # JAX's own setting, not the code's


def test_cache_defaults_to_the_ignored_checkout_dir():
    res = _run(CACHE, JAX_PLATFORMS="cpu")
    assert res.returncode == 0, res.stderr
    ret, cfg, _ = res.stdout.split()
    assert ret == cfg == os.path.join(REPO, ".jax_cache")
    ignored = open(os.path.join(REPO, ".gitignore")).read().split()
    assert ".jax_cache/" in ignored


def test_requested_missing_platform_raises():
    res = _run("from aefs_tpu.utils.platform import select_platform; "
               "select_platform('gpu')")
    assert res.returncode != 0
    assert "requested platform 'gpu' is not available" in res.stderr


def test_env_platform_cpu_selects_the_cpu():
    res = _run("from aefs_tpu.utils.platform import select_platform; "
               "print(select_platform())", AEFS_PLATFORM="cpu")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "cpu"


@pytest.mark.parametrize("name", ["rocm", "metal", "cuda"])
def test_unknown_platform_name_raises(name):
    from aefs_tpu.utils.platform import select_platform

    with pytest.raises(ValueError, match="unknown platform"):
        select_platform(name)


def test_cli_rejects_a_platform_outside_cpu_and_gpu():
    res = subprocess.run([sys.executable, "-m", "aefs_tpu.cli", "--platform", "rocm",
                          "a.wav", "b.wav"], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 2 and "invalid choice" in res.stderr
