"""The bench harness runs honestly on the GPU: peaks come from one table
keyed by device kind (an unknown kind is an error), times end in
block_until_ready, the result line names the device, and off the GPU it
refuses to produce a result."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import bench


def test_peaks_for_the_h100():
    p = bench.peaks_for("NVIDIA H100 80GB HBM3")
    assert p["f32_flops"] == 67e12 and p["hbm_bytes_per_s"] == 3.35e12
    assert p["bf16_flops"] > p["tf32_flops"] > p["f32_flops"]


@pytest.mark.parametrize("kind", ["NVIDIA H100 PCIe", "cpu", "NVIDIA A100-SXM4-80GB", ""])
def test_unknown_device_kind_raises(kind):
    with pytest.raises(ValueError, match="no published peaks"):
        bench.peaks_for(kind)


def test_roofline_from_cpu_cost_analysis():
    import jax
    import jax.numpy as jnp

    fn = jax.jit(lambda a, b: a @ b + 1.0)
    a = jnp.ones((64, 64), jnp.float32)
    r = bench.roofline(fn, (a, a), 1e-3, bench.peaks_for("NVIDIA H100 80GB HBM3"))
    if r:  # the CPU client exposes flops + bytes accessed
        assert r["roofline_pct"] > 0.0 and r["bound"] in ("f32", "hbm")


def test_timed_reports_first_call_and_steady_median():
    import jax
    import jax.numpy as jnp

    calls = []

    def fn(x):
        calls.append(1)
        return x + 1.0

    first, steady = bench.timed(jax.jit(fn), jnp.ones(4), reps=3)
    assert first > 0 and steady > 0
    assert len(calls) == 1  # traced once, then the compiled program


def test_emit_names_device_and_errors(capsys):
    dev = {"platform": "gpu", "kind": "k", "count": 1, "card": "c, 1 W"}
    bench.emit({"5_five_effect": {"rtf": 1234.5}}, {"stream": "boom"}, dev)
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["value"] == 1234.5 and rec["device"] == dev
    assert rec["errors"] == {"stream": "boom"}


def test_bench_refuses_a_cpu_device():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "bench.py"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""  # no result line
    assert "needs a GPU" in res.stderr


def test_bench_has_no_process_killing_or_waiting():
    src = open(os.path.join(REPO, "bench.py")).read()
    for word in ("os.kill", "SIGTERM", "wait_for_device", "_retry_once",
                 "_adaptive_slope", "AEFS_PEAK_"):
        assert word not in src, word
