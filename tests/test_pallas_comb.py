"""Triton comb kernel (interpret mode on the CPU) vs the plain-XLA chunked
solve, and the XLA solve vs a per-sample comb oracle.

The kernel takes RAW source signals and a comb -> source map; it reads
each comb's lag-shifted window itself, so the tests feed it the unshifted
(S, N) signals directly."""

import jax
import numpy as np
import jax.numpy as jnp
import pytest

from aefs_tpu.ops.pallas.comb import block_geometry, comb_bank_pallas
from aefs_tpu.ops.ringbuf import _comb_bank_scan, comb_bank_file, comb_chunk

REVERB_LAGS = (1425, 1780, 1972, 2097, 1411, 1766, 1958, 2083)
REVERB_SIDES = (0, 0, 0, 0, 1, 1, 1, 1)


def _kernel(x, g, h, lags, side_of=None, c=None):
    side_of = tuple(range(len(lags))) if side_of is None else side_of
    c = c or comb_chunk(lags)
    y, d = comb_bank_pallas(x[None], g[None], jnp.asarray(h)[None],
                            lags, side_of, c, interpret=True)
    n = x.shape[1]
    return y[0, :, :n], d[0, :, :n]


def _scan(x, g, h, lags, side_of=None, c=None):
    side_of = tuple(range(len(lags))) if side_of is None else side_of
    c = c or comb_chunk(lags)
    y, d = _comb_bank_scan(x, lags, g, h, side_of, c)
    n = x.shape[1]
    return y[:, :n], d[:, :n]


def _oracle(x, g, h, lags, side_of):
    """Per-sample float64 comb recurrence (reverb.py:33-46 on the damped
    state): y[n] = x[n-L] + g*damped[n-L]; damped[n] = h*damped[n-1] +
    (1-h)*y[n]."""
    x = np.asarray(x, np.float64)
    n = x.shape[1]
    ys, ds = [], []
    for b, lag in enumerate(lags):
        src = x[side_of[b]]
        y = np.zeros(n)
        d = np.zeros(n)
        prev = 0.0
        for i in range(n):
            if i >= lag:
                y[i] = src[i - lag] + float(g[b]) * d[i - lag]
            prev = h * prev + (1.0 - h) * y[i]
            d[i] = prev
        ys.append(y)
        ds.append(d)
    return np.stack(ys), np.stack(ds)


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def test_pallas_comb_matches_xla_interpret():
    rng = np.random.default_rng(0)
    lags = (1411, 1782, 1973, 2098)
    x = jnp.asarray((0.3 * rng.standard_normal((4, 12000))).astype(np.float32))
    g = jnp.asarray([0.9, 0.85, 0.8, 0.88], jnp.float32)
    h = jnp.float32(0.3)
    y_x, d_x = _scan(x, g, h, lags)
    y_p, d_p = _kernel(x, g, h, lags)
    assert _max_err(y_p, y_x) < 1e-5
    assert _max_err(d_p, d_x) < 1e-5


def test_pallas_comb_lag_equal_chunk_edge():
    """L == C exactly must read purely from the previous chunk."""
    lags = (256, 300, 420, 511)
    rng = np.random.default_rng(1)
    x = jnp.asarray((0.3 * rng.standard_normal((4, 2048))).astype(np.float32))
    g = jnp.asarray([0.5, 0.6, 0.7, 0.8], jnp.float32)
    h = jnp.float32(0.2)
    assert comb_chunk(lags) == 256
    y_x, _ = _scan(x, g, h, lags)
    y_p, _ = _kernel(x, g, h, lags)
    assert _max_err(y_p, y_x) < 1e-5


def test_pallas_comb_shared_sides():
    """The reverb's layout: 8 combs over 2 source sides (side_of map)
    against the identity map over explicitly repeated rows."""
    rng = np.random.default_rng(2)
    x2 = jnp.asarray((0.3 * rng.standard_normal((2, 9000))).astype(np.float32))
    g = jnp.asarray(np.linspace(0.5, 0.9, 8), jnp.float32)
    h = jnp.float32(0.25)
    y_ref, d_ref = _scan(jnp.repeat(x2, 4, axis=0), g, h, REVERB_LAGS)
    y_p, d_p = _kernel(x2, g, h, REVERB_LAGS, REVERB_SIDES)
    assert _max_err(y_p, y_ref) < 1e-5
    assert _max_err(d_p, d_ref) < 1e-5


def test_pallas_comb_sums_matches_fallback():
    """Batch rendering: the kernel wrapper under vmap folds the batch into
    the kernel's file axis; each file matches its own scan."""
    from aefs_tpu.ops.ringbuf import _comb_kernel

    rng = np.random.default_rng(3)
    xb = jnp.asarray((0.3 * rng.standard_normal((3, 2, 6000))).astype(np.float32))
    g = jnp.asarray(np.linspace(0.5, 0.9, 8), jnp.float32)
    h = jnp.asarray([0.1, 0.5, 0.8], jnp.float32)
    from aefs_tpu.ops.pallas import comb as comb_mod

    calls = []
    real = comb_mod.comb_bank_pallas

    def spy(x, g, h, *a, **k):
        calls.append(x.shape)
        return real(x, g, h, *a, **{**k, "interpret": True})

    comb_mod.comb_bank_pallas = spy
    try:
        one = _comb_kernel(REVERB_LAGS, REVERB_SIDES, comb_chunk(REVERB_LAGS))
        batched = jax.vmap(one, in_axes=(0, None, 0))
        y_b, d_b = batched(xb, g, h)
        jaxpr = str(jax.make_jaxpr(batched)(xb, g, h))
    finally:
        comb_mod.comb_bank_pallas = real
    assert calls[-1] == (3, 2, 6000)  # the batch rides the file axis
    assert jaxpr.count("pallas_call[") == 1  # one launch for the batch
    for i in range(3):
        y_x, d_x = _scan(xb[i], g, h[i], REVERB_LAGS, REVERB_SIDES)
        assert _max_err(y_b[i, :, :6000], y_x) < 1e-5
        assert _max_err(d_b[i, :, :6000], d_x) < 1e-5


@pytest.mark.parametrize("n", [900, 1500, 2900])  # 1, 2, 3 chunks
def test_pallas_comb_sums_short_signal(n):
    """Signals of one to three chunks: the zero pre-signal history and
    the masked block tail."""
    rng = np.random.default_rng(4)
    lags = (1425, 1780, 1972, 2097)
    sides = (0, 0, 1, 1)
    x2 = jnp.asarray((0.3 * rng.standard_normal((2, n))).astype(np.float32))
    g = jnp.asarray([0.5, 0.6, 0.7, 0.8], jnp.float32)
    h = jnp.float32(0.3)
    y_x, d_x = _scan(x2, g, h, lags, sides)
    y_p, d_p = _kernel(x2, g, h, lags, sides)
    assert _max_err(y_p, y_x) < 1e-5
    assert _max_err(d_p, d_x) < 1e-5


@pytest.mark.parametrize("hval", [0.0, 0.05, 0.4, 0.9, 0.99])
def test_pallas_comb_sums_fir_damping(hval):
    """The in-chunk damping solve (row propagator + row carries) holds
    for every damping in the parameter range, h = 0 included."""
    rng = np.random.default_rng(5)
    x2 = jnp.asarray((0.3 * rng.standard_normal((2, 7000))).astype(np.float32))
    g = jnp.asarray(np.linspace(0.5, 0.9, 8), jnp.float32)
    h = jnp.float32(hval)
    y_x, d_x = _scan(x2, g, h, REVERB_LAGS, REVERB_SIDES)
    y_p, d_p = _kernel(x2, g, h, REVERB_LAGS, REVERB_SIDES)
    assert _max_err(y_p, y_x) < 1e-5
    assert _max_err(d_p, d_x) < 1e-5


@pytest.mark.parametrize("hval", [0.05, 0.6])
def test_comb_scan_matches_per_sample_oracle(hval):
    rng = np.random.default_rng(6)
    x2 = (0.3 * rng.standard_normal((2, 6000))).astype(np.float32)
    g = np.linspace(0.5, 0.9, 8).astype(np.float32)
    y_o, d_o = _oracle(x2, g, float(np.float32(hval)), REVERB_LAGS, REVERB_SIDES)
    y_x, d_x = comb_bank_file(jnp.asarray(x2), REVERB_LAGS, jnp.asarray(g),
                              jnp.float32(hval), side_of=REVERB_SIDES)
    assert _max_err(y_x, y_o) < 1e-5
    assert _max_err(d_x, d_o) < 1e-5


@pytest.mark.parametrize("c", [256, 1411, 2048, 2100])
def test_comb_block_geometry(c):
    blk, rows = block_geometry(c)
    assert blk >= c and blk & (blk - 1) == 0  # power of two holding C
    assert rows >= 16 and rows * 32 == blk  # Triton dot extent


def test_comb_chunk_rejects_wide_lag_span():
    assert comb_chunk(REVERB_LAGS) == 1411
    with pytest.raises(ValueError):
        comb_chunk((1000, 2000))


def test_comb_kernel_lowers_for_cuda():
    """The kernel lowers to a Triton custom call for the GPU at the
    demo file's real width (lowering only: there is no card here)."""
    c = comb_chunk(REVERB_LAGS)
    fn = lambda x, g, h: comb_bank_pallas(x, g, h, REVERB_LAGS, REVERB_SIDES, c)
    args = (
        jax.ShapeDtypeStruct((2, 2, 892800), jnp.float32),
        jax.ShapeDtypeStruct((2, 8), jnp.float32),
        jax.ShapeDtypeStruct((2,), jnp.float32),
    )
    text = jax.jit(fn).trace(*args).lower(lowering_platforms=("cuda",)).as_text()
    assert text.count("xla.gpu.triton") == 1
