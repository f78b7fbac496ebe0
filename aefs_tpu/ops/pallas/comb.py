"""Pallas kernel (Triton route): whole-signal damped comb bank.

The reverb's file path solves, per comb b with static lag L_b,

    y[n]      = x[n - L_b] + g_b * damped[n - L_b]
    damped[n] = h * damped[n-1] + (1 - h) * y[n]

from fresh state (reverb.py:33-46 rewritten on the damped state).  The
signal is walked in chunks of C samples with C <= L_b < 2C, so chunk m
reads only chunks m-1 and m-2 and everything it reads is already final.

One program per (file, comb) walks the chunks in an in-kernel loop; the
plain-XLA form (ops/ringbuf.py:_comb_bank_scan) is a ``lax.scan`` with a
(C, C) propagator product per step.  Per chunk the program

1. loads the lag-shifted input and damped windows (the damped one from
   its own output, written by earlier iterations — a block barrier orders
   the store before the next load, which is volatile so no stale cached
   line is read);
2. solves the in-chunk damping as rows of W samples: one (R, W) x (W, W)
   product with the row propagator T[i, j] = h^(j-i), then the carry
   into each row as an (R, R) weighted sum of the row ends — the whole
   recurrence, for any h in [0, 1), in full f32 (IEEE dot, no TF32);
3. stores y and damped for the chunk.

The chunk is held in a power-of-two block of R * W lanes, masked to C.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from aefs_tpu.ops.precision import DOT_PRECISION

_W = 32  # row width of the in-chunk damping solve


def block_geometry(c: int):
    """(block, rows) for chunk size ``c``: a power-of-two block of at
    least 16 rows of ``_W`` lanes (the Triton dot's minimum extent)."""
    blk = max(16 * _W, pl.next_power_of_2(int(c)))
    return blk, blk // _W


def damping_tables(h, c: int):
    """Propagators of the in-chunk damping solve for damping ``h``
    (any shape; tables get h's shape as leading dims): T (W, W),
    hp (W,) = h^(j+1), K (R, R) = h^(W(r-1-s)) for s < r, hr (R,) = h^(W r).
    """
    _, r = block_geometry(c)
    h = jnp.asarray(h, jnp.float32)[..., None, None]
    i = jnp.arange(_W)[:, None]
    j = jnp.arange(_W)[None, :]
    t = jnp.where(j >= i, jnp.power(h, jnp.maximum(j - i, 0).astype(jnp.float32)), 0.0)
    hp = jnp.power(h[..., 0, :], jnp.arange(1, _W + 1, dtype=jnp.float32))
    rr = jnp.arange(r)[:, None]
    ss = jnp.arange(r)[None, :]
    k = jnp.where(
        ss < rr,
        jnp.power(h, (_W * jnp.maximum(rr - 1 - ss, 0)).astype(jnp.float32)),
        0.0,
    )
    hr = jnp.power(h[..., 0, :], (_W * jnp.arange(r)).astype(jnp.float32))
    return t, hp, k, hr


def _make_kernel(n_combs: int, c: int, m_chunks: int, interpret: bool):
    blk, r = block_geometry(c)
    pre = 2 * c  # zero history ahead of the signal in x and damped

    def kernel(lag_ref, side_ref, g_ref, h_ref, t_ref, hp_ref, k_ref, hr_ref, x_ref,
               y_ref, d_ref):
        p = pl.program_id(0)
        f = p // n_combs
        b = p % n_combs
        lag = lag_ref[b]
        side = side_ref[b]
        g = g_ref[f, b]
        h = h_ref[f]
        t = t_ref[f]
        hp = hp_ref[f]
        kk = k_ref[f]
        hr = hr_ref[f]

        lane = lax.broadcasted_iota(jnp.int32, (blk,), 0)
        live = lane < c
        flat = lax.broadcasted_iota(jnp.int32, (r, _W), 0) * _W + lax.broadcasted_iota(
            jnp.int32, (r, _W), 1
        )
        row_end = lax.broadcasted_iota(jnp.int32, (r, _W), 1) == _W - 1
        zeros = jnp.zeros((blk,), jnp.float32)
        for z in range(2):  # the pre-signal damped history is zero
            plgpu.store(d_ref.at[f, b, pl.ds(z * c, blk)], zeros, mask=live)
        if not interpret:
            plgpu.debug_barrier()

        def chunk(m, d_last):
            n0 = m * c
            src = pre + n0 - lag
            xs = plgpu.load(x_ref.at[f, side, pl.ds(src, blk)], mask=live, other=0.0)
            dr = plgpu.load(
                d_ref.at[f, b, pl.ds(src, blk)], mask=live, other=0.0,
                volatile=True,
            )
            y = xs + g * dr
            plgpu.store(y_ref.at[f, b, pl.ds(n0, blk)], y, mask=live)

            cin = ((1.0 - h) * y).reshape(r, _W)
            loc = pl.dot(cin, t, precision=DOT_PRECISION)
            ends = jnp.sum(jnp.where(row_end, loc, 0.0), axis=1)
            carry = jnp.sum(kk * ends[None, :], axis=1) + hr * d_last
            full = loc + carry[:, None] * hp[None, :]
            d_new = jnp.sum(jnp.where(flat == c - 1, full, 0.0))
            plgpu.store(
                d_ref.at[f, b, pl.ds(pre + n0, blk)], full.reshape(blk), mask=live
            )
            if not interpret:
                plgpu.debug_barrier()
            return d_new

        lax.fori_loop(0, m_chunks, chunk, jnp.float32(0.0))

    return kernel


@functools.partial(
    jax.jit, static_argnames=("lags", "side_of", "c", "interpret")
)
def comb_bank_pallas(x, g, h, lags: tuple, side_of: tuple, c: int,
                     interpret: bool = False):
    """Comb bank over F files at once.

    x: (F, S, N) raw source signals; comb b reads source ``side_of[b]`` at
    lag ``lags[b]``; g: (F, B) feedback gains; h: (F,) damping.
    Returns (y, damped), each (F, B, M*C) with M = ceil(N / C)."""
    f_n, _, n = x.shape
    b_n = len(lags)
    m = -(-n // c)
    blk, _ = block_geometry(c)
    pre = 2 * c
    # Zero history ahead, and room for a whole block past the last chunk.
    x_p = jnp.pad(x.astype(jnp.float32), ((0, 0), (0, 0), (pre, m * c - n + blk)))
    t, hp, k, hr = damping_tables(h, c)
    lag_arr = jnp.asarray(lags, jnp.int32)
    side_arr = jnp.asarray(side_of, jnp.int32)
    y, d = pl.pallas_call(
        _make_kernel(b_n, c, m, interpret),
        out_shape=(
            jax.ShapeDtypeStruct((f_n, b_n, m * c + blk), jnp.float32),
            jax.ShapeDtypeStruct((f_n, b_n, pre + m * c + blk), jnp.float32),
        ),
        grid=(f_n * b_n,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="comb_bank",
    )(lag_arr, side_arr, jnp.asarray(g, jnp.float32),
      jnp.asarray(h, jnp.float32), t, hp, k, hr, x_p)
    return y[:, :, : m * c], d[:, :, pre : pre + m * c]
