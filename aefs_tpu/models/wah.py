"""Wah / auto-wah: resonant state-variable filter whose center frequency
is swept per-sample by an LFO and/or the input envelope (new in this
build — the classic pedal family; the biquad is the static-coefficient
filter, the phaser the norm-preserving allpass sweep; this is the
MODULATED resonator).

Parallel decomposition — a swept filter's recurrence has a DIFFERENT matrix
at every sample, so neither the biquad's constant-companion scan nor
its whole-file Toeplitz solve (both LTI-only) apply.  The Chamberlin
SVF state s = (low, band) advances as

    s[n] = M[n] @ s[n-1] + (0, f[n]*x[n]),
    M[n] = [[1, f], [-f, 1 - f^2 - f/Q]][n],   f = 2 sin(pi*fc/fs),

a first-order vector recurrence solved by the per-sample 2x2 Hillis
scan (ops/scan.py:mat2_affine_hillis) — log2(N) levels of eight FMAs,
fully parallel, any block size.  Stability: det M = 1 - f/Q in (0,1)
and |tr| < 1 + det reduces to f^2 + 2f/Q < 4 — true over the whole
param box at fs = 48 kHz (max ~2.3 at fc=4 kHz, Q=0.5) but NOT at low
file sample rates (11025 Hz puts the sweep top past the bound), so f
is clamped to 95% of the bound's positive root sqrt(1/Q^2+4) - 1/Q.

The sweep position blends two sources branchlessly:
``mode`` 0 = LFO (TwoSum-carried phase, the tremolo's machinery),
1 = envelope follower (one-pole smoother on |x|, the gate's
affine_hillis), in between = a weighted blend.  fc then moves
log-linearly between min_hz and max_hz, like the phaser's sweep.
Output is the resonance-normalized bandpass band/Q, mixed against dry.

Numerics: the scan's rounding is governed by the resonator's own
conditioning ~eps/(1-r)^2 with r = sqrt(1 - f/Q) — worst at LOW fc and
HIGH Q, exactly like the biquad's near-unit poles (CLAUDE.md); the
fuzzer's chain_tolerance derives the wah allowance from the drawn
(min_hz, res).  Parity: float64 per-sample oracle
(tests/oracles.py:OracleWah) <= -80 dBFS across the default sweep box.
"""

from __future__ import annotations

import jax.numpy as jnp

from aefs_tpu.core.params import ParamSpec
from aefs_tpu.models.base import EffectModel
from aefs_tpu.models.octaver import _two_sum
from aefs_tpu.ops.scan import affine_hillis, mat2_affine_hillis


class Wah(EffectModel):
    kind = "wah"

    PARAMS = {
        "rate_hz": ParamSpec(1.5, 0.05, 8.0, smooth="mult", step=0.05),
        "min_hz": ParamSpec(350.0, 100.0, 1000.0, smooth="mult", step=0.05),
        "max_hz": ParamSpec(2200.0, 300.0, 4000.0, smooth="mult", step=0.05),
        "res": ParamSpec(3.0, 0.5, 8.0, smooth="step", step=0.1),
        "mix": ParamSpec(1.0, 0.0, 1.0, smooth="instant"),
        "mode": ParamSpec(0.0, 0.0, 1.0, smooth="instant"),
        "sens": ParamSpec(4.0, 0.5, 20.0, smooth="step", step=0.25),
        "env_ms": ParamSpec(30.0, 5.0, 200.0, smooth="mult", step=0.05),
    }

    def init_state(self):
        return {
            "low": jnp.zeros((self.channels,), jnp.float32),
            "band": jnp.zeros((self.channels,), jnp.float32),
            "env": jnp.float32(0.0),
            "ph_hi": jnp.float32(0.0),
            "ph_lo": jnp.float32(0.0),
        }

    def process(self, state, p, x):
        c, n = x.shape
        fs = jnp.float32(self.fs)
        dph = p["rate_hz"] / fs

        idx = jnp.arange(n, dtype=jnp.float32)
        ph = state["ph_hi"] + (state["ph_lo"] + idx * dph)
        lfo_sweep = 0.5 * (1.0 + jnp.sin(2.0 * jnp.pi * ph))

        mono = jnp.mean(jnp.abs(x), axis=0)
        a_e = jnp.exp(-1000.0 / (p["env_ms"] * fs))
        env = affine_hillis(a_e, (1.0 - a_e) * mono, state["env"])
        env_sweep = jnp.clip(p["sens"] * env, 0.0, 1.0)

        sweep = (1.0 - p["mode"]) * lfo_sweep + p["mode"] * env_sweep
        lo_hz = jnp.minimum(p["min_hz"], p["max_hz"])
        hi_hz = jnp.maximum(p["min_hz"], p["max_hz"])
        fc = lo_hz * (hi_hz / lo_hz) ** sweep
        q1 = 1.0 / p["res"]
        f = 2.0 * jnp.sin(jnp.pi * fc / fs)  # (N,)
        # Stability clamp: the Jury bound for M is f^2 + 2*f*q1 < 4
        # (negative-trace case; the docstring's margin claim only holds
        # at fs = 48 kHz).  The engine renegotiates the chain to the
        # FILE's rate, and e.g. fs = 11025 with max_hz = 4000, res = 3
        # puts the sweep top at f = 1.81 where f^2 + 2f/Q = 4.5 — the
        # recurrence diverges every LFO cycle.  Clamp f to 95% of the
        # bound's positive root (sweeps cap at the stability edge
        # instead of blowing up; inactive over the whole param box at
        # fs >= 24 kHz, so 48 kHz parity is untouched).  Mirrored in
        # tests/oracles.py:OracleWah.
        f = jnp.minimum(f, 0.95 * (jnp.sqrt(q1 * q1 + 4.0) - q1))

        mp = jnp.ones((1, n), jnp.float32)
        mq = f[None, :]
        mr = -f[None, :]
        ms = (1.0 - f * f - f * q1)[None, :]
        bu = jnp.zeros_like(x)
        bv = f[None, :] * x
        low, band = mat2_affine_hillis(
            mp, mq, mr, ms, bu, bv,
            state["low"][:, None], state["band"][:, None],
        )

        y = (1.0 - p["mix"]) * x + p["mix"] * (q1 * band)

        hi, lo = _two_sum(state["ph_hi"],
                          state["ph_lo"] + jnp.float32(n) * dph)
        wrap = jnp.floor(hi)
        return (
            {"low": low[:, -1], "band": band[:, -1], "env": env[-1],
             "ph_hi": hi - wrap, "ph_lo": lo},
            y,
        )
