"""Phaser: LFO-swept cascade of first-order allpass sections (new in
this build — completes the classic modulation trio next to the chorus
and tremolo; the reference has no swept-allpass effect).

Parallel decomposition: each allpass H(z) = (a + z^-1)/(1 + a z^-1) is the
recurrence y[n] = a[n] x[n] + x[n-1] - a[n] y[n-1] — a first-order
affine recurrence whose MULTIPLIER varies per sample, which is exactly
what the gate's hand-rolled Hillis scan already solves
(ops/scan.py:affine_hillis takes (..., N) mults).  Four sections run as
four batched scans per block; the LFO sweeps the allpass corner
exponentially between min_hz and max_hz with the same compensated
split-float32 phase pair as the chorus/tremolo (models/octaver.py:
_two_sum).  ``spread`` offsets the right channel's LFO in cycles.

Allpasses are norm-preserving, so float32 rounding passes through the
cascade unamplified: float64-oracle parity holds the full -80 bar
(tests/oracles.py:OraclePhaser).  mix=0 is exact passthrough; the
classic notch sound sits at mix=0.5.
"""

from __future__ import annotations

import jax.numpy as jnp

from aefs_tpu.core.params import ParamSpec
from aefs_tpu.models.base import EffectModel
from aefs_tpu.models.octaver import _two_sum
from aefs_tpu.ops.scan import affine_hillis

N_STAGES = 4


class Phaser(EffectModel):
    kind = "phaser"

    PARAMS = {
        "rate_hz": ParamSpec(0.5, 0.05, 10.0, smooth="mult", step=0.05),
        "min_hz": ParamSpec(200.0, 50.0, 2000.0, smooth="mult", step=0.1),
        "max_hz": ParamSpec(1600.0, 100.0, 8000.0, smooth="mult", step=0.1),
        "mix": ParamSpec(0.5, 0.0, 1.0, smooth="instant"),
        "spread": ParamSpec(0.25, 0.0, 0.5, smooth="instant"),
    }

    def init_state(self):
        return {
            "ph_hi": jnp.float32(0.0),
            "ph_lo": jnp.float32(0.0),
            # per-stage carried x[n-1] / y[n-1], per channel
            "xprev": jnp.zeros((self.channels, N_STAGES), jnp.float32),
            "yprev": jnp.zeros((self.channels, N_STAGES), jnp.float32),
        }

    def process(self, state, p, x):
        c, n = x.shape
        fs = jnp.float32(self.fs)
        dph = p["rate_hz"] / fs
        idx = jnp.arange(n, dtype=jnp.float32)
        ph = state["ph_hi"] + (state["ph_lo"] + idx * dph)
        ph_c = ph[None, :] + p["spread"] * jnp.arange(c, dtype=jnp.float32)[:, None]

        # Exponential corner sweep min..max (clamped so min <= max even
        # when a glide crosses them), allpass coefficient from tan.
        lo = jnp.minimum(p["min_hz"], p["max_hz"])
        hi = jnp.maximum(p["min_hz"], p["max_hz"])
        sweep = 0.5 * (1.0 + jnp.sin(2.0 * jnp.pi * ph_c))
        f = lo * jnp.power(hi / lo, sweep)
        t = jnp.tan(jnp.pi * f / fs)
        a = (t - 1.0) / (t + 1.0)  # in (-1, 0) for f < fs/4

        y = x
        xprev_out = []
        yprev_out = []
        for s in range(N_STAGES):
            xm1 = jnp.concatenate(
                [state["xprev"][:, s:s + 1], y[:, :-1]], axis=1
            )
            out = affine_hillis(-a, a * y + xm1,
                                state["yprev"][:, s:s + 1])
            xprev_out.append(y[:, -1])
            yprev_out.append(out[:, -1])
            y = out

        mixed = (1.0 - p["mix"]) * x + p["mix"] * y
        hi_, lo_ = _two_sum(state["ph_hi"],
                            state["ph_lo"] + jnp.float32(n) * dph)
        wrap = jnp.floor(hi_)
        return (
            {
                "ph_hi": hi_ - wrap,
                "ph_lo": lo_,
                "xprev": jnp.stack(xprev_out, axis=1),
                "yprev": jnp.stack(yprev_out, axis=1),
            },
            mixed,
        )
