"""Feed-forward dynamic-range compressor (new in this build — the
reference's dynamics section has only the gate, gate.py:6-42; this
completes the dynamics family with the standard soft-knee design from
Giannoulis/Massberg/Reiss, "Digital Dynamic Range Compressor Design —
A Tutorial and Analysis", JAES 2012).

Parallel decomposition.  The textbook detector

    env[n] = env[n-1] + coef(|x|>env ? att : rel) * (|x[n]| - env[n-1])

branches on the RUNNING STATE, which breaks associativity (unlike the
gate, whose branch reduces to the input alone — gate.py rationale).  The
decoupled form splits it into two recurrences that are each associative
block scans:

    peak[n] = max(|x[n]|, rho * peak[n-1])        (max, x) semiring scan
    env[n]  = (1-att) * env[n-1] + att * peak[n]  affine scan

``maxtimes_hillis`` runs the decay stage entirely in the linear domain
(multiplication by the nonnegative release multiplier distributes over
max — no per-sample log/exp), and the smoother reuses the gate's affine
machinery.  The gain computer (soft-knee curve in dB, then 10^(g/20))
is branch-free elementwise arithmetic XLA fuses into the scans.

Parity: float64 per-sample oracle (tests/oracles.py:compressor_oracle)
at <= -80 dBFS, plus blocking invariance — both scans carry exact
scalar state across blocks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from aefs_tpu.core.params import ParamSpec
from aefs_tpu.models.base import EffectModel
from aefs_tpu.ops.scan import (
    affine_hillis,
    affine_scan_long,
    maxtimes_hillis,
    maxtimes_scan_long,
)

_ENV_FLOOR = 1e-10  # -200 dBFS: keeps log10 finite on silence


class Compressor(EffectModel):
    kind = "compressor"

    PARAMS = {
        "threshold_db": ParamSpec(-24.0, -60.0, 0.0, smooth="step", step=1.0),
        "ratio": ParamSpec(4.0, 1.0, 20.0, smooth="step", step=0.5),
        "attack_ms": ParamSpec(10.0, 0.1, 500.0, smooth="step", step=1.0),
        "release_ms": ParamSpec(100.0, 10.0, 1000.0, smooth="step", step=10.0),
        "knee_db": ParamSpec(6.0, 0.0, 24.0, smooth="step", step=1.0),
        "makeup_db": ParamSpec(0.0, -12.0, 24.0, smooth="step", step=0.5),
    }

    def init_state(self):
        return {"peak": jnp.float32(0.0), "env": jnp.float32(0.0)}

    def _coeff(self, time_ms):
        """1-pole coefficient 1 - exp(-2.2 / (t * fs)) — the same 10-90%
        rise-time convention as the gate (gate.py:63-69)."""
        t = jnp.maximum(1e-3, time_ms * 1e-3)
        return 1.0 - jnp.exp(-2.2 / (t * jnp.float32(self.fs)))

    def process(self, state, p, x):
        att = self._coeff(p["attack_ms"])
        rho = 1.0 - self._coeff(p["release_ms"])  # release multiplier

        level = jnp.max(jnp.abs(x), axis=0)  # stereo-linked peak
        long = x.shape[-1] >= 4096
        peak = (maxtimes_scan_long if long else maxtimes_hillis)(
            rho, level, state["peak"]
        )
        env = (affine_scan_long if long else affine_hillis)(
            1.0 - att, att * peak, state["env"]
        )

        # Soft-knee gain computer (Giannoulis eq. 4), branch-free:
        # overshoot o below -W/2 -> 0 dB; inside the knee -> quadratic
        # interpolation; above W/2 -> slope * o.
        o = 20.0 * jnp.log10(jnp.maximum(env, _ENV_FLOOR)) - p["threshold_db"]
        w = jnp.maximum(p["knee_db"], 1e-6)
        slope = 1.0 / jnp.maximum(p["ratio"], 1.0) - 1.0
        t = jnp.clip(o + 0.5 * w, 0.0, w)
        g_db = slope * (t * t / (2.0 * w) + jnp.maximum(o - 0.5 * w, 0.0))
        gain = jnp.power(10.0, (g_db + p["makeup_db"]) / 20.0)
        if long:
            # Materialize before the stereo broadcast (see gate.py) so XLA
            # does not duplicate the gain-computer chain per channel.
            gain = jax.lax.optimization_barrier(gain)

        return (
            {"peak": peak[-1], "env": env[-1]},
            x * gain[None, :].astype(x.dtype),
        )
