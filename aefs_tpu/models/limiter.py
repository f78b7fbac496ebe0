"""Look-ahead brickwall limiter (new in this build — completes the
dynamics family: gate, compressor, limiter; the reference's only
dynamics element is the gate, gate.py:6-42).

Classic three-stage look-ahead design, each stage a parallel device op:

1. **Window floor**: instantaneous gain target g_t[n] = min(1,
   ceiling/peak[n]) (peak = stereo-linked |x|), then the running min
   over the trailing W-sample window — log-doubling dilation
   (ops/scan.py:window_min_trailing), no per-sample loop.
2. **Release**: v[n] = min(u[n], a*v[n-1] + (1-a)*u[n]) — rise
   exponentially but never above the window floor.  The map
   y -> min(c, a*y + b) composes closed, so it Hillis-scans
   (ops/scan.py:minaffine_hillis), the (min, affine) sibling of the
   compressor's (max, x) semiring scan.
3. **Attack ramp**: a W-point moving average of v
   (ops/scan.py:window_sum_trailing — binary-disjoint chunk sums, NOT
   a drifting cumsum).  Because every averaged term is the min of a
   window CONTAINING the delayed sample's position, the smoothed gain
   never exceeds that sample's own ceiling/|x| — overshoot-free by
   construction, no hard clipper needed.

The output is x delayed by D = W-1 samples times the smoothed gain:
the limiter reacts D samples before the peak reaches the output —
that is the look-ahead.  ``lookahead_ms`` sets W and the delay-line
topology, so it is STATIC (rebuild on change, like the convreverb's
``ir_seconds``); ``drive_db`` pushes gain into the ceiling.

Parity: float64 per-sample oracle (tests/oracles.py:OracleLimiter)
<= -80 dBFS; signals fully under the ceiling pass at unity gain.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from aefs_tpu.core.params import ParamSpec
from aefs_tpu.models.base import EffectModel
from aefs_tpu.ops.scan import (
    minaffine_hillis,
    window_min_trailing,
    window_sum_trailing,
)


class Limiter(EffectModel):
    kind = "limiter"

    PARAMS = {
        "ceiling_db": ParamSpec(-1.0, -24.0, 0.0, smooth="step", step=0.25),
        "release_ms": ParamSpec(80.0, 10.0, 1000.0, smooth="mult", step=0.05),
        "drive_db": ParamSpec(0.0, -12.0, 24.0, smooth="step", step=0.25),
    }

    def __init__(self, fs, blocksize, channels=2, **config):
        super().__init__(fs, blocksize, channels, **config)
        la_ms = float(config.get("lookahead_ms", 5.0))
        self.window = max(int(round(la_ms * fs / 1000.0)), 1) + 1
        self.delay = self.window - 1

    def init_state(self):
        w = self.window
        return {
            "xh": jnp.zeros((self.channels, self.delay), jnp.float32),
            "vh": jnp.ones((w - 1,), jnp.float32),
            "g": jnp.float32(1.0),
        }

    def process(self, state, p, x):
        c, n = x.shape
        w = self.window
        gain_in = jnp.exp2(p["drive_db"] * jnp.float32(1.0 / 6.0206))
        ceiling = jnp.exp2(p["ceiling_db"] * jnp.float32(1.0 / 6.0206))

        xd = gain_in * x
        ext = jnp.concatenate([state["xh"], xd], axis=1)  # (C, D + N)
        peak = jnp.max(jnp.abs(ext), axis=0)  # stereo-linked, (D + N,)
        # gt over the history window is recomputed with the CURRENT
        # ceiling/drive each block (cheaper than carrying a gt ring, and
        # mid-glide it lets the gain react to the new ceiling across the
        # whole look-ahead); under constant params this is bit-identical
        # to a stored-gt design, which is what the oracle implements.
        gt = jnp.minimum(1.0, ceiling / jnp.maximum(peak, 1e-30))

        u = window_min_trailing(gt[None, :], w, n)[0]  # needs D = w-1 history

        a_r = jnp.exp(-1000.0 / (p["release_ms"] * jnp.float32(self.fs)))
        v = minaffine_hillis(a_r, (1.0 - a_r) * u, u, state["g"])

        vext = jnp.concatenate([state["vh"], v])  # (D + N,)
        g = window_sum_trailing(vext[None, :], w, n)[0] * (1.0 / w)
        if n >= 4096:
            # Materialize before the stereo broadcast (see gate.py) so XLA
            # does not duplicate the window-sum chain per channel.
            g = jax.lax.optimization_barrier(g)

        delayed = ext[:, :n] if self.delay else xd  # x delayed by D
        y = g[None, :] * delayed

        d = self.delay
        new_xh = ext[:, -d:] if d else state["xh"]
        new_vh = vext[-(w - 1):] if w > 1 else state["vh"]
        return {"xh": new_xh, "vh": new_vh, "g": v[-1]}, y
