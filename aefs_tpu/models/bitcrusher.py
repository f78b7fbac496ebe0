"""Bitcrusher: sample-rate reduction (sample-and-hold) + bit-depth
quantization (new in this build — the lo-fi family next to the
waveshaper's analog-style clipping).

Parallel decomposition (no per-sample loop):

- The decimation clock is the ring modulator's EXACT uint32 modular
  ramp (models/ringmod.py:phase_step_u32): sample n is "fresh" iff the
  ramp wrapped on the step into n, i.e. ``(acc + n*num) mod 2^32 <
  num``.  Integer carry across blocks -> the trigger pattern is
  bitwise independent of the dispatch split.
- Sample-and-hold is a LATCH: h[n] = fresh[n] ? q(x[n]) : h[n-1].
  That is the first-order affine recurrence h[n] = a[n]*h[n-1] + b[n]
  with a = 1-fresh in {0,1}, b = fresh*q(x) — solved by the gate's
  hand-rolled Hillis scan (ops/scan.py:affine_hillis), held value
  carried in state.  Because a is exactly 0 or 1 the scan is not just
  parity-close but EXACT: every product either zeroes or passes
  operands unchanged, so reassociation cannot round.
- q quantizes to ``levels = 2^(bits-1)`` steps: q(x) = round(x*L)/L.
  At integer ``bits`` L is a power of two, so x*L and the division are
  exact in f32 and the f64 oracle rounds the identical value — parity
  is bitwise there.  Mid-glide (fractional bits) the tie boundaries
  sit where f32 and f64 disagree by one level; the differential
  fuzzer's tolerance accounts for it (a one-level flip is 1/L).

``rate_hz`` is the target decimation rate (48 kHz = every sample fresh
= no decimation); ``bits`` = 16 leaves the signal at (beyond) input
precision; mix blends the crushed signal against dry.

Parity: float64 per-sample oracle (tests/oracles.py:OracleBitcrusher)
<= -80 dBFS at integer bits; mix=0 exact passthrough.
"""

from __future__ import annotations

import jax.numpy as jnp

from aefs_tpu.core.params import ParamSpec
from aefs_tpu.models.base import EffectModel
from aefs_tpu.models.ringmod import phase_step_u32
from aefs_tpu.ops.scan import affine_hillis


class Bitcrusher(EffectModel):
    kind = "bitcrusher"

    PARAMS = {
        "bits": ParamSpec(8.0, 1.0, 16.0, smooth="step", step=0.25),
        "rate_hz": ParamSpec(8000.0, 300.0, 48000.0, smooth="mult", step=0.05),
        "mix": ParamSpec(1.0, 0.0, 1.0, smooth="instant"),
    }

    def init_state(self):
        return {
            "acc": jnp.uint32(0),
            "held": jnp.zeros((self.channels,), jnp.float32),
        }

    def process(self, state, p, x):
        c, n = x.shape
        num = phase_step_u32(p["rate_hz"], self.fs)
        idx = jnp.arange(n, dtype=jnp.uint32)
        ramp = state["acc"] + idx * num
        fresh = (ramp < num).astype(jnp.float32)[None, :]  # (1, N)

        levels = jnp.exp2(p["bits"] - 1.0)
        q = jnp.round(x * levels) / levels

        held = affine_hillis(1.0 - fresh, fresh * q, state["held"][:, None])
        y = (1.0 - p["mix"]) * x + p["mix"] * held
        return (
            {"acc": state["acc"] + jnp.uint32(n) * num, "held": held[:, -1]},
            y,
        )
