"""Ring modulator: carrier multiplication (new in this build — the
reference has no carrier-based effects; this extends the modulation
family the tremolo/chorus/phaser opened).

Carrier phase is EXACT: audio-rate carriers (up to 5 kHz) advance the
phase ~0.1 cycles/sample, so a float32 ramp ``idx * dph`` loses ~2e-4
cycles by the end of a 4096-sample superblock — audible against a -80
dBFS oracle.  Instead the phase rides a uint32 modular accumulator:
``num = round(f/fs * 2^32)`` phase units per sample, per-sample phase
``(acc + n*num) mod 2^32`` (integer wraparound IS the mod), converted
to cycles only at the sin.  Integer arithmetic makes the carry across
blocks exact, so blocking invariance is BITWISE at any split — stronger
than the TwoSum carry the LFO effects use (their rates are low enough
that a compensated f32 pair suffices; a 5 kHz carrier's is not).
Frequency quantization is 2^-32 cycles/sample ~ 11 uHz; the float32
conversion of the phase keeps 24 bits ~ 6e-8 cycles — both orders of
magnitude below the parity bar.

``spread`` offsets the right channel's carrier phase in cycles (0.25 =
quadrature stereo shimmer); mix=0 is exact passthrough.

Parity: float64 per-sample oracle (tests/oracles.py:OracleRingMod,
mirroring the f32 ``num`` quantization) <= -80 dBFS.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from aefs_tpu.core.params import ParamSpec
from aefs_tpu.models.base import EffectModel

# np.float32, NOT jnp.float32: a module-level jnp scalar dispatches a
# device op at IMPORT time, which initializes the JAX backend the moment
# anything imports aefs_tpu, which claims the GPU's memory before the
# caller has chosen a platform.  Inside jit the two are numerically
# identical f32 constants.
_PHASE_SCALE = np.float32(2.0**32)
_INV_PHASE = np.float32(2.0**-32)


def phase_step_u32(freq_hz, fs):
    """Quantize a frequency to uint32 phase units/sample:
    round(f32(f) * f32(2^32 / fs)).

    The scale is ONE host-side f64 division rounded to f32 (fs is
    static), so the only on-device ops are an f32 multiply and a round —
    both correctly rounded on every XLA backend.  An on-device f32
    division is NOT: XLA CPU codegens it via a Newton-refined reciprocal
    that lands 1 ulp low for some quotients (measured: 8000/44100 jitted
    = 0x3e39c277 vs the IEEE 0x3e39c278), which would make the decimation
    clock backend-dependent.  Clamped to the largest float32 BELOW 2^32
    (= 2^32 - 256): at f == fs the product rounds to exactly 2^32, whose
    uint32 conversion is backend-defined.  The clamp costs one phase unit
    in 2^24 of rate accuracy at the very top of the range and keeps every
    backend (and the float64 oracles, which mirror this quantization)
    bitwise agreed.
    """
    scale = jnp.float32(2.0**32 / float(fs))
    return jnp.minimum(
        jnp.round(freq_hz * scale),
        jnp.float32(2.0**32 - 256.0),
    ).astype(jnp.uint32)


def phase_ramp_cycles(acc, num, n):
    """(acc + arange(n)*num) mod 2^32, in cycles — exact modular ramp."""
    idx = jnp.arange(n, dtype=jnp.uint32)
    return (acc + idx * num).astype(jnp.float32) * _INV_PHASE


class RingMod(EffectModel):
    kind = "ringmod"

    PARAMS = {
        "carrier_hz": ParamSpec(440.0, 0.5, 5000.0, smooth="mult", step=0.05),
        "mix": ParamSpec(1.0, 0.0, 1.0, smooth="instant"),
        "spread": ParamSpec(0.0, 0.0, 0.5, smooth="instant"),
    }

    def init_state(self):
        return {"acc": jnp.uint32(0)}

    def process(self, state, p, x):
        c, n = x.shape
        num = phase_step_u32(p["carrier_hz"], self.fs)
        ph = phase_ramp_cycles(state["acc"], num, n)
        ph_c = ph[None, :] + p["spread"] * jnp.arange(c, dtype=jnp.float32)[:, None]
        carrier = jnp.sin(2.0 * jnp.pi * ph_c)
        y = (1.0 - p["mix"]) * x + p["mix"] * (x * carrier)
        return {"acc": state["acc"] + jnp.uint32(n) * num}, y
