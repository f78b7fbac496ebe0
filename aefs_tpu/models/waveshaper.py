"""Waveshaper distortion (new effect, BASELINE.md config 3).

The reference's only "distortion" is the hard clip applied after every wet
mix (delay.py:96, reverb.py:277, engine.py:104); this build exposes it as a
first-class effect with selectable transfer curves: hard clip, tanh, and a
normalized cubic soft clip.  Pure elementwise work; XLA fuses it into
whatever surrounds it.
"""

from __future__ import annotations

import jax.numpy as jnp

from aefs_tpu.core.params import ParamSpec
from aefs_tpu.models.base import EffectModel


class Waveshaper(EffectModel):
    kind = "waveshaper"

    PARAMS = {
        "drive": ParamSpec(4.0, 1.0, 100.0, smooth="mult", step=0.2),
        "shape": ParamSpec(1.0, 0.0, 2.0, smooth="step", step=1.0),
        "mix": ParamSpec(1.0, 0.0, 1.0, smooth="step", step=0.05),
        "out_gain": ParamSpec(1.0, 0.0, 2.0, smooth="step", step=0.05),
    }

    def process(self, state, p, x):
        u = p["drive"] * x
        hard = jnp.clip(u, -1.0, 1.0)
        soft = 1.5 * hard - 0.5 * hard * hard * hard  # maps +-1 -> +-1
        tanh = jnp.tanh(u)

        t = jnp.round(p["shape"]).astype(jnp.int32)
        wet = jnp.where(t == 0, hard, jnp.where(t == 1, tanh, soft))

        y = p["out_gain"] * (p["mix"] * wet + (1.0 - p["mix"]) * x)
        return state, jnp.clip(y, -1.0, 1.0)
