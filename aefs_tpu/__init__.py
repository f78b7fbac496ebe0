"""aefs_tpu — a device-native (JAX/XLA/Pallas) audio-effects framework.

A from-scratch rebuild of the capabilities of the reference
audio-effects-simulator (SURVEY.md) designed accelerator-first:

- Effects are pure functions over explicit state pytrees
  (reference: mutable ``Effect.process_into`` OO contract, core.py:81-86).
- Per-sample recurrences (biquad, comb, allpass, gate smoothing) are recast
  as blocked associative scans / fixed-point block solvers instead of the
  reference's per-sample Numba loops (delay.py:7, filter.py:9, gate.py:7,
  reverb.py:12-67, octaver.py:18).
- Ring buffers use a chronological layout (newest-last) so block reads are
  gathers/slices and writes are a single concat — no modular scatter.
- The whole chain compiles to one XLA program per (blocksize, fs, topology);
  file mode runs a ``lax.scan`` over superblocks on-device.

Public API mirrors the reference package surface
(src/audioblocks/__init__.py:1-8) in functional form.
"""

from aefs_tpu.core.params import ParamSpec, smooth_step
from aefs_tpu.core.chain import Chain, build_chain
from aefs_tpu.core.config import (
    SAMPLE_RATE,
    BLOCKSIZE,
    CHANNELS_IN,
    CHANNELS_OUT,
    EFFECT_DEFAULTS,
    DEFAULT_PRESETS,
)
from aefs_tpu.models import EFFECT_REGISTRY

__version__ = "0.1.0"

__all__ = [
    "ParamSpec",
    "smooth_step",
    "Chain",
    "build_chain",
    "SAMPLE_RATE",
    "BLOCKSIZE",
    "CHANNELS_IN",
    "CHANNELS_OUT",
    "EFFECT_DEFAULTS",
    "DEFAULT_PRESETS",
    "EFFECT_REGISTRY",
]
