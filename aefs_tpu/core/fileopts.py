"""File-mode static-override derivation.

File mode builds a fresh chain whose smoothed params start at their
targets, so per-effect statics can be baked from the config for the
whole-file fast path: the delay's lags (lag-affine residue scans instead
of fixed-point iteration), the octaver's pitch ratio (exact whole-octave
grid taps), and the parallel container's recursion flag.

Shared by the engine (top-level chains) and ParallelChains (branches).
"""

from __future__ import annotations


def file_static_overrides(effects_config):
    """-> {effect_id: {static kwargs}} for a chain-config list."""
    overrides = {}
    for i, cfg in enumerate(effects_config):
        params = cfg.get("params", {})
        eid = cfg.get("effect_id") or f"fx{i}"
        etype = cfg.get("type")
        if etype == "delay":
            # Clamp through the model's OWN ParamSpec bounds first: the
            # blockwise path's runtime params are the CLAMPED targets, so
            # a config value outside the box (delay_ms=1500 vs hi=1499)
            # would otherwise bake a file lag the streaming path never
            # uses — a 48-sample broadband lag split (the same failure
            # class as fuzz finding #4's truncation-boundary split).
            from aefs_tpu.models.delay import StereoDelay

            d = StereoDelay.PARAMS["delay_ms"].clamp(
                float(params.get("delay_ms", 375.0)))
            off = StereoDelay.PARAMS["offset_ms"].clamp(
                float(params.get("offset_ms", 30.0)))
            # A negative offset puts the RIGHT lag below delay_ms; the
            # blockwise solver's exactness bound must use the smaller lag.
            d_r = max(1.0, min(d + off, 1499.0))
            overrides[eid] = {
                "min_delay_ms": max(1.0, min(d, d_r, 1499.0)),
                "file_delay_ms": d,
                "file_offset_ms": off,
            }
        elif etype == "octaver":
            # Clamp through the ParamSpec like the delay's lags: the
            # streaming target is the clamped value, and an out-of-range
            # baked static would pick the grid taps from a ratio
            # the runtime never uses.
            from aefs_tpu.models.octaver import Octaver

            overrides[eid] = {
                "file_semitones": Octaver.PARAMS["semitones"].clamp(
                    float(params.get("semitones", -12.0))),
            }
        elif etype == "reverb":
            # file_mode lets the model validate the comb topology against
            # the whole-file chunk solver's C <= L < 2C constraint at
            # BUILD time (actionable error) instead of dying at trace
            # time deep inside ops/ringbuf.comb_bank_file.
            overrides[eid] = {"file_mode": True}
        elif etype in ("parallel", "multiband"):
            # multiband expands to a parallel container with the SAME
            # effect_id (core/multiband.py), so the flag lands on it.
            overrides[eid] = {"file_mode": True}
    return overrides
