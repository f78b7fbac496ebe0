"""Float64-oracle parity of the effects whose kernel or matmul precision
depends on the device, run on the GPU over 4 s of audio.

The GPU runs float32 products in TF32 unless told otherwise
(ops/precision.py) and the reverb's file path runs the Triton comb kernel
there (ops/pallas/comb.py): neither is visible on the CPU.  These tests
need the card; ``python chip_smoke.py`` runs them there, and here they
skip.
"""

import numpy as np
import pytest

FS = 48000
FRAMES = 192_000  # 4 s

CASES = {
    "reverb": ({"rt60_s": 2.1, "damp": 0.05, "pre_delay_ms": 0.0,
                "mix_dry": 0.8, "mix_wet": 0.4}, "noise"),
    "octaver": ({"semitones": 7.0, "mix": 1.0}, "tones"),
    "chorus": ({"rate_hz": 0.8, "depth_ms": 3.0, "base_ms": 12.0,
                "mix": 0.5, "spread": 0.25}, "tones"),
    "flanger": ({"rate_hz": 0.3, "depth_ms": 2.0, "base_ms": 2.5,
                 "feedback": 0.6, "mix": 0.5, "spread": 0.25}, "tones"),
    "convreverb": ({"mix_dry": 0.7, "mix_wet": 0.4}, "noise"),
}


def _oracle(kind, params, ir):
    import oracles

    if kind == "reverb":
        return oracles.OracleReverb(FS, **params)
    if kind == "octaver":
        return oracles.OracleOctaver(
            FS, **{**params, "semitones": float(np.float32(params["semitones"]))})
    if kind == "chorus":
        return oracles.OracleChorus(FS, **params)
    if kind == "flanger":
        return oracles.OracleFlanger(FS, **params)
    return oracles.OracleConvReverb(ir, **params)


def oracle_parity(kind, frames=FRAMES, device=None):
    """Peak error (dBFS) against the float64 oracle of ``kind`` in the
    streaming path (256-sample blocks) and the whole-file fast path,
    both run on ``device`` (default: JAX's default device).
    Returns {"stream": dB, "file": dB}."""
    import jax

    from aefs_tpu.core.chain import build_chain
    from aefs_tpu.core.fileopts import file_static_overrides
    from aefs_tpu.models import synthetic_ir

    import helpers
    from oracles import err_dbfs, run_oracle_blocks

    params, signal = CASES[kind]
    x = helpers.noise(frames, amp=0.2) if signal == "noise" else helpers.tones(frames, fs=FS)
    cfg = {"effect_id": "e", "type": kind, "params": params}
    ir = synthetic_ir(FS, 0.25, channels=2) if kind == "convreverb" else None
    extra = {"e": {"ir": ir}} if ir is not None else {}
    ref = run_oracle_blocks(_oracle(kind, params, ir), x.astype(np.float64), 256)

    errs = {}
    with jax.default_device(device or jax.devices()[0]):
        for mode, blocksize, fast in (("stream", 256, False), ("file", 4096, True)):
            static = file_static_overrides([cfg]) if fast else {}
            for eid, ov in extra.items():
                static[eid] = {**static.get(eid, {}), **ov}
            chain, state, tmap = build_chain(
                [cfg], FS, blocksize, channels_in=2, channels_out=2,
                static_overrides=static,
            )
            _, got = chain.process_array(state, chain.targets(tmap), x, fast=fast)
            chain.release()
            errs[mode] = float(err_dbfs(got, ref))
    return errs


@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(CASES))
def test_oracle_parity_on_card(gpu, kind):
    errs = oracle_parity(kind, device=gpu)
    assert max(errs.values()) <= -80, errs
