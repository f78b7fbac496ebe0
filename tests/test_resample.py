"""The octaver's 4-tap gather read vs a float64 Hermite reference, and
the octaver model vs its oracle."""

import numpy as np
import jax.numpy as jnp
import pytest

from aefs_tpu.ops.ringbuf import fractional_read_cubic
from aefs_tpu.core.chain import build_chain
from aefs_tpu.engine.engine import _file_static_overrides

from helpers import tones, noise
from oracles import OracleOctaver, _cubic, run_oracle_blocks, err_dbfs

FS = 48000
RNG = np.random.default_rng(21)


@pytest.mark.parametrize("step_scale", [-0.94, -0.5, 0.3, 0.9])
def test_gather_taps_match_hermite_reference(step_scale):
    """The 4-tap gather read against a float64 per-lane Hermite read of
    the same stream (non-wrap lanes; the wrap lanes are the shared patch,
    covered by the octaver oracle tests)."""
    size = 1920
    n = 1024
    hist = RNG.standard_normal(size).astype(np.float32) * 0.3
    x = RNG.standard_normal(n).astype(np.float32) * 0.3
    # phasor ramp like the octaver's: p = mod(p0 + i*step, 1), ago = p*size
    step = step_scale / size
    p = np.mod(0.37 + np.arange(n) * step, 1.0).astype(np.float32)
    ago = (p * size).astype(np.float32)

    got = np.asarray(fractional_read_cubic(jnp.asarray(hist), jnp.asarray(x), jnp.asarray(ago)))
    ext = np.concatenate([hist, x]).astype(np.float64)
    ca = np.ceil(ago.astype(np.float64)).astype(np.int64)
    frac = ca - ago.astype(np.float64)
    i0 = size + np.arange(n) - ca - 1
    bulk = (ca > 1) & (ca < size - 1)
    y0, y1, y2, y3 = (ext[np.clip(i0 + k, 0, ext.size - 1)] for k in range(4))
    ref = _cubic(frac, y0, y1, y2, y3)
    assert err_dbfs(got[bulk], ref[bulk]) <= -120, err_dbfs(got[bulk], ref[bulk])


def test_octaver_model_matches_oracle():
    params = {"semitones": -12, "mix": 1.0}
    x = tones(40 * 256, fs=FS)
    cfg = [{"effect_id": "o", "type": "octaver", "params": params}]
    chain, state, tmap = build_chain(cfg, FS, 256, channels_in=2)
    _, got = chain.process_array(state, chain.targets(tmap), x)
    ref = run_oracle_blocks(OracleOctaver(FS, **params), x.astype(np.float64), 256)
    assert err_dbfs(got, ref) <= -80, err_dbfs(got, ref)


@pytest.mark.parametrize("blocksize", [896, 768, 1792, 300])
def test_octaver_generic_stream_awkward_block_counts(blocksize):
    """The generic (live-semitone) octaver streamed at block sizes of
    7, 6 and 14 x 128 samples and a non-multiple: the full -80 dBFS bar
    against the oracle run at the same blocking."""
    params = {"semitones": 5.5, "mix": 0.8}
    x = tones(12 * blocksize, fs=FS)
    cfg = [{"effect_id": "o", "type": "octaver", "params": params}]
    chain, state, tmap = build_chain(cfg, FS, blocksize, channels_in=2)
    _, got = chain.process_array(state, chain.targets(tmap), x)
    oracle = OracleOctaver(FS, semitones=float(np.float32(5.5)), mix=0.8)
    ref = run_oracle_blocks(oracle, x.astype(np.float64), blocksize)
    assert err_dbfs(got, ref) <= -80, err_dbfs(got, ref)


@pytest.mark.parametrize("semi", [-24, -12, 7, 24])
def test_octaver_file_fast_with_baked_ratio(semi):
    params = {"semitones": semi, "mix": 1.0}
    cfg = [{"effect_id": "o", "type": "octaver", "params": params}]
    x = noise(12 * 4096, amp=0.25, seed=31)
    outs = {}
    for fast in (False, True):
        chain, state, tmap = build_chain(
            cfg, FS, 4096, channels_in=2,
            static_overrides=_file_static_overrides(cfg),
        )
        _, outs[fast] = chain.process_array(state, chain.targets(tmap), x, fast=fast)
    # Whole-octave semis route the fast path through the EXACT integer-grid
    # closed form (ops/gridtaps.py): fast-vs-blockwise is then bounded by
    # the blockwise float32 phase floor, and the tight bar is fast-vs-oracle
    # (-80 dBFS, test_gridtaps.py).  Non-octave semis share the split-f32
    # phase machinery on both paths and agree to -90 dBFS.
    # (blockwise drift grows with |1 - ratio| * t: ~-55 dB at +-12,
    # ~-46 dB at +-24 over this 1 s signal)
    pair_tol = -40 if semi % 12 == 0 else -90
    assert err_dbfs(outs[True], outs[False]) <= pair_tol, (
        err_dbfs(outs[True], outs[False]))

    # Oracle comparison over ~1 s accumulates float32-vs-float64 phase
    # drift proportional to |1 - ratio| * t on the split-f32 path; the
    # exact grid path holds the full -80 dBFS bar.
    oracle_tol = -80 if semi % 12 == 0 else -45
    ref = run_oracle_blocks(OracleOctaver(FS, **params), x.astype(np.float64), 4096)
    assert err_dbfs(outs[True], ref) <= oracle_tol, err_dbfs(outs[True], ref)
