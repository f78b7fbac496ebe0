"""Golden-waveform parity: each effect vs its float64 NumPy oracle.

The acceptance bar is <= -80 dBFS peak error (BASELINE.json) for EVERY
effect, octaver included: its phase ramp is a pure function of the
absolute sample index (base-4096 digit decomposition) driven by an
on-device double-single 2^(s/12) (models/octaver.py:ds_exp2_div12), so
any semitone value — on or off the UI grid — measures ~-97 dBFS
length-independently, and block decompositions are BITWISE identical.
Oracles mirror the f32 quantization of param VALUES the effects actually
receive (e.g. semitones=f32(11.73)), not just smoother coefficients.
"""

import numpy as np
import pytest

from aefs_tpu.core.chain import build_chain
from aefs_tpu.models import synthetic_ir

from helpers import noise, tones, bursts
from oracles import (
    OracleStereoDelay,
    OracleReverb,
    OracleBiquad,
    OracleCompressor,
    OracleGate,
    OracleOctaver,
    OracleSpectral,
    OracleWaveshaper,
    OracleBitcrusher,
    OracleChorus,
    OracleFlanger,
    OracleLimiter,
    OracleRingMod,
    OracleStereoWidth,
    OracleWah,
    OracleConvReverb,
    OraclePhaser,
    OracleTremolo,
    run_oracle_blocks,
    err_dbfs,
)

FS = 48000
N = 256
FRAMES = 40 * N  # ~0.21 s


def run_chain(cfg, x, blocksize=N, static_overrides=None, fs=FS):
    chain, state, tmap = build_chain(
        [cfg], fs, blocksize, channels_in=x.shape[1], channels_out=2,
        static_overrides=static_overrides,
    )
    targets = chain.targets(tmap)
    _, out = chain.process_array(state, targets, x)
    return out


@pytest.mark.parametrize(
    "params",
    [
        {"delay_ms": 375, "feedback": 0.2, "mix_dry": 1.0, "mix_wet": 1.0, "offset_ms": 0},
        {"delay_ms": 100, "feedback": 0.6, "mix_dry": 0.7, "mix_wet": 0.5, "offset_ms": 30},
        {"delay_ms": 2, "feedback": 0.5, "mix_dry": 0.5, "mix_wet": 0.9, "offset_ms": 3},
        # negative offset: R earlier than L (reference wishlist todo:8)
        {"delay_ms": 375, "feedback": 0.3, "mix_dry": 0.8, "mix_wet": 0.8,
         "offset_ms": -120},
        # clamps at the 1 ms min delay
        {"delay_ms": 50, "feedback": 0.4, "mix_dry": 0.7, "mix_wet": 0.8,
         "offset_ms": -200},
    ],
)
def test_delay_parity(params):
    x = noise(FRAMES)
    got = run_chain({"effect_id": "d", "type": "delay", "params": params}, x)
    oracle = OracleStereoDelay(FS, **params)
    ref = run_oracle_blocks(oracle, x.astype(np.float64), N)
    assert err_dbfs(got, ref) <= -80, err_dbfs(got, ref)


@pytest.mark.parametrize(
    "params",
    [
        {"rt60_s": 2.1, "damp": 0.05, "pre_delay_ms": 0, "mix_dry": 0.8, "mix_wet": 0.4},
        {"rt60_s": 4.0, "damp": 0.2, "pre_delay_ms": 20, "mix_dry": 0.6, "mix_wet": 0.6},
        {"rt60_s": 0.5, "damp": 0.8, "pre_delay_ms": 97, "mix_dry": 0.7, "mix_wet": 0.5},
    ],
)
def test_reverb_parity(params):
    x = noise(FRAMES, amp=0.2)
    got = run_chain({"effect_id": "r", "type": "reverb", "params": params}, x)
    oracle = OracleReverb(FS, **params)
    ref = run_oracle_blocks(oracle, x.astype(np.float64), N)
    assert err_dbfs(got, ref) <= -80, err_dbfs(got, ref)


@pytest.mark.parametrize(
    "params",
    [
        {"filter_type": 0, "cutoff_hz": 1000, "q": 0.707},
        {"filter_type": 1, "cutoff_hz": 3500, "q": 0.9},
        {"filter_type": 2, "cutoff_hz": 800, "q": 0.8},
        # Full RBJ family (new in this build): peaking EQ + shelves,
        # boost and cut.  Low-cutoff points sit closer to the unit
        # circle, where the recurrence's own float32 floor passes -80
        # (e.g. peak cut at 250 Hz measures -77 with EXACT float64
        # coefficients — accumulation, not formulas); cases below carry
        # >= 9 dB of margin.
        {"filter_type": 3, "cutoff_hz": 1200, "q": 1.4, "gain_db": 9.0},
        {"filter_type": 3, "cutoff_hz": 800, "q": 0.8, "gain_db": -12.0},
        {"filter_type": 4, "cutoff_hz": 800, "q": 0.707, "gain_db": 6.0},
        {"filter_type": 5, "cutoff_hz": 6000, "q": 0.707, "gain_db": -9.0},
        # type 6: 2nd-order allpass (the LR4 multiband phase element)
        {"filter_type": 6, "cutoff_hz": 2500, "q": 0.707},
    ],
)
def test_filter_parity(params):
    x = tones(FRAMES, fs=FS)
    got = run_chain({"effect_id": "f", "type": "filter", "params": params}, x)
    oracle = OracleBiquad(FS, **params)
    ref = run_oracle_blocks(oracle, x.astype(np.float64), N)
    assert err_dbfs(got, ref) <= -80, err_dbfs(got, ref)


def test_filter_low_fs_nyquist_clamp():
    """cutoff_hz above the FILE's Nyquist (the engine rebuilds at the
    file's rate): unclamped RBJ flips sin(w0) negative -> alpha < 0 ->
    poles outside the unit circle — a legal 4.5 kHz shelf preset on an
    8 kHz WAV diverged to Inf.  The Nyquist clamp (models/biquad.py,
    mirrored in the oracle) keeps it finite at full parity."""
    fs = 8000
    for params in (
        {"filter_type": 5, "cutoff_hz": 4500, "q": 0.707, "gain_db": 6.0},
        {"filter_type": 0, "cutoff_hz": 6000, "q": 0.9},
    ):
        x = tones(FRAMES, fs=fs, freqs=(220.0, 950.0, 2400.0))
        got = run_chain({"effect_id": "f", "type": "filter",
                         "params": params}, x, fs=fs)
        assert np.all(np.isfinite(got))
        oracle = OracleBiquad(fs, **params)
        ref = run_oracle_blocks(oracle, x.astype(np.float64), N)
        assert err_dbfs(got, ref) <= -80, (params, err_dbfs(got, ref))


@pytest.mark.parametrize(
    "params",
    [
        {"threshold_db": -30, "attack_ms": 10, "release_ms": 100},
        {"threshold_db": -40, "attack_ms": 5, "release_ms": 200},
        {"threshold_db": -12, "attack_ms": 1, "release_ms": 10},
    ],
)
def test_gate_parity(params):
    x = bursts(FRAMES, fs=FS)
    got = run_chain({"effect_id": "g", "type": "gate", "params": params}, x)
    oracle = OracleGate(FS, **params)
    ref = run_oracle_blocks(oracle, x.astype(np.float64), N)
    assert err_dbfs(got, ref) <= -80, err_dbfs(got, ref)


@pytest.mark.parametrize(
    "params",
    [
        {"threshold_db": -24, "ratio": 4, "attack_ms": 10,
         "release_ms": 100, "knee_db": 6, "makeup_db": 0},
        {"threshold_db": -40, "ratio": 20, "attack_ms": 0.1,
         "release_ms": 10, "knee_db": 0, "makeup_db": 6},  # hard-knee limiter
        {"threshold_db": -12, "ratio": 1.5, "attack_ms": 200,
         "release_ms": 800, "knee_db": 24, "makeup_db": -6},  # glue
    ],
)
def test_compressor_parity(params):
    """New-in-this-build dynamics effect: (max, x)-semiring decay scan +
    affine smoother vs the float64 per-sample decoupled detector."""
    x = bursts(FRAMES, fs=FS)
    got = run_chain({"effect_id": "c", "type": "compressor", "params": params}, x)
    oracle = OracleCompressor(FS, **params)
    ref = run_oracle_blocks(oracle, x.astype(np.float64), N)
    assert err_dbfs(got, ref) <= -80, err_dbfs(got, ref)


@pytest.mark.parametrize(
    "params",
    [
        {"semitones": -12, "mix": 1.0},
        {"semitones": 7, "mix": 0.5},
        {"semitones": -24, "mix": 0.8},
        {"semitones": 4.5, "mix": 1.0},
        {"semitones": 4.98, "mix": 1.0},     # off-grid API value
        {"semitones": 11.73, "mix": 1.0},    # off-grid API value
        {"semitones": -3.1415, "mix": 0.7},  # off-grid API value
    ],
)
def test_octaver_parity(params):
    """GENERIC streaming path at ANY semitone value — grid or off-grid:
    the on-device double-single 2^(s/12) (models/octaver.py:ds_exp2_div12)
    matches the float64 ratio of the f32 param to ~2^-43 relative, so
    parity vs the float64 oracle meets the full -80 dBFS bar
    length-independently (measured ~-97 flat across 20 s segments; the
    round-3 off-grid waiver — f32 ratio, -60 dBFS to ~8 s — is closed).
    The oracle mirrors the f32 quantization of ``semitones``, the value
    the effect actually receives (CLAUDE.md oracle-mirror rule)."""
    x = tones(FRAMES, fs=FS)
    got = run_chain({"effect_id": "o", "type": "octaver", "params": params}, x)
    oracle = OracleOctaver(FS, **{**params,
                                  "semitones": float(np.float32(params["semitones"]))})
    ref = run_oracle_blocks(oracle, x.astype(np.float64), N)
    assert err_dbfs(got, ref) <= -80, err_dbfs(got, ref)


def test_octaver_parity_offgrid_length_independent():
    """The closed off-grid waiver, demonstrated at length: 10 s at an
    off-grid semitone value holds the -80 bar in EVERY 2.5 s segment (the
    old f32-ratio path drifted through -60 by ~8 s)."""
    params = {"semitones": 11.73, "mix": 1.0}
    frames = int(FS * 10) // N * N
    x = tones(frames, fs=FS)
    got = run_chain({"effect_id": "o", "type": "octaver", "params": params}, x)
    oracle = OracleOctaver(FS, semitones=float(np.float32(11.73)), mix=1.0)
    ref = run_oracle_blocks(oracle, x.astype(np.float64), N)
    g = np.asarray(got, np.float64)
    q = frames // 4
    for seg in range(4):
        e = err_dbfs(g[seg * q:(seg + 1) * q], ref[seg * q:(seg + 1) * q])
        assert e <= -80, (seg, e)


@pytest.mark.parametrize("semitones", [-12, -24, 12])
def test_octaver_parity_grid_streaming(semitones):
    """Whole-octave streaming with the exact integer-grid specialization
    (grid_semitones static) meets the full -80 dBFS bar in 256-sample
    blocks — the float32 phase floor is gone (ops/gridtaps.py:
    octaver_taps_pow2_stream; reference semantics octaver.py:17-82)."""
    params = {"semitones": semitones, "mix": 0.8}
    x = tones(FRAMES, fs=FS)
    got = run_chain(
        {"effect_id": "o", "type": "octaver", "params": params}, x,
        static_overrides={"o": {"grid_semitones": semitones}},
    )
    oracle = OracleOctaver(FS, **params)
    ref = run_oracle_blocks(oracle, x.astype(np.float64), N)
    assert err_dbfs(got, ref) <= -80, err_dbfs(got, ref)


@pytest.mark.parametrize(
    "params",
    [
        {"rate_hz": 0.8, "depth_ms": 3.0, "base_ms": 12.0,
         "mix": 0.5, "spread": 0.25},
        {"rate_hz": 5.0, "depth_ms": 5.0, "base_ms": 8.0,
         "mix": 1.0, "spread": 0.0},  # full-wet vibrato
        {"rate_hz": 0.2, "depth_ms": 8.0, "base_ms": 30.0,
         "mix": 0.7, "spread": 0.5},  # slow, wide, quadrature stereo
    ],
)
def test_chorus_parity(params):
    """New-in-this-build modulation effect (LFO fractional delay on the
    octaver's tap machinery + compensated split-f32 LFO phase): float64
    oracle parity on tonal program (measured -98..-109)."""
    x = tones(FRAMES, fs=FS)
    got = run_chain({"effect_id": "c", "type": "chorus", "params": params}, x)
    oracle = OracleChorus(FS, **params)
    ref = run_oracle_blocks(oracle, x.astype(np.float64), N)
    assert err_dbfs(got, ref) <= -80, err_dbfs(got, ref)


@pytest.mark.parametrize(
    "params",
    [
        {"rate_hz": 5.0, "depth": 0.5, "spread": 0.0},
        {"rate_hz": 0.3, "depth": 1.0, "spread": 0.5},  # auto-pan
        {"rate_hz": 17.0, "depth": 0.8, "spread": 0.25},
    ],
)
def test_tremolo_parity(params):
    """Amplitude LFO (new in this build): elementwise gain, compensated
    split-f32 phase carry — float64-oracle parity at the full -80 bar."""
    x = bursts(FRAMES, fs=FS)
    got = run_chain({"effect_id": "t", "type": "tremolo", "params": params}, x)
    oracle = OracleTremolo(FS, **params)
    ref = run_oracle_blocks(oracle, x.astype(np.float64), N)
    assert err_dbfs(got, ref) <= -80, err_dbfs(got, ref)


@pytest.mark.parametrize(
    "params",
    [
        {"rate_hz": 0.5, "min_hz": 200, "max_hz": 1600,
         "mix": 0.5, "spread": 0.25},
        {"rate_hz": 4.0, "min_hz": 80, "max_hz": 6000,
         "mix": 1.0, "spread": 0.0},
        {"rate_hz": 0.1, "min_hz": 500, "max_hz": 500,
         "mix": 0.7, "spread": 0.5},  # degenerate sweep (lo == hi)
    ],
)
def test_phaser_parity(params):
    """New-in-this-build swept-allpass cascade: four affine Hillis scans
    with per-sample multipliers vs the float64 per-sample oracle.
    Allpasses are norm-preserving so f32 rounding passes through the
    cascade unamplified — the full -80 bar holds."""
    x = tones(FRAMES, fs=FS)
    got = run_chain({"effect_id": "p", "type": "phaser", "params": params}, x)
    oracle = OraclePhaser(FS, **params)
    ref = run_oracle_blocks(oracle, x.astype(np.float64), N)
    assert err_dbfs(got, ref) <= -80, err_dbfs(got, ref)


@pytest.mark.parametrize(
    "params",
    [
        {"rate_hz": 0.3, "depth_ms": 2.0, "base_ms": 2.5,
         "feedback": 0.6, "mix": 0.5, "spread": 0.0},
        {"rate_hz": 2.0, "depth_ms": 4.0, "base_ms": 1.0,
         "feedback": -0.7, "mix": 1.0, "spread": 0.25},  # negative regen,
        # depth > base: the negative LFO half-cycle rides the 24-sample clamp
        {"rate_hz": 0.1, "depth_ms": 0.0, "base_ms": 8.0,
         "feedback": 0.7, "mix": 0.5, "spread": 0.5},  # static comb
    ],
)
def test_flanger_parity(params):
    """Feedback flanger (new in this build): the time-varying fractional
    -delay comb solved by exact nilpotent fixed-point sweeps vs the
    float64 per-sample recursion (models/flanger.py)."""
    x = tones(FRAMES, fs=FS)
    got = run_chain({"effect_id": "f", "type": "flanger", "params": params}, x)
    oracle = OracleFlanger(FS, **params)
    ref = run_oracle_blocks(oracle, x.astype(np.float64), N)
    assert err_dbfs(got, ref) <= -80, err_dbfs(got, ref)


@pytest.mark.parametrize(
    "params",
    [
        {"ceiling_db": -6.0, "release_ms": 80.0, "drive_db": 6.0,
         "lookahead_ms": 5.0},
        {"ceiling_db": -1.0, "release_ms": 10.0, "drive_db": 24.0,
         "lookahead_ms": 1.0},  # slammed into the ceiling
        {"ceiling_db": -12.0, "release_ms": 1000.0, "drive_db": 0.0,
         "lookahead_ms": 10.0},  # slow release, long look-ahead
    ],
)
def test_limiter_parity(params):
    """Look-ahead brickwall (new in this build): window-min floor +
    (min, affine) release scan + moving-average attack ramp vs the
    float64 per-sample recursion (measured -102..-119)."""
    x = bursts(FRAMES, fs=FS)
    got = run_chain({"effect_id": "l", "type": "limiter", "params": params}, x)
    oracle = OracleLimiter(FS, **params)
    ref = run_oracle_blocks(oracle, x.astype(np.float64), N)
    assert err_dbfs(got, ref) <= -80, err_dbfs(got, ref)
    # the brickwall holds to f32 rounding
    ceil_lin = 10.0 ** (params["ceiling_db"] / 20.0)
    assert float(np.max(np.abs(np.asarray(got)))) <= ceil_lin + 1e-6


@pytest.mark.parametrize(
    "params",
    [
        {"width": 1.5, "pan": 0.0},
        {"width": 0.0, "pan": -0.6},  # mono, left balance
        {"width": 2.0, "pan": 1.0},  # max wide, hard right
    ],
)
def test_stereowidth_parity(params):
    """Mid-side width/balance (new in this build): stateless elementwise
    math, float64-oracle parity at the full bar."""
    x = bursts(FRAMES, fs=FS)
    got = run_chain({"effect_id": "s", "type": "stereowidth",
                     "params": params}, x)
    oracle = OracleStereoWidth(FS, **params)
    ref = run_oracle_blocks(oracle, x.astype(np.float64), N)
    assert err_dbfs(got, ref) <= -80, err_dbfs(got, ref)


def test_stereowidth_unity_is_near_passthrough():
    x = bursts(2 * N, fs=FS)
    got = run_chain({"effect_id": "s", "type": "stereowidth",
                     "params": {"width": 1.0, "pan": 0.0}}, x)
    np.testing.assert_allclose(np.asarray(got), x, atol=1e-7)


def test_limiter_under_ceiling_is_transparent():
    """A signal fully under the ceiling passes at unity gain (to f32
    rounding of the W-point gain average)."""
    x = bursts(FRAMES, fs=FS) * 0.1
    got = run_chain({"effect_id": "l", "type": "limiter",
                     "params": {"ceiling_db": 0.0, "release_ms": 80.0,
                                "drive_db": 0.0, "lookahead_ms": 5.0}}, x)
    d = 1 + int(round(5.0 * FS / 1000.0))  # the look-ahead delay... window-1
    np.testing.assert_allclose(np.asarray(got)[d - 1:], x[: len(x) - d + 1],
                               atol=2e-7)


@pytest.mark.parametrize(
    "params",
    [
        {"rate_hz": 1.5, "min_hz": 350, "max_hz": 2200, "res": 3.0,
         "mix": 1.0, "mode": 0.0, "sens": 4.0, "env_ms": 30.0},
        # worst conditioning corner: low sweep floor x high Q
        {"rate_hz": 0.5, "min_hz": 100, "max_hz": 4000, "res": 8.0,
         "mix": 0.7, "mode": 0.0, "sens": 4.0, "env_ms": 30.0},
        # envelope auto-wah
        {"rate_hz": 3.0, "min_hz": 200, "max_hz": 2000, "res": 5.0,
         "mix": 1.0, "mode": 1.0, "sens": 8.0, "env_ms": 20.0},
        # LFO/envelope blend, fastest everything
        {"rate_hz": 8.0, "min_hz": 1000, "max_hz": 4000, "res": 0.5,
         "mix": 0.5, "mode": 0.5, "sens": 20.0, "env_ms": 5.0},
    ],
)
def test_wah_parity(params):
    """Swept SVF (new in this build): per-sample 2x2 matrix Hillis scan
    (ops/scan.py:mat2_affine_hillis) vs the float64 Chamberlin
    recursion — measured -82..-150 across the box, incl. the low-fc
    x high-Q conditioning corner and the envelope path on noise."""
    x = noise(FRAMES) if params["mode"] >= 1.0 else tones(FRAMES, fs=FS)
    got = run_chain({"effect_id": "w", "type": "wah", "params": params}, x)
    oracle = OracleWah(FS, **params)
    ref = run_oracle_blocks(oracle, x.astype(np.float64), N)
    assert err_dbfs(got, ref) <= -80, err_dbfs(got, ref)


def test_wah_low_fs_stability_clamp():
    """The engine renegotiates the chain to the FILE's sample rate, and
    at fs = 11025 a 4 kHz sweep top with res = 3 exceeds the SVF Jury
    bound (f^2 + 2f/Q = 4.5 > 4) — unclamped, the recurrence diverged
    to inf within one LFO cycle.  The f-clamp (models/wah.py) caps the
    sweep at the stability edge; the float64 oracle mirrors it, so
    parity holds at the full bar while output stays finite."""
    fs = 11025
    params = {"rate_hz": 2.0, "min_hz": 300.0, "max_hz": 4000.0,
              "res": 3.0, "mix": 1.0, "mode": 0.0}
    x = tones(FRAMES, fs=fs, freqs=(220.0, 980.0, 2900.0))
    got = run_chain({"effect_id": "w", "type": "wah", "params": params},
                    x, fs=fs)
    assert np.all(np.isfinite(got))
    oracle = OracleWah(fs, **params)
    ref = run_oracle_blocks(oracle, x.astype(np.float64), N)
    assert err_dbfs(got, ref) <= -80, err_dbfs(got, ref)


def test_flanger_bitwise_blocking_invariance():
    """Any block size is processed as the same 256-sample chunk sequence
    (models/flanger.py lax.scan), so 256-streaming and 4096-superblock
    dispatch execute identical op sequences — bitwise equal."""
    from aefs_tpu.core.chain import build_chain as _bc

    def run(cfg, x, blocksize):
        chain, state, tmap = _bc([cfg], FS, blocksize, channels_in=x.shape[1])
        _, out = chain.process_array(state, chain.targets(tmap), x)
        return np.asarray(out)

    x = noise(8 * 4096)  # noise: worst case for tap quantization
    cfg = {"effect_id": "f", "type": "flanger",
           "params": {"rate_hz": 1.3, "depth_ms": 3.0, "base_ms": 2.0,
                      "feedback": 0.8, "mix": 0.7, "spread": 0.25}}
    a = run(cfg, x, 256)
    b = run(cfg, x, 4096)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize(
    "params",
    [
        {"carrier_hz": 440.0, "mix": 1.0, "spread": 0.0},
        {"carrier_hz": 5000.0, "mix": 0.7, "spread": 0.25},  # top of range
        {"carrier_hz": 0.5, "mix": 0.5, "spread": 0.5},  # sub-audio wobble
    ],
)
def test_ringmod_parity(params):
    """Carrier multiplication (new in this build): exact uint32 modular
    phase — the f32 ramp a 5 kHz carrier would need loses ~2e-4 cycles
    per superblock, the integer ramp loses nothing (models/ringmod.py)."""
    x = bursts(FRAMES, fs=FS)
    got = run_chain({"effect_id": "r", "type": "ringmod", "params": params}, x)
    oracle = OracleRingMod(FS, **params)
    ref = run_oracle_blocks(oracle, x.astype(np.float64), N)
    assert err_dbfs(got, ref) <= -80, err_dbfs(got, ref)


@pytest.mark.parametrize(
    "params",
    [
        {"bits": 8.0, "rate_hz": 8000.0, "mix": 1.0},
        {"bits": 3.0, "rate_hz": 48000.0, "mix": 1.0},  # no decimation
        {"bits": 16.0, "rate_hz": 300.0, "mix": 0.6},  # deepest hold
        {"bits": 1.0, "rate_hz": 11025.0, "mix": 1.0},  # 1-bit + odd rate
    ],
)
def test_bitcrusher_parity(params):
    """Sample-and-hold on the exact uint32 decimation clock + power-of-2
    quantizer (models/bitcrusher.py): at integer bits both the trigger
    pattern and the rounding are bitwise shared with the f64 oracle."""
    x = bursts(FRAMES, fs=FS)
    got = run_chain({"effect_id": "b", "type": "bitcrusher", "params": params}, x)
    oracle = OracleBitcrusher(FS, **params)
    ref = run_oracle_blocks(oracle, x.astype(np.float64), N)
    assert err_dbfs(got, ref) <= -80, err_dbfs(got, ref)


def test_ringmod_bitcrusher_bitwise_blocking_invariance():
    """The integer-phase effects are BITWISE invariant to the dispatch
    split (stronger than the -80 bar): uint32 carries cannot round."""
    from aefs_tpu.core.chain import build_chain as _bc

    def run(cfg, x, blocksize):
        chain, state, tmap = _bc([cfg], FS, blocksize, channels_in=x.shape[1])
        _, out = chain.process_array(state, chain.targets(tmap), x)
        return np.asarray(out)

    x = bursts(8 * 4096, fs=FS)
    for cfg in (
        {"effect_id": "r", "type": "ringmod",
         "params": {"carrier_hz": 4321.0, "mix": 0.8, "spread": 0.25}},
        {"effect_id": "b", "type": "bitcrusher",
         "params": {"bits": 5.0, "rate_hz": 7351.0, "mix": 1.0}},
    ):
        a = run(cfg, x, 256)
        b = run(cfg, x, 4096)
        np.testing.assert_array_equal(a, b, err_msg=cfg["type"])


def test_tremolo_depth_zero_exact_passthrough():
    x = bursts(4 * N, fs=FS)
    got = run_chain({"effect_id": "t", "type": "tremolo",
                     "params": {"rate_hz": 8.0, "depth": 0.0, "spread": 0.3}}, x)
    np.testing.assert_array_equal(got[:, 0], x[:, 0])


def test_chorus_blocksize_invariance_and_passthrough():
    """256-sample streaming vs 4096-superblock on NOISE (worst case for
    the f32 absolute-delay quantization floor, ~1e-4 samples at the 50 ms
    reach): pinned at -55 (measured -65).  mix=0 is exact passthrough."""
    from aefs_tpu.core.chain import build_chain as _bc

    def run(cfg, x, blocksize, fast=False):
        chain, state, tmap = _bc([cfg], FS, blocksize,
                                 channels_in=x.shape[1])
        _, out = chain.process_array(state, chain.targets(tmap), x, fast=fast)
        chain.release()
        return out

    cfg = {"effect_id": "c", "type": "chorus",
           "params": {"rate_hz": 4.0, "depth_ms": 9.0, "base_ms": 20.0,
                      "mix": 1.0, "spread": 0.3}}
    x = bursts(8 * 4096, amp=0.3, seed=3)
    bw = run(cfg, x, 4096)
    st = run(cfg, x, 256)
    ft = run(cfg, x, 4096, fast=True)
    assert err_dbfs(bw, st) <= -55, err_dbfs(bw, st)
    assert err_dbfs(bw, ft) <= -55, err_dbfs(bw, ft)

    cfg0 = {"effect_id": "c", "type": "chorus",
            "params": {"rate_hz": 2.0, "depth_ms": 5.0, "base_ms": 10.0,
                       "mix": 0.0, "spread": 0.25}}
    y0 = run(cfg0, x[:2048], 256)
    np.testing.assert_array_equal(y0, x[:2048])


@pytest.mark.parametrize("semitones", [4.98, 7.0, -12.0, 3.5])
def test_octaver_generic_blocksize_invariance(semitones):
    """GENERIC path: 256-sample streaming vs 4096-superblock processing at
    mix=1.0 (worst case).  The phase is a pure function of the absolute
    sample index (models/octaver.py:_phase_ramp, base-4096 digit
    decomposition with exact 12-bit hi products), so any block
    decomposition produces BITWISE-identical phases — measured -inf
    (array_equal) on every value here; pinned at -100 to leave room for a
    future tap-path change that stays below the parity floor.  (The
    round-3 per-block carry differed between decompositions by a few
    ulp(1) and was pinned at -65.)"""
    params = {"semitones": semitones, "mix": 1.0}
    x = bursts(8 * 4096, amp=0.3, seed=0)
    outs = []
    for bs in (4096, 256):
        outs.append(run_chain(
            {"effect_id": "o", "type": "octaver", "params": params}, x,
            blocksize=bs,
        ))
    assert err_dbfs(outs[0], outs[1].astype(np.float64)) <= -100


@pytest.mark.parametrize("blocksize", [128, 512])
def test_octaver_grid_streaming_blocksize_invariance(blocksize):
    """The integer phase carry is exact, so different streaming block
    sizes produce identical audio (well under the -80 dBFS bar)."""
    params = {"semitones": -12, "mix": 1.0}
    x = tones(FRAMES, fs=FS)
    outs = []
    for bs in (N, blocksize):
        outs.append(run_chain(
            {"effect_id": "o", "type": "octaver", "params": params}, x,
            blocksize=bs,
            static_overrides={"o": {"grid_semitones": -12}},
        ))
    assert err_dbfs(outs[0], outs[1].astype(np.float64)) <= -80


@pytest.mark.parametrize(
    "params",
    [
        {"threshold_db": -45, "reduction": 0.2},
        {"threshold_db": -50, "reduction": 0.1},
        {"threshold_db": -20, "reduction": 0.7},
    ],
)
def test_spectral_parity(params):
    x = noise(FRAMES, amp=0.1) + tones(FRAMES, fs=FS, amp=0.2)
    x = x.astype(np.float32)
    got = run_chain({"effect_id": "s", "type": "spectral", "params": params}, x)
    oracle = OracleSpectral(FS, hop=N, **params)
    ref = run_oracle_blocks(oracle, x.astype(np.float64), N)
    assert err_dbfs(got, ref) <= -80, err_dbfs(got, ref)


@pytest.mark.parametrize(
    "params",
    [
        {"drive": 8.0, "shape": 1, "mix": 1.0, "out_gain": 0.7},
        {"drive": 20.0, "shape": 0, "mix": 0.8, "out_gain": 1.0},
        {"drive": 4.0, "shape": 2, "mix": 1.0, "out_gain": 1.0},
    ],
)
def test_waveshaper_parity(params):
    x = tones(FRAMES, fs=FS, amp=0.4)
    got = run_chain({"effect_id": "w", "type": "waveshaper", "params": params}, x)
    oracle = OracleWaveshaper(**params)
    ref = run_oracle_blocks(oracle, x.astype(np.float64), N)
    assert err_dbfs(got, ref) <= -80, err_dbfs(got, ref)


def test_convreverb_parity():
    ir = synthetic_ir(FS, 0.25, channels=2)
    x = noise(FRAMES, amp=0.2)
    got = run_chain(
        {"effect_id": "c", "type": "convreverb",
         "params": {"mix_dry": 0.7, "mix_wet": 0.4}},
        x,
        static_overrides={"convreverb": {"ir": ir}},
    )
    oracle = OracleConvReverb(ir, mix_dry=0.7, mix_wet=0.4)
    ref = run_oracle_blocks(oracle, x.astype(np.float64), N)
    assert err_dbfs(got, ref) <= -80, err_dbfs(got, ref)


def test_mono_input_fanout():
    """Mono->stereo duplication at the chain head (core.py:147-149)."""
    x = noise(FRAMES, channels=1)
    got = run_chain(
        {"effect_id": "f", "type": "filter",
         "params": {"filter_type": 0, "cutoff_hz": 2000, "q": 0.707}}, x)
    assert got.shape == (FRAMES, 2)
    assert np.allclose(got[:, 0], got[:, 1])


def test_octaver_f32_floor_is_the_reference_kernel_floor():
    """Formal bound for the blockwise octaver's -60 dBFS bar: the reference
    kernel itself accumulates its grain phasor in float32
    (pitch_shift_kernel_cubic is @njit(fastmath=True) over float32 state,
    octaver.py:17-82, :77-80).  Simulating EXACTLY the reference
    arithmetic with a float32 phasor against the float64 oracle measures
    ~-46 dBFS on this signal — WORSE than our -60 dBFS bar, because the
    framework's compensated split-float phasor (models/octaver.py)
    rounds once per block instead of once per sample.  -60 dBFS is
    therefore strictly below the reference kernel's own information floor,
    not an artifact of the port.  (The file-mode fast path escapes the
    floor entirely for whole-octave ratios via the exact integer grid —
    test_gridtaps.py holds it to -80 dBFS.)
    """
    params = {"semitones": -12, "mix": 1.0}
    x = tones(FRAMES, fs=FS)

    # Reference-style simulation: float32 phasor accumulation, float64 taps
    # (isolates the phase path, which dominates the error).
    class F32PhasorOctaver(OracleOctaver):
        def process(self, xb):
            size = self.size
            ratio = np.float32(2.0) ** (np.float32(self.p["semitones"]) / np.float32(12.0))
            step = (np.float32(1.0) - ratio) / np.float32(size)
            mix = self.p["mix"]
            mono = xb.mean(axis=1)
            wet = np.zeros(len(xb))
            ph = np.float32(self.phasor)
            for i in range(len(xb)):
                self.buf[self.w] = mono[i]
                p1 = float(ph)
                p2 = p1 + 0.5
                if p2 >= 1.0:
                    p2 -= 1.0
                samples = []
                for p in (p1, p2):
                    raw = self.w - p * size + size
                    fl = int(raw)
                    frac = raw - fl
                    taps = [self.buf[(fl + k) % size] for k in (-1, 0, 1, 2)]
                    samples.append(_cubic_local(frac, *taps))
                g1 = 0.5 * (1.0 - np.cos(2 * np.pi * p1))
                g2 = 0.5 * (1.0 - np.cos(2 * np.pi * p2))
                wet[i] = samples[0] * g1 + samples[1] * g2
                self.w = (self.w + 1) % size
                ph = np.float32(ph + step)  # the reference's f32 accumulate
                if ph >= 1.0:
                    ph = np.float32(ph - 1.0)
                elif ph < 0.0:
                    ph = np.float32(ph + 1.0)
            self.phasor = float(ph)
            return xb * (1.0 - mix) + wet[:, None] * mix

    def _cubic_local(frac, y0, y1, y2, y3):
        c0 = y1
        c1 = 0.5 * (y2 - y0)
        c2 = y0 - 2.5 * y1 + 2.0 * y2 - 0.5 * y3
        c3 = 0.5 * (y3 - y0) + 1.5 * (y1 - y2)
        return ((c3 * frac + c2) * frac + c1) * frac + c0

    ref64 = run_oracle_blocks(OracleOctaver(FS, **params), x.astype(np.float64), N)
    ref32 = run_oracle_blocks(F32PhasorOctaver(FS, **params), x.astype(np.float64), N)
    floor_db = err_dbfs(ref32, ref64)
    # The reference's own arithmetic sits in the same band our bar allows.
    assert -75 <= floor_db <= -40, floor_db

    got = run_chain({"effect_id": "o", "type": "octaver", "params": params}, x)
    ours_db = err_dbfs(got, ref64)
    assert ours_db <= -60, ours_db
    # and ours is strictly more accurate than the reference's own kernel
    assert ours_db < floor_db, (ours_db, floor_db)
