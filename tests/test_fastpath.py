"""Whole-file fast path vs blockwise scan: identical waveforms.

The fast path replaces the per-superblock lax.scan with closed-form
whole-signal passes (delay -> lag-affine scan, reverb combs -> chunked
T_h-matmul solve, octaver -> two-level split phases).  Since the blockwise
path is oracle-verified, bit-near agreement here certifies the fast path.
"""

import numpy as np
import pytest

from aefs_tpu.core.chain import build_chain
from aefs_tpu.engine.engine import _file_static_overrides

from helpers import noise, bursts
from oracles import err_dbfs

FS = 48000

FIVE_FX = [
    {"effect_id": "g", "type": "gate",
     "params": {"threshold_db": -45, "attack_ms": 5, "release_ms": 100}},
    {"effect_id": "o", "type": "octaver", "params": {"semitones": -12, "mix": 0.4}},
    {"effect_id": "f", "type": "filter",
     "params": {"filter_type": 0, "cutoff_hz": 4000, "q": 0.8}},
    {"effect_id": "d", "type": "delay",
     "params": {"delay_ms": 375, "feedback": 0.2, "mix_dry": 1.0,
                "mix_wet": 0.6, "offset_ms": 10}},
    {"effect_id": "r", "type": "reverb",
     "params": {"rt60_s": 2.1, "damp": 0.05, "pre_delay_ms": 0,
                "mix_dry": 0.8, "mix_wet": 0.4}},
]


def run(cfgs, x, fast, blocksize=4096):
    chain, state, tmap = build_chain(
        cfgs, FS, blocksize, channels_in=x.shape[1],
        static_overrides=_file_static_overrides(cfgs),
    )
    _, out = chain.process_array(state, chain.targets(tmap), x, fast=fast)
    return out


@pytest.mark.parametrize("etype,params,tol", [
    ("delay", {"delay_ms": 375, "feedback": 0.5, "mix_dry": 1.0,
               "mix_wet": 1.0, "offset_ms": 25}, -80),
    ("delay", {"delay_ms": 55, "feedback": 0.7, "mix_dry": 0.6,
               "mix_wet": 0.9, "offset_ms": 0}, -80),
    ("delay", {"delay_ms": 375, "feedback": 0.3, "mix_dry": 0.8,
               "mix_wet": 0.8, "offset_ms": -120}, -80),
    # Out-of-box config values: blockwise clamps through ParamSpec
    # (delay_ms hi = 1499), so the file statics must clamp identically
    # or the baked lag splits from the streamed one by 48 samples.
    ("delay", {"delay_ms": 1500, "feedback": 0.4, "mix_dry": 1.0,
               "mix_wet": 1.0, "offset_ms": 0}, -80),
    ("reverb", {"rt60_s": 2.1, "damp": 0.05, "pre_delay_ms": 0,
                "mix_dry": 0.8, "mix_wet": 0.4}, -80),
    ("reverb", {"rt60_s": 6.0, "damp": 0.6, "pre_delay_ms": 40,
                "mix_dry": 0.5, "mix_wet": 0.7}, -80),
    # Whole-octave settings: the fast path is now EXACT (integer-grid
    # closed form, ops/gridtaps.py, -80 dBFS vs the float64 oracle —
    # test_gridtaps.py) while blockwise keeps the reference kernel's
    # float32 phase floor (-60 dBFS, test_effects_parity.py), so the
    # fast-vs-blockwise gap is bounded by that floor, not by the fast path.
    ("octaver", {"semitones": -12, "mix": 1.0}, -50),
    ("octaver", {"semitones": 7, "mix": 1.0}, -80),  # shared split-f32 phase
    ("gate", {"threshold_db": -40, "attack_ms": 5, "release_ms": 100}, -80),
    ("spectral", {"threshold_db": -45, "reduction": 0.2}, -80),
    ("convreverb", {"ir_seconds": 0.5, "mix_dry": 0.7, "mix_wet": 0.4}, -80),
    # Flanger file path (batched build + log-squared nilpotent solve,
    # models/flanger.py:process_file): tap positions/weights are the
    # same expressions; divergence is the blockwise TwoSum carry's
    # rounding x resonant gain + squared-product reassociation
    # (measured -132..-136 even at |fb| = 0.9 over 8 s).
    ("flanger", {"rate_hz": 1.3, "depth_ms": 3.0, "base_ms": 2.0,
                 "feedback": 0.8, "mix": 1.0, "spread": 0.25}, -80),
    ("flanger", {"rate_hz": 4.8, "depth_ms": 5.0, "base_ms": 1.0,
                 "feedback": -0.9, "mix": 0.7, "spread": 0.5}, -80),
])
def test_fast_matches_blockwise_per_effect(etype, params, tol):
    x = noise(12 * 4096, amp=0.25, seed=11)
    cfg = [{"effect_id": "e", "type": etype, "params": params}]
    slow = run(cfg, x, fast=False)
    fastv = run(cfg, x, fast=True)
    assert err_dbfs(slow, fastv) <= tol, err_dbfs(slow, fastv)


def test_fast_matches_blockwise_five_effect_chain():
    # Bound set by the blockwise octaver's float32 phase floor (see the
    # octaver rows above); the fast path itself is oracle-verified to
    # -80 dBFS in test_gridtaps.py / test_effects_parity.py.
    x = bursts(12 * 4096, amp=0.4, seed=3)
    slow = run(FIVE_FX, x, fast=False)
    fastv = run(FIVE_FX, x, fast=True)
    assert err_dbfs(slow, fastv) <= -50, err_dbfs(slow, fastv)


@pytest.mark.parametrize("ir_seconds,n_blocks", [
    (0.3, 12),    # IR shorter than the file: full spec_hist rebuild
    (2.5, 12),    # IR longer than the file (P-1 > k): zero-history rows
    (0.02, 12),   # IR shorter than ONE HOP (P == 1): empty spec_hist —
                  # regression: the rebuild stacked an empty frame list
                  # ("Need at least one array to stack", hit by short
                  # uploaded IRs through the set_ir e2e flow)
])
def test_convreverb_file_state_handoff(ir_seconds, n_blocks):
    """The whole-file conv path (convreverb.process_file) rebuilds the
    end-of-file state exactly: continuing BLOCKWISE from it must match a
    pure blockwise run of the concatenated signal."""
    from aefs_tpu.models.convreverb import ConvReverb

    hop = 4096
    eff = ConvReverb(FS, hop, channels=2, ir_seconds=ir_seconds)
    rng = np.random.default_rng(7)
    xa = np.asarray(
        0.3 * rng.standard_normal((2, n_blocks * hop)), np.float32)
    xb = np.asarray(0.3 * rng.standard_normal((2, 2 * hop)), np.float32)
    p = {"mix_dry": 0.7, "mix_wet": 0.4}

    st_fast, _ = eff.process_file(eff.init_state(), p, xa)
    _, y_cont = eff.process(st_fast, p, xb)

    st = eff.init_state()
    for j in range(n_blocks):
        st, _ = eff.process(st, p, xa[:, j * hop:(j + 1) * hop])
    _, y_ref = eff.process(st, p, xb)

    e = err_dbfs(np.asarray(y_cont).T, np.asarray(y_ref).T)
    assert e <= -80, e


def test_fast_path_short_file():
    """Files shorter than one superblock must still work."""
    x = noise(1000, amp=0.3, seed=4)
    fastv = run(FIVE_FX, x, fast=True)
    assert fastv.shape == (1000, 2)
    assert np.all(np.isfinite(fastv))


def test_reverb_bad_comb_topology_raises_at_build():
    """A comb topology the whole-file solver cannot chunk (max lag >=
    2*min lag) must fail at build_chain time with an actionable message
    naming comb_times_ms — not at trace time inside ops/ringbuf
    (Reverb.__init__ file_mode validation).  The same topology still
    builds for STREAMING, where the blockwise solver has no such
    constraint."""
    cfgs = [{"effect_id": "r", "type": "reverb",
             "params": {"rt60_s": 1.5, "comb_times_ms": (10.0, 25.0, 40.0, 55.0)}}]
    with pytest.raises(ValueError, match="comb_times_ms"):
        build_chain(cfgs, FS, 4096, channels_in=1,
                    static_overrides=_file_static_overrides(cfgs))
    # streaming build is fine
    chain, state, tmap = build_chain(cfgs, FS, 256, channels_in=1)
    _, y = chain.process_block(state, chain.targets(tmap),
                               np.zeros((1, 256), np.float32))
    assert np.asarray(y).shape == (2, 256)


def test_reverb_near_violating_topology_file_parity():
    """A custom topology close to the C <= L < 2C edge (max lag just
    under 2*min) must still match the float64 oracle through the
    whole-file fast path."""
    from oracles import OracleReverb, run_oracle_blocks

    comb_ms = (23.0, 28.0, 36.0, 45.0)  # 45 + j < 2*(23 - j): near the edge

    class EdgeOracle(OracleReverb):
        COMB_MS = comb_ms

    params = {"rt60_s": 2.0, "damp": 0.1, "pre_delay_ms": 5,
              "mix_dry": 0.7, "mix_wet": 0.5}
    cfgs = [{"effect_id": "r", "type": "reverb",
             "params": {**params, "comb_times_ms": comb_ms}}]
    x = noise(8 * 4096, amp=0.2)
    got = run(cfgs, x, fast=True)
    ref = run_oracle_blocks(EdgeOracle(FS, **params), x.astype(np.float64), 256)
    assert err_dbfs(got, ref) <= -80, err_dbfs(got, ref)


def test_file_damp_default_matches_param_spec():
    """A config that omits 'damp' glides/streams at the ParamSpec default,
    and the file path reads the same runtime target: a file render with
    'damp' omitted is bitwise the render at the spec default."""
    from aefs_tpu.models.reverb import Reverb

    spec = Reverb.PARAMS["damp"]
    base = {"rt60_s": 1.2, "pre_delay_ms": 0, "mix_dry": 0.7, "mix_wet": 0.5}
    x = noise(3 * 4096, amp=0.2)
    omitted = run([{"effect_id": "r", "type": "reverb", "params": base}],
                  x, fast=True)
    explicit = run([{"effect_id": "r", "type": "reverb",
                     "params": {**base, "damp": spec.clamp(spec.default)}}],
                   x, fast=True)
    assert np.array_equal(np.asarray(omitted), np.asarray(explicit))
