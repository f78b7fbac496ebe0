"""Granular delay-line pitch shifter (parity target: reference octaver.py).

Two read taps driven by phasors offset 0.5 apart, Hann crossfade gains,
4-point Hermite interpolation (pitch_shift_kernel_cubic, octaver.py:17-82).

Parallel mapping: the phasor is affine per sample — p[n] = (p0 + n*step)
mod 1 — so the whole kernel collapses into one parallel gather +
interpolation (SURVEY.md §7).  The octaver writes *raw input* into its
ring, so there is no feedback recurrence at all.  The block-to-block phasor
carry uses a TwoSum-compensated accumulator to keep long-run drift at the
eps^2 level instead of a per-block eps random walk.
"""

from __future__ import annotations

import jax
import numpy as np
import jax.numpy as jnp

from aefs_tpu.core.params import ParamSpec
from aefs_tpu.models.base import EffectModel
from aefs_tpu.ops.ringbuf import fractional_read_cubic, ring_push


def _two_sum(a, b):
    """Error-free transform: a + b = s + e exactly (Knuth TwoSum).

    e = (a - a') + (b - b') with the VIRTUAL operands a' = s - b',
    b' = s - a.  (A scrambled pairing — (a - b') + (b - a') — looks
    plausible and passes casual tests, but its compensation term is
    rounding noise: the phasor carry then drifts ~eps/2 per block and
    256-sample streaming diverged from 4096-superblock processing at
    -37..-60 dBFS.  Caught by the random-topology fuzzer,
    tests/test_fuzz_topologies.py.)"""
    s = a + b
    bp = s - a
    e = (a - (s - bp)) + (b - bp)
    return s, e


# ---------------------------------------------------------------------------
# Double-single (hi + lo float32) scalar arithmetic.  Every helper below is
# branch-free and exact where stated, so it is safe inside jit/vmap.
# ---------------------------------------------------------------------------

def _split12(v):
    """Veltkamp split of an f32 into 12-bit-significand halves: products
    of two halves are EXACT in f32 (12 + 12 = 24 bits)."""
    c = v * jnp.float32(4097.0)
    hi = c - (c - v)
    return hi, v - hi


def _two_prod(a, b):
    """Error-free product: a * b = p + e exactly (Dekker, via _split12).
    Stays correct if XLA contracts any of the terms into FMAs — an FMA'd
    ``a*b - p`` IS the exact residual."""
    p = a * b
    ah, al = _split12(a)
    bh, bl = _split12(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _ds_add(ah, al, bh, bl):
    s, e = _two_sum(ah, bh)
    return _two_sum(s, e + (al + bl))


def _ds_mul(ah, al, bh, bl):
    p, e = _two_prod(ah, bh)
    return _two_sum(p, e + (ah * bl + al * bh))


# Degree-12 Taylor of 2^r = exp(r ln 2) on r in [-0.5, 0.5]: truncation
# ~(ln2/2)^13/13! = 2^-52 relative — below the double-single rounding
# floor.  Coefficients as (hi, lo) f32 pairs of the float64 values.
def _exp2_coeffs():
    import math

    out = []
    for j in range(13):
        c = math.log(2.0) ** j / math.factorial(j)
        hi = np.float32(c)
        out.append((hi, np.float32(c - float(hi))))
    return out


_EXP2_C = _exp2_coeffs()
_INV12_HI = np.float32(1.0 / 12.0)
_INV12_LO = np.float32(1.0 / 12.0 - float(_INV12_HI))

# semi_prev init: outside the legal [-24, 24] range, so the first block
# always re-anchors (an exact no-op at n_abs = 0).  A finite sentinel —
# NaN would trip the pool's finite-state checks.
_SEMI_SENTINEL = 1.0e9


def ds_exp2_div12(s):
    """Double-single 2^(s/12) for f32 semitones in [-24, 24]: hi + lo
    matches the float64 ratio to ~2^-43 relative — for EVERY value, not
    just the 0.5-semitone UI grid (the round-3 ratio table covered only
    97 grid entries; off-grid API values kept the plain f32 ratio whose
    ~2^-25 quantization drifted ~8e-12 phase/sample).  Range-reduce
    y = s/12 = k + r (k = round, |r| <= 0.5, exact by Sterbenz), Horner
    the Taylor series in double-single, scale by the exact 2^k."""
    p, e = _two_prod(s, jnp.float32(_INV12_HI))
    y_hi, y_lo = _two_sum(p, e + s * jnp.float32(_INV12_LO))
    k = jnp.round(y_hi)
    r_hi, r_lo = _two_sum(y_hi - k, y_lo)  # y_hi - k exact: |diff| <= 0.5
    th = jnp.float32(_EXP2_C[12][0]) + jnp.zeros_like(s)
    tl = jnp.float32(_EXP2_C[12][1]) + jnp.zeros_like(s)
    for j in range(11, -1, -1):
        th, tl = _ds_mul(th, tl, r_hi, r_lo)
        th, tl = _ds_add(th, tl, jnp.float32(_EXP2_C[j][0]),
                         jnp.float32(_EXP2_C[j][1]))
    scale = jnp.ldexp(jnp.float32(1.0), k.astype(jnp.int32))  # exact 2^k
    return th * scale, tl * scale


# ---------------------------------------------------------------------------
# Absolute-index phase evaluation.  phase(n) = mod(base + n*step, 1) is
# computed as a PURE FUNCTION of the absolute sample index n via a base-4096
# digit decomposition — so any block decomposition of the same stream
# produces BITWISE-identical phases (the round-3 carry accumulated per
# block, and a few ulp(1) roundings in mod(inner + base, 1) differed
# between block sizes: blocksize invariance was pinned at -65 dBFS).
#
# Exactness: each level's stride hi-part is 12-bit (Veltkamp), digits are
# < 4096, so every hi product is a <= 24-bit significand — exact in f32 —
# and its mod-1 residue is exactly representable.  All approximation rides
# in the lo terms (~2^-13-scale products) and ONE final ulp(1) rounding.
# ---------------------------------------------------------------------------

def _stride_levels(step_hi, step_lo):
    """((4096^l * step) mod 1) for l = 0, 1, 2 as renormalized DS pairs.
    The *4096 scalings are exact (power of two); mod-1 of an f32 < 2^24
    is exact."""
    def lift(h, l):
        rh = h * jnp.float32(4096.0)
        rh = rh - jnp.floor(rh)
        return _two_sum(rh, l * jnp.float32(4096.0))

    r1 = lift(step_hi, step_lo)
    r2 = lift(*r1)
    return ((step_hi, step_lo), r1, r2)


def _phase_accum(idx, strides, base_hi, base_lo):
    """Compensated (acc, err) of base + idx*step over the digit levels."""
    shape = jnp.shape(idx)
    acc = base_hi + jnp.zeros(shape, jnp.float32)
    err = base_lo + jnp.zeros(shape, jnp.float32)
    digits = (idx & 4095, (idx >> 12) & 4095, (idx >> 24) & 4095)
    for j, (rh, rl) in zip(digits, strides):
        a, b = _split12(rh)
        jf = j.astype(jnp.float32)
        t_exact = jnp.mod(jf * a, jnp.float32(1.0))  # exact (24-bit product)
        t_small = jf * b + jf * rl  # jf*b exact (12x12); jf*rl ~2^-40 round
        acc, e1 = _two_sum(acc, t_exact)
        acc, e2 = _two_sum(acc, t_small)
        err = err + (e1 + e2)
    return acc, err


def _phase_ramp(idx, strides, base_hi, base_lo):
    """f32 phases mod 1 for an int32 index array — one ulp(1) rounding."""
    acc, err = _phase_accum(idx, strides, base_hi, base_lo)
    return jnp.mod(jnp.mod(acc, jnp.float32(1.0)) + err, jnp.float32(1.0))


def _phase_fold(n_abs, strides, base_hi, base_lo):
    """DS base' = mod(base + n_abs*step, 1): re-anchors the phase origin
    when the step changes (live semitone glide) so the index restarts."""
    acc, err = _phase_accum(n_abs, strides, base_hi, base_lo)
    return _two_sum(jnp.mod(acc, jnp.float32(1.0)), err)


class Octaver(EffectModel):
    kind = "octaver"

    # Bounds/steps from OctaverEffect (octaver.py:87-88, :117-118).
    PARAMS = {
        "semitones": ParamSpec(-12.0, -24.0, 24.0, smooth="step", step=0.5),
        "mix": ParamSpec(0.5, 0.0, 1.0, smooth="step", step=0.05),
    }

    def __init__(self, fs, blocksize, channels=2, window_ms=40.0,
                 file_semitones=None, grid_semitones=None,
                 grid_phase_lock=False, **config):
        super().__init__(fs, blocksize, channels)
        # Grain window; minimum size guards tiny rates (octaver.py:106).
        self.size = max(int(fs * float(window_ms) / 1000.0), 16)
        # Whole-octave file mode: exact closed-form grid taps
        # (ops/gridtaps.py) — gather-free AND free of the float32
        # phase-accumulation floor (parity reaches -80 dBFS).
        from aefs_tpu.ops.gridtaps import pow2_exponent, pow2_geometry_ok

        e = pow2_exponent(file_semitones)
        self._pow2_e = e if e is not None and pow2_geometry_ok(self.size, e) else None
        # Whole-octave STREAMING specialization (opt-in static): the phase
        # is carried as an exact integer numerator and the taps evaluated
        # on the rational grid every block (ops/gridtaps.py:
        # octaver_taps_pow2_stream) — streaming parity reaches -80 dBFS
        # and the per-block tap cost drops to a few dynamic slices.  The
        # ``semitones`` target is baked; live semitone changes require a
        # rebuild (the engine's default interactive path therefore keeps
        # the runtime float phasor — CLAUDE.md live-param rule).
        from aefs_tpu.ops.gridtaps import pow2_stream_geometry_ok

        ge = pow2_exponent(grid_semitones)
        self._grid_e = (
            ge if ge is not None and pow2_stream_geometry_ok(self.size, ge, blocksize)
            else None
        )
        # Phase-locked grid (batched serving): the integer phase lives in a
        # shared "grid_phase" pseudo-param the DRIVER advances each block
        # (server/pool.py advances it host-side), instead of per-stream
        # state.  A batch-uniform phase keeps every tap slice start
        # unbatched under vmap — the 12x dynamic-slice lowering cliff
        # (ops/gridtaps.py:_slice1).  Absolute grain phase is inaudible,
        # so sessions joining a running pool at the shared phase match the
        # reference semantics from their own first block.
        self._phase_lock = bool(grid_phase_lock) and self._grid_e is not None
        if self._phase_lock:
            self.PARAMS = {
                **self.PARAMS,
                "grid_phase": ParamSpec(0.0, 0.0, float(2 ** 24)),
            }
        # The pitch ratio 2^(s/12) is computed on-device in double-single
        # (ds_exp2_div12) for EVERY semitone value — the round-3 design
        # used a 97-entry table covering only the 0.5-semitone UI grid and
        # fell back to the drifting f32 ratio off-grid (VERDICT r3 waiver,
        # now closed: off-grid parity meets the same length-independent
        # <= -80 dBFS bar as the grid).

    def grid_phase_advance(self, n=None):
        """(per-block advance, modulus) of the integer phase numerator —
        the recurrence a phase-locking driver must apply per block."""
        e = self._grid_e
        n = self.blocksize if n is None else int(n)
        if e < 0:
            d = 1 << (-e)
            return (n * (d - 1)) % (d * self.size), d * self.size
        r = 1 << e
        return (-n * (r - 1)) % self.size, self.size

    def init_state(self):
        if self._grid_e is not None:
            if self._phase_lock:  # phase arrives via the grid_phase param
                return {"hist": jnp.zeros((self.size,), jnp.float32)}
            return {
                "hist": jnp.zeros((self.size,), jnp.float32),
                "num": jnp.int32(0),
            }
        # Generic path: the phase is a pure function of the absolute
        # sample index since the last step change (_phase_ramp) — n_abs
        # counts samples since the anchor, (base_hi, base_lo) is the DS
        # phase at the anchor, semi_prev/step_* identify the anchored
        # step so a live semitone glide re-anchors exactly once.
        return {
            "hist": jnp.zeros((self.size,), jnp.float32),
            "n_abs": jnp.int32(0),
            "base_hi": jnp.float32(0.0),
            "base_lo": jnp.float32(0.0),
            "semi_prev": jnp.float32(_SEMI_SENTINEL),
            "step_hi": jnp.float32(0.0),
            "step_lo": jnp.float32(0.0),
        }

    def _process_grid(self, state, p, x):
        """Exact-grid streaming step (grid_semitones baked; only ``mix``
        stays live).  Phase carried as an integer numerator — no float
        accumulation anywhere on the tap path."""
        from aefs_tpu.ops.gridtaps import octaver_taps_pow2_stream

        mix = p["mix"]
        mono = jnp.mean(x, axis=0)  # octaver.py:126-128
        num0 = (
            p["grid_phase"].astype(jnp.int32) if self._phase_lock
            else state["num"]
        )
        s1, s2, p1, p2, num = octaver_taps_pow2_stream(
            state["hist"], mono, self._grid_e, num0
        )
        two_pi = jnp.float32(2.0 * jnp.pi)
        g1 = 0.5 * (1.0 - jnp.cos(two_pi * p1))  # octaver.py:66-67
        g2 = 0.5 * (1.0 - jnp.cos(two_pi * p2))
        wet = s1 * g1 + s2 * g2
        new_state = {"hist": ring_push(state["hist"], mono)}
        if not self._phase_lock:
            new_state["num"] = num
        y = x * (1.0 - mix) + wet[None, :] * mix
        return new_state, y

    def process(self, state, p, x):
        if self._grid_e is not None:
            return self._process_grid(state, p, x)
        size = self.size
        n = x.shape[-1]
        mix = p["mix"]

        mono = jnp.mean(x, axis=0)  # octaver.py:126-128

        # Double-single ratio for ANY semitone value (matches the float64
        # 2^(s/12) to ~2^-43 relative), then
        # step = (1 - ratio_hi - ratio_lo)/size in double-single:
        # d = 1 - ratio_hi exactly (TwoSum), the division remainder
        # recovered with an exact split product (1920*a_hi needs 12+11
        # mantissa bits), so step_hi + step_lo matches the float64 step to
        # ~2^-43 — the absolute-index evaluation below never accumulates it.
        ratio_hi, ratio_lo = ds_exp2_div12(p["semitones"])
        size_f = jnp.float32(size)
        d_hi, d_e = _two_sum(jnp.float32(1.0), -ratio_hi)
        num_lo = d_e - ratio_lo
        step_hi = d_hi / size_f
        a_hi, a_lo = _split12(step_hi)
        rem = (d_hi - a_hi * size_f) - a_lo * size_f
        step_lo = (rem + num_lo) / size_f

        # Phase as a pure function of the absolute sample index (see the
        # _phase_* block above): bitwise blocksize invariance for constant
        # semitones.  A step change (live glide) re-anchors the base via
        # an exact fold of the PREVIOUS step over n_abs; the periodic
        # 2^28 re-anchor bounds n_abs long before int32 overflow (~1.5 h
        # of 48 kHz audio between folds).  Invariance caveat past the
        # horizon: the fold fires at the first BLOCK BOUNDARY >= 2^28, so
        # decompositions whose boundaries differ there (e.g. whole-file
        # vs blockwise, or non-power-of-two blocks) re-anchor at
        # different indices and _phase_fold carries one ulp(1) rounding —
        # outputs past ~93 min are ulp-close, not bitwise.  Power-of-two
        # streaming blocksizes all divide 2^28 and stay mutually bitwise;
        # the bitwise claim (CLAUDE.md, test_fastpath) holds below the
        # horizon, which covers every realtime session and test length.
        strides = _stride_levels(step_hi, step_lo)
        refold = (p["semitones"] != state["semi_prev"]) | (
            state["n_abs"] >= jnp.int32(1 << 28)
        )
        prev = _stride_levels(state["step_hi"], state["step_lo"])
        fb_hi, fb_lo = _phase_fold(
            state["n_abs"], prev, state["base_hi"], state["base_lo"]
        )
        base_hi = jnp.where(refold, fb_hi, state["base_hi"])
        base_lo = jnp.where(refold, fb_lo, state["base_lo"])
        n0 = jnp.where(refold, jnp.int32(0), state["n_abs"])

        idx = n0 + jnp.arange(n, dtype=jnp.int32)
        p1 = _phase_ramp(idx, strides, base_hi, base_lo)
        p2 = jnp.mod(p1 + 0.5, 1.0)

        hist = state["hist"]
        s1 = fractional_read_cubic(hist, mono, p1 * size)
        s2 = fractional_read_cubic(hist, mono, p2 * size)

        two_pi = jnp.float32(2.0 * jnp.pi)
        g1 = 0.5 * (1.0 - jnp.cos(two_pi * p1))  # Hann crossfade (octaver.py:66-67)
        g2 = 0.5 * (1.0 - jnp.cos(two_pi * p2))
        wet = s1 * g1 + s2 * g2
        if n >= 4096:
            # Materialize before the stereo broadcast (see process_file) so
            # XLA does not duplicate the gain evals per channel.
            wet = jax.lax.optimization_barrier(wet)

        new_state = {
            "hist": ring_push(hist, mono),
            "n_abs": n0 + jnp.int32(n),
            "base_hi": base_hi,
            "base_lo": base_lo,
            "semi_prev": p["semitones"],
            "step_hi": step_hi,
            "step_lo": step_lo,
        }

        # Linear dry/wet blend preserving the dry stereo image
        # (octaver.py:143-150).
        y = x * (1.0 - mix) + wet[None, :] * mix
        return new_state, y

    def process_file(self, state, p, x):
        """Whole-file fast path.  At whole-octave baked ratios the taps are
        evaluated in closed form on the exact rational position grid
        (ops/gridtaps.py) — assumes the file-mode contract (fresh phase,
        params at their baked targets, models/base.py:54-63)."""
        if self._pow2_e is None:
            return self.process(state, p, x)
        from aefs_tpu.ops.gridtaps import octaver_taps_pow2

        e = self._pow2_e
        size = self.size
        n = x.shape[-1]
        mix = p["mix"]
        mono = jnp.mean(x, axis=0)  # octaver.py:126-128
        hist = state["hist"]

        s1, s2, p1, p2 = octaver_taps_pow2(hist, mono, e)
        del p1, p2  # gains below tile one exact period instead
        two_pi = jnp.float32(2.0 * jnp.pi)
        # The Hann crossfade gains are EXACTLY periodic on the pow-2 grid:
        # p1(n) = (n*(D-1) mod D*S)/(D*S) repeats with period D*S (e<0;
        # period S for e>0) and D-1 / R-1 are odd so gcd with the pow-2
        # modulus is 1 — the tiled values are bitwise the full-length ones
        # (same int32 residues -> same f32 quotients -> same cos).  One
        # period of cos + a tile copy replaces N transcendental evals.
        if e < 0:
            d = 1 << (-e)
            per = d * size
            r1p = jnp.mod(jnp.arange(per, dtype=jnp.int32) * (d - 1), per)
        else:
            per = size
            r1p = jnp.mod(
                -jnp.arange(per, dtype=jnp.int32) * ((1 << e) - 1), per
            )
        r2p = jnp.mod(r1p + per // 2, per)
        pf = jnp.float32(per)
        g1p = 0.5 * (1.0 - jnp.cos(two_pi * (r1p.astype(jnp.float32) / pf)))
        g2p = 0.5 * (1.0 - jnp.cos(two_pi * (r2p.astype(jnp.float32) / pf)))
        k_tiles = -(-n // per)
        g1 = jnp.tile(g1p, k_tiles)[:n]  # octaver.py:66-67
        g2 = jnp.tile(g2p, k_tiles)[:n]
        # Materialize wet before the stereo broadcast: without the barrier
        # XLA duplicates the whole tap+gain producer chain into each
        # consumer fusion of y; one (N,) write is cheaper.
        wet = jax.lax.optimization_barrier(s1 * g1 + s2 * g2)

        # Exact phase advance: p(n) = mod(n * (1 - 2^e) / size, 1) — an
        # exact rational, carried into the generic state as a host-computed
        # double-single base with the sentinel forcing a (no-op) re-anchor
        # if a generic block ever continues from this state.
        if e < 0:
            d = 1 << (-e)
            ph = (n * (d - 1)) % (d * size) / (d * size)
        else:
            ph = (-n * ((1 << e) - 1)) % size / size
        ph_hi = np.float32(ph)
        new_state = {
            "hist": ring_push(hist, mono),
            "n_abs": jnp.int32(0),
            "base_hi": jnp.float32(ph_hi),
            "base_lo": jnp.float32(ph - float(ph_hi)),
            "semi_prev": jnp.float32(_SEMI_SENTINEL),
            "step_hi": jnp.float32(0.0),
            "step_lo": jnp.float32(0.0),
        }
        y = x * (1.0 - mix) + wet[None, :] * mix
        return new_state, y
