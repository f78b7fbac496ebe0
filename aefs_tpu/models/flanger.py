"""Flanger with FEEDBACK: LFO-swept fractional-delay comb whose output
recirculates into the delay line (new in this build — the chorus covers
the feed-forward "Jet Flanger" sound; regeneration is what makes the
resonant jet).  No reference counterpart; the delay-line/tap semantics
follow the chorus (models/chorus.py) and the reference's echo recursion
shape (delay.py:7-22) with a time-varying lag.

Definition (per channel):
    d[n]  = clip((base_ms + depth_ms*sin(2*pi*ph[n])) * fs/1000, 24, Hmax)
    v[n]  = x[n] + feedback * s[n]          (delay-line signal)
    s[n]  = cubic tap of v at distance d[n]  (fractional_read_cubic)
    y[n]  = (1-mix) * x[n] + mix * s[n]

Parallel decomposition — the recursion is through a tap at least D_MIN=24
samples in the past, so over a 256-sample chunk the within-chunk part
of the read operator T is NILPOTENT: each application reaches at least
D_MIN-2 = 22 samples further back (the cubic kernel reads 2 above its
floor).  The implicit equation v = x + fb*T(v) is therefore solved
EXACTLY by ceil(256/22) = 12 fixed-point sweeps v <- x + fb*T(v) —
a Neumann series that terminates, not an approximation.  Chunks run
under a lax.scan carrying (hist, LFO TwoSum pair); any block size is
processed as 256-sample chunks, so 256-sample streaming and
4096-superblock file processing execute the SAME op sequence and agree
bitwise (tests assert array_equal, stronger than the -80 bar).

The d >= 24-sample clamp (0.5 ms at 48 kHz) is what bounds the sweep
count; it is also the musical floor of the base_ms range, so only a
depth_ms > base_ms draw ever hits it (the negative half-cycle of the
LFO then sits at the clamp, exactly as the oracle does).

Perf: the tap operator is materialized ONCE per chunk as a dense
one-hot cubic-weight matrix and each sweep is one matrix contraction
instead of a gather with per-batch starts; dense sweeps amortize the
sequential N/D_MIN dependency chain (the physics of a half-millisecond
feedback path).  A further lever if ever needed: collapse the 12
sweeps to log2(12) matrix squarings of (I - fb*T_c)^-1
(sum A^k = prod (I + A^(2^j))).

Parity: float64 per-sample oracle (tests/oracles.py:OracleFlanger)
<= -80 dBFS on tonal program at |feedback| <= 0.7; the comb's resonant
gain 1/(1-|fb|) scales the f32 floor, covered in the fuzzer's
chain_tolerance.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from aefs_tpu.core.params import ParamSpec
from aefs_tpu.models.base import EffectModel
from aefs_tpu.models.octaver import _two_sum
from aefs_tpu.ops.precision import DOT_PRECISION
from aefs_tpu.ops.ringbuf import (
    cubic_onehot_matrix,
    cubic_tap_weights,
    onehot_matrix,
)

MAX_BASE_MS = 10.0
MAX_DEPTH_MS = 5.0
D_MIN = 24.0     # samples; bounds the nilpotency degree
_CHUNK = 256
_SWEEPS = 12     # ceil(_CHUNK / (D_MIN - 2))
_FILE_BATCH = 8  # chunks whose operators build/square per file scan step


def _ds_phase(i, dph, hi0, lo0):
    """Double-single LFO phase ramp hi+lo ~= hi0+lo0 + i*dph, hi in [0,1).

    The file path's parallel replacement for the streaming TwoSum CARRY:
    i (< 2^24, so exact in f32) and dph are Veltkamp-split so all four
    partial products are exact f32, then TwoSum-accumulated — the pair is
    accurate to ~2^-45 cycles at any file position, below the streaming
    carry's own ~ulp/chunk rounding drift, so fast-vs-blockwise phase
    divergence is bounded by the BLOCKWISE path's documented floor."""
    s = dph * 4097.0                      # Veltkamp split: 12+12 bits
    d_hi = s - (s - dph)
    d_lo = dph - d_hi
    i_hi = jnp.floor(i * (1.0 / 4096.0)) * 4096.0  # exact pow-2 scalings
    i_lo = i - i_hi
    hi, e1 = _two_sum(i_hi * d_hi, i_hi * d_lo)    # each product exact
    hi, e2 = _two_sum(hi, i_lo * d_hi)
    lo = e1 + e2 + i_lo * d_lo
    hi, e3 = _two_sum(hi, hi0)
    lo = lo + (e3 + lo0)
    wrap = jnp.floor(hi)                  # exact; phase only feeds sin(2*pi*.)
    return hi - wrap, lo


class Flanger(EffectModel):
    kind = "flanger"

    PARAMS = {
        "rate_hz": ParamSpec(0.3, 0.05, 5.0, smooth="mult", step=0.05),
        "depth_ms": ParamSpec(2.0, 0.0, MAX_DEPTH_MS, smooth="step", step=0.1),
        "base_ms": ParamSpec(2.5, 0.5, MAX_BASE_MS, smooth="step", step=0.25),
        "feedback": ParamSpec(0.6, -0.9, 0.9, smooth="step", step=0.02),
        "mix": ParamSpec(0.5, 0.0, 1.0, smooth="instant"),
        "spread": ParamSpec(0.0, 0.0, 0.5, smooth="instant"),
    }

    def __init__(self, fs, blocksize, channels=2, **config):
        super().__init__(fs, blocksize, channels, **config)
        self.hist_len = int((MAX_BASE_MS + MAX_DEPTH_MS) * fs / 1000.0) + 8

    def init_state(self):
        return {
            "hist": jnp.zeros((self.channels, self.hist_len), jnp.float32),
            "ph_hi": jnp.float32(0.0),
            "ph_lo": jnp.float32(0.0),
        }

    def process(self, state, p, x):
        c, n = x.shape
        fs = jnp.float32(self.fs)
        dph = p["rate_hz"] / fs
        chan = jnp.arange(c, dtype=jnp.float32)[:, None]
        fb = p["feedback"]
        hmax = jnp.float32(self.hist_len - 2)

        pad = (-n) % _CHUNK
        xp = jnp.pad(x, ((0, 0), (0, pad))) if pad else x
        m = xp.shape[1] // _CHUNK
        xs = xp.reshape(c, m, _CHUNK).transpose(1, 0, 2)  # (m, C, CHUNK)

        ext_len = self.hist_len + _CHUNK

        def step(carry, xc):
            hist, hi, lo = carry
            idx = jnp.arange(_CHUNK, dtype=jnp.float32)
            ph = hi + (lo + idx * dph)
            ph_c = ph[None, :] + p["spread"] * chan
            delay_ms = p["base_ms"] + p["depth_ms"] * jnp.sin(
                2.0 * jnp.pi * ph_c
            )
            d = jnp.clip(delay_ms * (fs / 1000.0), D_MIN, hmax)

            # The tap operator is SWEEP-INVARIANT (d is fixed for the
            # chunk), so build it once as a dense (C, CHUNK, ext) weight
            # matrix — four one-hot int comparisons carrying the cubic
            # Hermite tap weights — and every sweep becomes one small
            # matrix contraction instead of the gather form (vmapped
            # dynamic_slice with per-batch starts, fractional_read_cubic),
            # which repeats the gather on every sweep.
            # No wrap patch needed: d in [24, hist-2] keeps all four
            # taps strictly inside ext.
            ca = jnp.ceil(d).astype(jnp.int32)  # (C, CHUNK)
            fr = (jnp.ceil(d) - d).astype(jnp.float32)
            base = self.hist_len + jnp.arange(_CHUNK, dtype=jnp.int32)
            weights = cubic_onehot_matrix(
                base[None, :] - ca - 1, fr, ext_len)
            # Split the operator at the history boundary: the history
            # half contracts ONCE (it never changes across sweeps); the
            # sweeps iterate only the strictly-lower in-chunk quarter.
            w_h = weights[:, :, : self.hist_len]
            w_c = weights[:, :, self.hist_len:]
            th = jnp.einsum("cns,cs->cn", w_h, hist, precision=DOT_PRECISION)
            b = xc + fb * th

            v = jnp.zeros_like(xc)
            for _ in range(_SWEEPS):  # exact: T_c is nilpotent on the chunk
                v = b + fb * jnp.einsum("cns,cs->cn", w_c, v,
                                        precision=DOT_PRECISION)
            tap = th + jnp.einsum("cns,cs->cn", w_c, v, precision=DOT_PRECISION)
            y = (1.0 - p["mix"]) * xc + p["mix"] * tap

            new_hist = jnp.concatenate([hist, v], axis=1)[:, -self.hist_len:]
            nhi, nlo = _two_sum(hi, lo + jnp.float32(_CHUNK) * dph)
            wrap = jnp.floor(nhi)
            return (new_hist, nhi - wrap, nlo), (y, v)

        carry0 = (state["hist"], state["ph_hi"], state["ph_lo"])
        (hist_f, hi_f, lo_f), (ys, vs) = lax.scan(step, carry0, xs)
        return self._finish(state, dph, pad, n, c, m * _CHUNK, ys, vs,
                            hist_f, hi_f, lo_f)

    def _finish(self, state, dph, pad, n, c, total, ys, vs,
                hist_f, hi_f, lo_f):
        """Unpad the scan outputs and (when padded) rebuild the true carry
        from the unpadded delay-line signal and sample count."""
        y = ys.transpose(1, 0, 2).reshape(c, total)[:, :n]

        if pad:
            # The scan's carry saw `pad` trailing zeros: rebuild the true
            # state from the unpadded delay-line signal and sample count.
            v = vs.transpose(1, 0, 2).reshape(c, total)[:, :n]
            hist_f = jnp.concatenate(
                [state["hist"], v], axis=1
            )[:, -self.hist_len:]
            hi_f, lo_f = _two_sum(
                state["ph_hi"], state["ph_lo"] + jnp.float32(n) * dph
            )
            wrap = jnp.floor(hi_f)
            hi_f = hi_f - wrap
        return {"hist": hist_f, "ph_hi": hi_f, "ph_lo": lo_f}, y

    def process_file(self, state, p, x):
        """Whole-file fast path: batched operator build + log-squared
        nilpotent solve (the "different tap algorithm" lever PERF.md
        names for the flanger).

        ``process`` runs 12 dependent sweeps per 256-chunk at scan-step
        cadence and rebuilds the dense 4-tap operator every step — at
        file scale that is ~42k sequential matvecs plus ~3.5k sequential
        operator builds.  Here each scan step handles ``_FILE_BATCH`` chunks:

        - the LFO phase for EVERY chunk start comes from the parallel
          double-single ramp (``_ds_phase``) instead of the sequential
          TwoSum carry, so delay curves for all chunks exist up front;
        - ONE ``onehot_matrix`` compare builds all tap positions for the
          whole batch; the 4-tap cubic structure is recovered with static
          shifted slices (columns t0+k are column t0 shifted k), cutting
          the operator build ~4x vs four compare+FMA passes;
        - the strictly-lower in-chunk quarter C is squared (C2 = C@C,
          C4 = C2@C2) as batch matmuls, so the exact Neumann solve
          (I-fb*C)^-1 = (I+fbC)(I+fb^2 C2)(I+fb^4 C4+fb^8 C4^2) —
          valid because C^12 = 0 (each tap reaches >= D_MIN-2 = 22 back,
          12*22 >= 256) — needs 4 dependent matvecs per chunk, not 12.

        Parity: tap positions/weights are the same expressions as
        ``process``; divergence is the blockwise TwoSum carry's own
        rounding (~ulp/chunk) times the comb's resonant gain, plus f32
        reassociation in the squared products — bounded well under the
        fuzzer's flanger tolerance (tests/test_fastpath.py A/B)."""
        c, n = x.shape
        fs = jnp.float32(self.fs)
        dph = p["rate_hz"] / fs
        fb = p["feedback"]
        H = self.hist_len
        hmax = jnp.float32(H - 2)
        K, SB = _CHUNK, _FILE_BATCH

        step_len = K * SB
        steps = -(-n // step_len)
        total = steps * step_len
        pad = total - n
        xp = jnp.pad(x, ((0, 0), (0, pad))) if pad else x
        m = total // K

        # Per-chunk start phase from the parallel ramp; in-chunk phase is
        # the same hi + (lo + idx*dph) expression the blockwise step uses.
        gi = jnp.arange(m, dtype=jnp.float32) * jnp.float32(K)
        chi, clo = _ds_phase(gi, dph, state["ph_hi"], state["ph_lo"])
        idx = jnp.arange(K, dtype=jnp.float32)
        ph = chi[:, None] + (clo[:, None] + idx[None, :] * dph)  # (m, K)
        chan = jnp.arange(c, dtype=jnp.float32)
        ph_c = ph[:, None, :] + p["spread"] * chan[None, :, None]
        delay_ms = p["base_ms"] + p["depth_ms"] * jnp.sin(2.0 * jnp.pi * ph_c)
        d = jnp.clip(delay_ms * (fs / 1000.0), D_MIN, hmax)  # (m, C, K)
        ca = jnp.ceil(d).astype(jnp.int32)
        fr = (jnp.ceil(d) - d).astype(jnp.float32)
        base = H + jnp.arange(K, dtype=jnp.int32)
        t0 = base[None, None, :] - ca - 1  # (m, C, K) first-tap ext column

        def by_step(a):  # (m, C, K) -> (steps, SB, C, K)
            return a.reshape(steps, SB, c, K)

        xs = xp.reshape(c, steps, SB, K).transpose(1, 2, 0, 3)
        fb2 = fb * fb
        fb4 = fb2 * fb2

        def step_fn(hist, inp):
            xc, t0s, frs = inp  # (SB, C, K) each
            O = onehot_matrix(t0s, H + K)  # (SB, C, K, H+K) — ONE compare
            w = cubic_tap_weights(frs)     # 4 x (SB, C, K)
            # In-chunk quarter (strictly lower: taps reach >= 22 back):
            # tap k at ext column t0+k == H+m  <=>  O column H+m-k.
            cm = sum(
                w[k][..., None] * lax.slice_in_dim(O, H - k, H - k + K, axis=3)
                for k in range(4)
            )
            c2 = jnp.einsum("bcnm,bcmk->bcnk", cm, cm, precision=DOT_PRECISION)
            c4 = jnp.einsum("bcnm,bcmk->bcnk", c2, c2, precision=DOT_PRECISION)
            oh = O[..., :H]

            def mv(mat, z):
                return jnp.einsum("cnm,cm->cn", mat, z, precision=DOT_PRECISION)

            ys, vs = [], []
            for s in range(SB):
                # History tap: 4 shifted hist reads against the SAME
                # one-hot (taps crossing into the chunk read the pad's
                # zeros here and are picked up by cm above).
                hist_pad = jnp.pad(hist, ((0, 0), (0, 3)))
                hstack = jnp.stack(
                    [hist_pad[:, k:k + H] for k in range(4)], axis=1)
                th4 = jnp.einsum("cnh,cjh->cnj", oh[s], hstack,
                                 precision=DOT_PRECISION)
                th = sum(w[k][s] * th4[..., k] for k in range(4))
                b = xc[s] + fb * th
                # v = (I - fb*C)^-1 b, exact in 4 dependent matvecs.
                u = b + fb4 * mv(c4[s], b + fb4 * mv(c4[s], b))
                u = u + fb2 * mv(c2[s], u)
                v = u + fb * mv(cm[s], u)
                tap = th + mv(cm[s], v)
                ys.append((1.0 - p["mix"]) * xc[s] + p["mix"] * tap)
                vs.append(v)
                hist = jnp.concatenate([hist, v], axis=1)[:, -H:]
            return hist, (jnp.stack(ys), jnp.stack(vs))

        hist_f, (ys, vs) = lax.scan(
            step_fn, state["hist"], (xs, by_step(t0), by_step(fr)))
        hi_f, lo_f = _two_sum(state["ph_hi"],
                              state["ph_lo"] + jnp.float32(total) * dph)
        wrap = jnp.floor(hi_f)
        return self._finish(
            state, dph, pad, n, c, total,
            ys.reshape(m, c, K), vs.reshape(m, c, K),
            hist_f, hi_f - wrap, lo_f,
        )
