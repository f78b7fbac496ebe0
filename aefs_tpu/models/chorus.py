"""Chorus / vibrato: LFO-modulated fractional delay (new in this build —
the reference's only modulated-read effect is the octaver's grain phasor,
octaver.py:37-62; this reuses the same tap machinery for the classic
modulation family).

Parallel decomposition: the read position p[n] = n - delay[n] is strictly
increasing (the LFO slews |d(delay)/dn| = 2*pi*rate*depth/fs << 1 at every
legal param draw), so the tap is the octaver's feedforward fractional read
(ops/ringbuf.py:fractional_read_cubic — one 4-wide sliced gather, no
recurrence).  The LFO phase is carried across blocks as a compensated
split-float32 pair (the octaver's TwoSum phasor, models/octaver.py:_two_sum)
so 256-sample streaming and 4096-superblock file processing accumulate
bit-near-identical phase — float32 naive accumulation drifts ~eps/block,
which a -80 dBFS blocking-invariance bar would see.

Stereo width comes from a per-channel LFO phase offset (``spread`` in
cycles, 0 = mono chorus, 0.25 = quadrature).

Parity: float64 per-sample oracle (tests/oracles.py:OracleChorus)
<= -80 dBFS on tonal program; mix=0 is exact passthrough.

Perf note: streaming keeps the per-descriptor gather tap (a 256-sample
block is far under the 5.33 ms deadline either way), but whole-file
mode overrides ``process_file`` with the flanger's dense one-hot tap
operator (models/flanger.py rationale): a vmapped-dynamic_slice gather
with ~900k per-sample starts is replaced by chunked dense contractions,
batched 8 chunks per scan step — elementwise comparisons plus small
matrix products.  Tap positions and weights are
bitwise the ones the gather path computes; only the 4-term summation
order differs (~eps, far under the chorus's documented -42 dB relative
quantization floor).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from aefs_tpu.core.params import ParamSpec
from aefs_tpu.models.base import EffectModel
from aefs_tpu.models.octaver import _two_sum
from aefs_tpu.ops.precision import DOT_PRECISION
from aefs_tpu.ops.ringbuf import cubic_onehot_matrix, fractional_read_cubic

MAX_BASE_MS = 40.0
MAX_DEPTH_MS = 10.0


class Chorus(EffectModel):
    kind = "chorus"

    PARAMS = {
        "rate_hz": ParamSpec(0.8, 0.05, 10.0, smooth="mult", step=0.05),
        "depth_ms": ParamSpec(3.0, 0.0, MAX_DEPTH_MS, smooth="step", step=0.1),
        "base_ms": ParamSpec(12.0, 1.0, MAX_BASE_MS, smooth="step", step=0.5),
        "mix": ParamSpec(0.5, 0.0, 1.0, smooth="instant"),
        "spread": ParamSpec(0.25, 0.0, 0.5, smooth="instant"),
    }

    def __init__(self, fs, blocksize, channels=2, **config):
        super().__init__(fs, blocksize, channels, **config)
        # History covers the deepest legal tap plus the cubic kernel's
        # reach; static topology, so every (block, file) trace shares it.
        self.hist_len = int(
            (MAX_BASE_MS + MAX_DEPTH_MS) * fs / 1000.0
        ) + 8

    def init_state(self):
        return {
            "hist": jnp.zeros((self.channels, self.hist_len), jnp.float32),
            "ph_hi": jnp.float32(0.0),
            "ph_lo": jnp.float32(0.0),
        }

    def process(self, state, p, x):
        c, n = x.shape
        fs = jnp.float32(self.fs)
        dph = p["rate_hz"] / fs  # cycles per sample

        # Per-sample LFO phase from the compensated carry: n*dph stays
        # < ~1 at any block size the chain uses, so one f32 product per
        # sample loses nothing; the CARRY across blocks is where naive
        # f32 drifts, hence the TwoSum pair.
        idx = jnp.arange(n, dtype=jnp.float32)
        ph = state["ph_hi"] + (state["ph_lo"] + idx * dph)
        ph_c = ph[None, :] + p["spread"] * jnp.arange(c, dtype=jnp.float32)[:, None]

        delay_ms = p["base_ms"] + p["depth_ms"] * jnp.sin(
            2.0 * jnp.pi * ph_c
        )
        ago = jnp.clip(
            delay_ms * (fs / 1000.0), 2.0, jnp.float32(self.hist_len - 2)
        )

        tap = jax.vmap(fractional_read_cubic)(state["hist"], x, ago)
        y = (1.0 - p["mix"]) * x + p["mix"] * tap

        new_hist = jnp.concatenate([state["hist"], x], axis=1)[:, -self.hist_len:]
        hi, lo = _two_sum(state["ph_hi"],
                          state["ph_lo"] + jnp.float32(n) * dph)
        wrap = jnp.floor(hi)  # exact in f32; keeps hi in [0, 1)
        return (
            {"hist": new_hist, "ph_hi": hi - wrap, "ph_lo": lo},
            y,
        )

    # 256-sample chunks, 8 chunks contracted per scan step (chunks are
    # independent — the chorus is feed-forward — so the batch width only
    # trades scan-step count against per-step working set, ~44 MB at 8).
    _F_CHUNK = 256
    _F_BATCH = 8

    def process_file(self, state, p, x):
        """Whole-file pass with the dense one-hot tap operator (see the
        module docstring perf note): identical tap positions/weights to
        ``process``'s gather — phase ramp, delay law, and clips are the
        same expressions on the same global sample index — only the
        4-term summation order differs (~eps)."""
        c, n = x.shape
        ch, b = self._F_CHUNK, self._F_BATCH
        hl = self.hist_len
        fs = jnp.float32(self.fs)
        dph = p["rate_hz"] / fs

        step_len = ch * b
        mb = -(-n // step_len)  # scan steps
        total = mb * step_len
        xp = jnp.pad(x, ((0, 0), (0, total - n))) if total != n else x

        idx = jnp.arange(total, dtype=jnp.float32)
        ph = state["ph_hi"] + (state["ph_lo"] + idx * dph)
        ph_c = ph[None, :] + p["spread"] * jnp.arange(c, dtype=jnp.float32)[:, None]
        delay_ms = p["base_ms"] + p["depth_ms"] * jnp.sin(2.0 * jnp.pi * ph_c)
        ago = jnp.clip(delay_ms * (fs / 1000.0), 2.0, jnp.float32(hl - 2))
        ca = jnp.ceil(ago).astype(jnp.int32)
        fr = (jnp.ceil(ago) - ago).astype(x.dtype)

        full = jnp.concatenate([state["hist"], xp], axis=1)  # (C, hl+total)
        starts = jnp.arange(mb) * step_len
        regions = jax.vmap(
            lambda s: lax.dynamic_slice(full, (0, s), (c, hl + step_len))
        )(starts)  # (mb, C, hl+step_len) — mb descriptors, not N

        def stack_steps(a):  # (C, total) -> (mb, C, B, CH)
            return a.reshape(c, mb, b, ch).transpose(1, 0, 2, 3)

        base = hl + jnp.arange(ch, dtype=jnp.int32)  # chunk-local row base

        def step(_, xs):
            region, ca_s, fr_s = xs  # (C, hl+step), (C,B,CH), (C,B,CH)
            ext = jnp.stack(
                [region[:, i * ch: i * ch + hl + ch] for i in range(b)],
                axis=1,
            )  # (C, B, hl+CH)
            w = cubic_onehot_matrix(
                base[None, None, :] - ca_s - 1, fr_s, hl + ch)
            tap = jnp.einsum("cbns,cbs->cbn", w, ext, precision=DOT_PRECISION)
            return None, tap

        _, taps = lax.scan(
            step, None, (regions, stack_steps(ca), stack_steps(fr)))
        tap = taps.transpose(1, 0, 2, 3).reshape(c, total)[:, :n]

        y = (1.0 - p["mix"]) * x + p["mix"] * tap
        new_hist = jnp.concatenate([state["hist"], x], axis=1)[:, -hl:]
        hi, lo = _two_sum(state["ph_hi"],
                          state["ph_lo"] + jnp.float32(n) * dph)
        wrap = jnp.floor(hi)
        return {"hist": new_hist, "ph_hi": hi - wrap, "ph_lo": lo}, y
