"""Schroeder/Moorer algorithmic reverb (parity target: reference reverb.py).

Topology per side (reverb.py:208-272): pre-delay -> 4 parallel damped
feedback combs summed -> 2 serial Gardner allpass diffusers -> dry/wet mix
with hard clip.  L/R are decorrelated by +-0.3 ms lag jitter
(reverb.py:158-177, :186-187).  Per-comb feedback derives from RT60:
g = 10^(-3 L / fs / rt60) (reverb.py:205-206).

Parallel mapping: the comb bank is one vectorized ``comb_bank_block`` (a
gather + first-order associative scan per fixed-point step — the bank axis
is also the natural "model-parallel" shard axis, see parallel/); the short
allpasses (5.0 / 1.7 ms < blocksize) are exact lag-affine scans over
residue classes (ops/scan.py:lag_affine_scan) — "hard part #1" of
SURVEY.md §7 — and the pre-delay is a pure gather.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from aefs_tpu.core.params import ParamSpec
from aefs_tpu.models.base import EffectModel
from aefs_tpu.ops.ringbuf import (
    comb_bank_block,
    comb_bank_block_static,
    allpass_block,
    delay_read,
    ring_push,
)


class Reverb(EffectModel):
    kind = "reverb"

    # Bounds/steps from ReverbEffect (reverb.py:112-119).
    PARAMS = {
        "rt60_s": ParamSpec(1.5, 0.1, 10.0, smooth="step", step=0.05),
        "damp": ParamSpec(0.3, 0.0, 0.99, smooth="step", step=0.02),
        "pre_delay_ms": ParamSpec(0.0, 0.0, 100.0, smooth="step_ms", step=2.0),
        "mix_dry": ParamSpec(0.7, 0.0, 2.0),
        "mix_wet": ParamSpec(0.5, 0.0, 2.0),
    }

    def __init__(
        self,
        fs,
        blocksize,
        channels=2,
        comb_times_ms=(29.7, 37.1, 41.1, 43.7),
        allpass_times_ms=(5.0, 1.7),
        allpass_gain=0.6,
        jitter_ms=0.3,
        max_delay_ms=200.0,
        max_pre_delay_ms=100.0,
        file_mode=False,
        **config,
    ):
        super().__init__(fs, blocksize, channels)
        self.ap_gain = float(allpass_gain)
        self.pre_size = max(1, int(fs * float(max_pre_delay_ms) / 1000.0) + 1)

        def lags(times_ms, jitter, scale):
            out = []
            for base in times_ms:
                ms = min(float(base) + jitter * scale, float(max_delay_ms) - 1.0)
                out.append(max(1, int(fs * ms / 1000.0)))
            return out

        # Static per-side lags (reverb.py:158-177): jitter +0.3 L / -0.3 R.
        j = float(jitter_ms)
        self.comb_lags = [lags(comb_times_ms, +j, 1.0), lags(comb_times_ms, -j, 1.0)]
        self.ap_lags = [lags(allpass_times_ms, +j, 0.2), lags(allpass_times_ms, -j, 0.2)]
        self.comb_lmax = max(max(side) for side in self.comb_lags)
        self.comb_lmin = min(min(side) for side in self.comb_lags)
        self.n_combs = len(comb_times_ms)
        if file_mode and self.comb_lmax >= 2 * self.comb_lmin:
            # The whole-file chunk solver needs one chunk size C with
            # C <= L < 2C for every comb lag (ops/ringbuf.py:
            # comb_chunk), i.e. max lag < 2 * min lag across
            # both jittered sides.  Fail at build time with the knob the
            # user can actually fix, not at trace time inside the solver.
            raise ValueError(
                f"reverb comb_times_ms={tuple(comb_times_ms)} is not "
                f"file-mode renderable: jittered comb lags span "
                f"[{self.comb_lmin}, {self.comb_lmax}] samples at "
                f"fs={fs}, violating max < 2*min required by the "
                f"whole-file comb solver. Keep the longest comb time "
                f"under twice the shortest (jitter_ms={j} included)."
            )

    def init_state(self):
        f32 = jnp.float32
        return {
            "pre": jnp.zeros((2, self.pre_size), f32),
            "combs": jnp.zeros((2, self.n_combs, self.comb_lmax), f32),
            "lps": jnp.zeros((2, self.n_combs), f32),
            "aps": tuple(
                tuple(jnp.zeros((lag,), f32) for lag in self.ap_lags[side])
                for side in range(2)
            ),
        }

    def process(self, state, p, x):
        fs = jnp.float32(self.fs)
        rt60 = p["rt60_s"]
        damp = p["damp"]
        pre_d = (fs * p["pre_delay_ms"] / 1000.0).astype(jnp.int32)
        pre_d = jnp.minimum(pre_d, self.pre_size - 1)  # reverb.py:224-225

        # Pre-delay (pure gather) per side.
        pre_out = jax.vmap(lambda h, xi: delay_read(h, xi, pre_d))(state["pre"], x)
        new_pre = ring_push(state["pre"], x)

        # Both sides' comb banks in ONE vectorized call (B = 8): halves the
        # op count of the streaming hot path vs per-side calls.
        b = self.n_combs
        all_lags = jnp.asarray(self.comb_lags[0] + self.comb_lags[1], jnp.int32)
        # g per comb from RT60 (reverb.py:205-206).
        g_all = jnp.power(
            10.0,
            -3.0 * (all_lags.astype(jnp.float32) / fs) / jnp.maximum(1e-3, rt60),
        )
        xb = jnp.repeat(pre_out, b, axis=0)  # (2B, N) side-major
        static_lags = tuple(self.comb_lags[0] + self.comb_lags[1])
        if x.shape[-1] <= self.comb_lmin:
            # Mic-sized blocks: static windows + one T_h matmul, no scans.
            y, hists, lps = comb_bank_block_static(
                state["combs"].reshape(2 * b, -1),
                state["lps"].reshape(2 * b),
                xb,
                static_lags,
                g_all,
                damp,
            )
        else:
            y, hists, lps = comb_bank_block(
                state["combs"].reshape(2 * b, -1),
                state["lps"].reshape(2 * b),
                xb,
                all_lags,
                g_all,
                damp,
                self.comb_lmin,
            )
        comb_y = [y[:b], y[b:]]
        new_combs = [hists[:b], hists[b:]]
        new_lps = [lps[:b], lps[b:]]

        return self._diffuse_and_mix(state, p, x, comb_y, new_pre, new_combs, new_lps)

    def _diffuse_and_mix(self, state, p, x, comb_y, new_pre, new_combs, new_lps):
        """Shared tail of process/process_file: per-side allpass diffuser
        chains, dry/wet mix with hard clip (reverb.py:243-277), and state
        assembly.  comb_y: per side a (K, N) array summed over axis 0 —
        the streaming path passes the raw (n_combs, N) outputs, the file
        path a pre-summed (1, N) (it sums on the chunk tensor)."""
        new_aps, wet_sides = [], []
        for side in range(2):
            sig = jnp.sum(comb_y[side], axis=0)  # comb sum (reverb.py:234-241)
            side_aps = []
            for stage, lag in enumerate(self.ap_lags[side]):
                sig, ap_hist = allpass_block(
                    state["aps"][side][stage], sig, self.ap_gain, lag
                )
                side_aps.append(ap_hist)
            new_aps.append(tuple(side_aps))
            wet_sides.append(sig)

        wet = jnp.stack(wet_sides)
        y = jnp.clip(p["mix_dry"] * x + p["mix_wet"] * wet, -1.0, 1.0)
        new_state = {
            "pre": new_pre,
            "combs": jnp.stack(new_combs),
            "lps": jnp.stack(new_lps),
            "aps": tuple(new_aps),
        }
        return new_state, y

    def process_file(self, state, p, x):
        """Whole-file fast path: the comb bank runs as one chunked
        whole-signal solve (ops/ringbuf.py:comb_bank_file — the Triton
        kernel on the GPU), the allpass diffusers as residue-class scans
        over the full signal, the pre-delay as one gather.  Requires fresh
        (zero) reverb state, which file mode guarantees (fresh chain per
        file, engine.py:86-99)."""
        from aefs_tpu.ops.ringbuf import comb_bank_file

        fs = jnp.float32(self.fs)
        rt60 = p["rt60_s"]
        damp = p["damp"]
        pre_d = (fs * p["pre_delay_ms"] / 1000.0).astype(jnp.int32)
        pre_d = jnp.minimum(pre_d, self.pre_size - 1)

        pre_out = jax.vmap(lambda h, xi: delay_read(h, xi, pre_d))(state["pre"], x)
        new_pre = ring_push(state["pre"], x)

        # Both sides' comb banks in ONE solve (B = 8), each comb reading
        # its side's pre-delayed signal.
        all_lags = self.comb_lags[0] + self.comb_lags[1]
        g_all = jnp.power(
            10.0,
            -3.0 * (jnp.asarray(all_lags, jnp.float32) / fs) / jnp.maximum(1e-3, rt60),
        )
        b = self.n_combs
        side_of = (0,) * b + (1,) * b
        y, damped = comb_bank_file(pre_out, all_lags, g_all, damp, side_of=side_of)
        comb_y = [jnp.sum(y[:b], axis=0)[None], jnp.sum(y[b:], axis=0)[None]]

        # Final ring state w = x + g*damped over the last ``lmax`` samples.
        n = x.shape[-1]
        lmax = self.comb_lmax
        take = min(n, lmax)
        x_tail = jnp.repeat(pre_out[:, n - take :], b, axis=0)  # (2B, take)
        w_win = x_tail + g_all[:, None] * damped[:, n - take :]
        if take < lmax:
            w_win = jnp.concatenate(
                [jnp.zeros((2 * b, lmax - take), x.dtype), w_win], axis=1
            )
        lps_all = damped[:, n - 1]

        new_combs = [w_win[:b], w_win[b:]]
        new_lps = [lps_all[:b], lps_all[b:]]
        return self._diffuse_and_mix(state, p, x, comb_y, new_pre, new_combs, new_lps)
