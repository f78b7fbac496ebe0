"""Convolution reverb via uniformly-partitioned FFT overlap-save
(new effect, BASELINE.md config 4).

The reference's reverb is algorithmic Schroeder (reverb.py); this effect
convolves with a long impulse response on-device: the IR is split into
blocksize-length partitions, the input spectrum history forms a
frequency-domain delay line, and each block costs one rfft + a (P x bins)
complex MAC + one irfft (ops/fftops.py:partitioned_fft_conv) — the same
overlap machinery that powers the spectral filter, generalized.

The IR is static topology: either a user-provided array (``ir`` config, a
(2, L) or (L,) float array, e.g. decoded from a WAV) or a synthetic
exponentially-decaying stereo noise IR of ``ir_seconds`` (deterministic
seed, decorrelated channels).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from aefs_tpu.core.params import ParamSpec
from aefs_tpu.models.base import EffectModel
from aefs_tpu.ops.fftops import partitioned_fft_conv, partition_ir


def synthetic_ir(fs: int, seconds: float, channels: int = 2, seed: int = 1234):
    """Exponentially-decaying noise IR, -60 dB at the tail, unit energy."""
    length = max(int(fs * seconds), 1)
    rng = np.random.default_rng(seed)
    t = np.arange(length, dtype=np.float64)
    env = np.power(10.0, -3.0 * t / max(length - 1, 1))  # -60 dB decay
    ir = rng.standard_normal((channels, length)) * env[None, :]
    ir /= np.sqrt(np.sum(ir**2, axis=1, keepdims=True))
    return ir.astype(np.float32)


class ConvReverb(EffectModel):
    kind = "convreverb"

    PARAMS = {
        "mix_dry": ParamSpec(0.7, 0.0, 2.0),
        "mix_wet": ParamSpec(0.4, 0.0, 2.0),
    }

    def __init__(self, fs, blocksize, channels=2, ir=None, ir_seconds=2.0,
                 hop=None, partition_multiple=1, **config):
        super().__init__(fs, blocksize, channels)
        self.hop = int(hop) if hop else int(blocksize)
        if blocksize % self.hop != 0:
            raise ValueError("blocksize must be a multiple of the conv hop")
        if ir is None:
            ir = synthetic_ir(fs, float(ir_seconds), channels)
        ir = np.atleast_2d(np.asarray(ir, np.float32))
        if ir.shape[0] == 1 and channels > 1:
            ir = np.repeat(ir, channels, axis=0)
        # partition_multiple m: zero-pad the IR so (P-1) % m == 0 — the
        # exact-divisibility requirement for sharding the spec_hist
        # partition axis over an m-way 'model' mesh axis
        # (parallel/mesh.py).  Zero partitions contribute nothing; cost
        # is < m extra rows of history.
        m = max(int(partition_multiple), 1)
        p_raw = max(1, -(-ir.shape[1] // self.hop))
        pad_parts = (-(p_raw - 1)) % m
        if pad_parts:
            ir = np.pad(ir, ((0, 0), (0, pad_parts * self.hop +
                                      (p_raw * self.hop - ir.shape[1]))))
        # (C, 2, P, hop+1) float32 partition spectra (real/imag split, so
        # no complex buffer crosses a jit boundary) — static weights.
        self.ir_spectra = jnp.asarray(
            np.stack([partition_ir(ch, self.hop) for ch in ir])
        )
        self.partitions = self.ir_spectra.shape[2]
        # Time-domain IR kept host-side for the whole-file fast path —
        # its rfft at the file's nfft is a trace-time float64 constant.
        self._ir_time = ir

    def init_state(self):
        c = self.channels
        return {
            "spec_hist": jnp.zeros(
                (c, 2, self.partitions - 1, self.hop + 1), jnp.float32
            ),
            "in_tail": jnp.zeros((c, self.hop), jnp.float32),
        }

    def process(self, state, p, x):
        wet, spec_hist, in_tail = jax.vmap(
            lambda sh, it, xi, irs: partitioned_fft_conv(sh, it, xi, irs, self.hop)
        )(state["spec_hist"], state["in_tail"], x, self.ir_spectra)

        y = jnp.clip(p["mix_dry"] * x + p["mix_wet"] * wet, -1.0, 1.0)
        return {"spec_hist": spec_hist, "in_tail": in_tail}, y

    def process_file(self, state, p, x):
        """Whole-file fast path: ONE length-nfft FFT convolution instead of
        N/hop partitioned hops.  The blockwise path's k x P frequency-domain
        MAC materializes a (k, P, hop+1) window tensor (a gather over the
        whole signal); a single rfft/irfft at
        nfft = next_pow2(N + L) touches ~3 passes of an (C, nfft) buffer
        instead.  The IR spectrum is a trace-time float64 rfft embedded as
        f32 constants (measured -141 dBFS vs the float64 oracle on the
        BASELINE config-4 geometry — FFT reassociation only).

        The carried state is rebuilt exactly (in_tail = last hop of input;
        spec_hist = rfft of the last P-1 overlap-save frames), so resuming
        blockwise from a file pass is seamless."""
        n = x.shape[-1]
        hop = self.hop
        if n % hop != 0 or n < hop:
            return self.process(state, p, x)
        l_ir = self._ir_time.shape[1]
        nfft = 1 << int(np.ceil(np.log2(n + l_ir)))
        # Full-complex fft -> multiply -> ifft rather than rfft/irfft (a
        # choice made on the first platform, where irfft's lowering added
        # a Hermitian-extension reverse; not yet re-measured on the GPU,
        # ROADMAP D4).  The full-length H spectrum is a
        # trace-time float64 constant, so the extra bins cost no device
        # FLOPs beyond the (cheap) elementwise product.
        h_spec = np.fft.fft(self._ir_time.astype(np.float64), nfft)
        hr = jnp.asarray(h_spec.real.astype(np.float32))
        hi = jnp.asarray(h_spec.imag.astype(np.float32))
        xs = jnp.fft.fft(x, nfft)
        wet = jnp.real(jnp.fft.ifft(xs * jax.lax.complex(hr, hi)))[
            :, :n
        ].astype(x.dtype)

        # Exact end-of-file state: the last P-1 overlap-save frames of the
        # zero-history-extended input (windows before the signal start read
        # zeros, matching the blockwise path's initial spec_hist rows).
        pparts = self.partitions
        if pparts > 1:
            xt = jnp.concatenate(
                [jnp.zeros((x.shape[0], pparts * hop), x.dtype), x], axis=1
            )
            e = xt.shape[-1]
            frames = jnp.stack(
                [
                    xt[:, e - (pparts - i) * hop : e - (pparts - i - 2) * hop
                       if (pparts - i - 2) > 0 else None]
                    for i in range(pparts - 1)
                ],
                axis=1,
            )  # (C, P-1, 2*hop), chronological (newest last)
            fs_c = jnp.fft.rfft(frames, axis=-1)
            spec_hist = jnp.stack(
                [jnp.real(fs_c), jnp.imag(fs_c)], axis=1
            ).astype(jnp.float32)  # (C, 2, P-1, hop+1)
        else:
            # IR fits in one hop (e.g. a short uploaded impulse): the
            # frequency-domain delay line is empty, nothing to rebuild.
            spec_hist = jnp.zeros(
                (x.shape[0], 2, 0, hop + 1), jnp.float32
            )

        y = jnp.clip(p["mix_dry"] * x + p["mix_wet"] * wet, -1.0, 1.0)
        return {"spec_hist": spec_hist, "in_tail": x[:, -hop:]}, y
