"""STFT spectral noise gate (parity target: reference spectral.py).

Overlap-add noise reduction: 50%-overlap Hann-windowed frames, per-bin
binary mask against a linear threshold, temporal mask smoothing
(alpha = 0.8), mono analysis applied to both channels (spectral.py:44-100).

Parallel mapping: all hops inside a processing block are framed and rfft'd as a
batch; the only sequential piece — the temporal mask IIR across frames —
is a first-order associative scan over the frame axis.  The hop is pinned
to the *stream* block size (256) regardless of the on-device superblock, so
file mode and mic mode produce identical spectra.  (This deliberately
diverges from the reference's file-mode quirk of one whole-file FFT,
core.py:123-129 + spectral.py:34-42 — see SURVEY.md §7, "blockwise +
parity waiver".)

The reference's magnitude/phase decompose-recompose
(mag * mask * exp(i*phase), spectral.py:74) is algebraically just
``fft * mask``; we use the direct product.

New in this build (no reference counterpart — the reference gates every
bin against ONE global threshold): an optional learned **noise profile**,
the per-bin mean magnitude of a noise-only capture measured with the SAME
analysis (Hann, n_fft = 2*hop).  When installed (static config, like the
convreverb's user IR) the gate threshold becomes per-bin:

    thresh_bin = max(threshold, profile_bin * 10^(profile_over_db/20))

so broadband bins pass only where they exceed the measured noise floor by
``profile_over_db``.  With no profile the max() reduces to the scalar
threshold and the program is bitwise the original.  Profiles are learned
by the engine (``learn_noise``: live capture or an uploaded WAV) and ride
session checkpoints alongside custom IRs (engine/checkpoint.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from aefs_tpu.core.params import ParamSpec
from aefs_tpu.models.base import EffectModel
from aefs_tpu.ops.fftops import (hann_window, frame_signal, overlap_add,
                                 rfft_last, irfft_last)
from aefs_tpu.ops.scan import affine_scan


def measure_noise_profile(mono, hop: int = 256) -> np.ndarray:
    """Per-bin mean magnitude of a noise-only capture — host-side numpy,
    measured with the SAME analysis ``process`` gates against (symmetric
    Hann, n_fft = 2*hop, 50% overlap), so ``profile * 10^(over/20)`` is
    directly comparable to the frame magnitudes at runtime."""
    n_fft = 2 * hop
    mono = np.asarray(mono, np.float32).reshape(-1)
    if len(mono) < n_fft:
        mono = np.pad(mono, (0, n_fft - len(mono)))
    k = (len(mono) - n_fft) // hop + 1
    idx = np.arange(n_fft)[None, :] + hop * np.arange(k)[:, None]
    frames = mono[idx] * np.hanning(n_fft)[None, :]
    return np.abs(np.fft.rfft(frames, axis=-1)).mean(axis=0).astype(np.float32)


class SpectralFilter(EffectModel):
    kind = "spectral"

    # Bounds/steps from SpectralFilter (spectral.py:8-9, :46-47).
    PARAMS = {
        "threshold_db": ParamSpec(-40.0, -80.0, 0.0, smooth="step", step=1.0),
        "reduction": ParamSpec(0.5, 0.0, 1.0, smooth="step", step=0.05),
        # Margin over the learned per-bin noise floor (active only once a
        # profile is installed via learn_noise; see module docstring).
        "profile_over_db": ParamSpec(6.0, 0.0, 24.0, smooth="step", step=0.5),
    }

    def __init__(self, fs, blocksize, channels=2, hop=256, smoothing=0.8,
                 noise_profile=None, **config):
        super().__init__(fs, blocksize, channels)
        if blocksize % hop != 0:
            raise ValueError(f"blocksize {blocksize} must be a multiple of hop {hop}")
        self.hop = int(hop)
        self.n_fft = 2 * self.hop
        self.alpha = float(smoothing)
        self.window = hann_window(self.n_fft)
        if noise_profile is not None:
            noise_profile = jnp.asarray(noise_profile, jnp.float32)
            bins = self.n_fft // 2 + 1
            if noise_profile.shape != (bins,):
                raise ValueError(
                    f"noise_profile must have {bins} bins "
                    f"(hop {self.hop}), got {noise_profile.shape}"
                )
        self.noise_profile = noise_profile

    def init_state(self):
        f32 = jnp.float32
        return {
            "in_tail": jnp.zeros((self.n_fft - self.hop,), f32),
            "ola_tail": jnp.zeros((self.hop,), f32),
            "mask": jnp.ones((self.n_fft // 2 + 1,), f32),
        }

    def process(self, state, p, x):
        hop = self.hop
        thresh = jnp.power(10.0, p["threshold_db"] / 20.0)
        red = p["reduction"]

        mono = jnp.mean(x, axis=0)  # mono analysis (spectral.py:55)
        frames, in_tail = frame_signal(state["in_tail"], mono, self.n_fft, hop)
        spec = rfft_last(frames * self.window[None, :])  # (k, bins)

        mag = jnp.abs(spec)
        if self.noise_profile is not None:
            over = jnp.power(10.0, p["profile_over_db"] / 20.0)
            thresh = jnp.maximum(thresh, self.noise_profile * over)  # (bins,)
        cur_mask = jnp.where(mag > thresh, 1.0, red)  # spectral.py:68
        # Temporal smoothing across frames (spectral.py:71) — first-order scan.
        mask = affine_scan(
            jnp.float32(self.alpha),
            (1.0 - self.alpha) * cur_mask,
            state["mask"],
            axis=0,
        )

        frames_out = irfft_last(spec * mask).astype(jnp.float32)
        y_mono, ola_tail = overlap_add(frames_out, state["ola_tail"], hop)

        new_state = {"in_tail": in_tail, "ola_tail": ola_tail, "mask": mask[-1]}
        if x.shape[-1] >= 4096:
            # Materialize before the channel broadcast (see gate.py) so XLA
            # does not duplicate the OLA glue per channel.
            y_mono = jax.lax.optimization_barrier(y_mono)
        # Same cleaned mono signal on every output channel (spectral.py:92-96).
        y = jnp.broadcast_to(y_mono[None, :], x.shape)
        return new_state, y
