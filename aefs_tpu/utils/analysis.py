"""On-device plot analysis: STFT log-spectrum + pitch-class chroma.

The reference computes these in the browser — a vendored radix-4 JS FFT
(assets/01_fft.js) over a 131072-sample rolling window with a
Blackman-Harris window, log-magnitude spectrum, and a MIDI pitch-class
chroma fold with frequency weighting and cube-law contrast
(assets/02_custom.js:6-117, :65-106, :178-279).

Here the same analysis runs on the device with ``jnp.fft.rfft`` — "the plots
are fed by the same on-device STFT" (BASELINE.json north star).  The
serving layer ships the reduced spectra (log-spaced bins) instead of
making the browser transform 16k points per frame.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

WINDOW_SAMPLES = 131072  # rolling plot window (02_custom.js:6)
FFT_SIZE = 16384         # analysis transform size (02_custom.js:7)
SPECTRUM_POINTS = 480    # log-spaced bins shipped to the UI
CHROMA_BINS = 12


def blackman_harris(n):
    k = np.arange(n)
    a = (0.35875, 0.48829, 0.14128, 0.01168)
    w = (
        a[0]
        - a[1] * np.cos(2 * np.pi * k / (n - 1))
        + a[2] * np.cos(4 * np.pi * k / (n - 1))
        - a[3] * np.cos(6 * np.pi * k / (n - 1))
    )
    return w.astype(np.float32)


@jax.jit
def _analyze(tail, window, log_idx, pc_map, pc_weight):
    """tail: (FFT_SIZE,) most recent samples -> (spec_db, chroma).

    All fs-dependent data (log_idx, pc_map, pc_weight) arrives as traced
    arrays — a static fs argument here forced a pointless full recompile
    of the serving-path kernel on every sample-rate renegotiation."""
    spec = jnp.abs(jnp.fft.rfft(tail * window))
    mag = spec / (FFT_SIZE / 4)

    # Log-spaced spectrum in dB (02_custom.js:178-250 renders log-x dB).
    spec_db = 20.0 * jnp.log10(jnp.maximum(mag[log_idx], 1e-7))

    # Chroma: fold bins to pitch classes with frequency weighting, then
    # cube-law contrast (02_custom.js:65-106).
    energy = (mag * pc_weight) ** 2
    chroma = jax.ops.segment_sum(energy, pc_map, num_segments=CHROMA_BINS + 1)[
        :CHROMA_BINS
    ]
    chroma = chroma / jnp.maximum(jnp.max(chroma), 1e-12)
    chroma = chroma**3
    return spec_db, chroma


class PlotAnalyzer:
    """Rolling before/after analysis state for the plot pump."""

    def __init__(self, fs: int):
        self.fs = int(fs)
        self.window = jnp.asarray(blackman_harris(FFT_SIZE))
        self.rings = {
            "input": np.zeros(WINDOW_SAMPLES, np.float32),
            "output": np.zeros(WINDOW_SAMPLES, np.float32),
        }

        freqs = np.fft.rfftfreq(FFT_SIZE, 1.0 / self.fs)
        lo, hi = 20.0, min(20000.0, self.fs / 2)
        targets = np.geomspace(lo, hi, SPECTRUM_POINTS)
        self.log_idx = jnp.asarray(
            np.searchsorted(freqs, targets).clip(0, len(freqs) - 1), jnp.int32
        )
        self.plot_freqs = targets.tolist()

        with np.errstate(divide="ignore"):
            midi = 12.0 * np.log2(np.maximum(freqs, 1e-9) / 440.0) + 69.0
        pc = (np.round(midi).astype(np.int64)) % 12
        audible = (freqs >= 55.0) & (freqs <= 5000.0)
        self.pc_map = jnp.asarray(np.where(audible, pc, CHROMA_BINS), jnp.int32)
        # Mild high-frequency de-emphasis like the reference's freq weighting.
        self.pc_weight = jnp.asarray(
            np.where(audible, 1.0 / np.sqrt(np.maximum(freqs, 55.0) / 55.0), 0.0),
            jnp.float32,
        )

    def _push(self, name, chunk):
        ring = self.rings[name]
        chunk = np.asarray(chunk, np.float32)[-WINDOW_SAMPLES:]
        n = len(chunk)
        if n:
            ring[:-n] = ring[n:]
            ring[-n:] = chunk
        return ring

    def analyze_file(self, original, processed, max_windows: int = 120,
                     min_hop_s: float = 0.25):
        """Windowed analysis of a whole file for playback scrubbing: the
        reference recomputes spectrum + chroma in sync with the file
        playhead browser-side (assets/02_custom.js:282-355); here the same
        on-device STFT ships one window per ``hop_s`` with the
        ``file_processed`` payload, and the UI indexes windows by playback
        time.  Window w analyzes the FFT_SIZE samples ENDING at
        (w+1)*hop — the trailing-window semantics of the live plots.

        original, processed: (N,) mono float32.  Returns a JSON-ready dict
        {hop_s, freqs, original: {spectrum_db (W, P), chroma (W, 12)},
        processed: {...}}.
        """
        n = int(len(processed))
        fs = self.fs
        hop = max(1, int(max(min_hop_s, (n / fs) / max_windows) * fs))
        n_win = max(1, -(-n // hop))
        # Pad the window COUNT to the next power of two: the vmap batch
        # axis is baked into the compiled program, so an unpadded W would
        # compile a fresh (W, FFT_SIZE) STFT kernel for every distinct
        # file length on the upload path (seconds each).  Buckets bound the variants to ~log2(max_windows); the
        # duplicate tail rows (all analyzing the final window) are sliced
        # off below.
        w_pad = 1 << (n_win - 1).bit_length()
        ends = np.minimum((np.arange(w_pad) + 1) * hop, n)

        out = {"hop_s": hop / fs, "freqs": self.plot_freqs}
        for name, sig in (("original", original), ("processed", processed)):
            sig = np.asarray(sig, np.float32).reshape(-1)
            padded = np.concatenate([np.zeros(FFT_SIZE, np.float32), sig])
            frames = padded[ends[:, None] + np.arange(FFT_SIZE)[None, :]]
            specs, chromas = jax.vmap(
                lambda t: _analyze(
                    t, self.window, self.log_idx, self.pc_map, self.pc_weight,
                )
            )(jnp.asarray(frames))
            out[name] = {
                "spectrum_db": np.asarray(specs)[:n_win].round(2).tolist(),
                "chroma": np.asarray(chromas)[:n_win].round(4).tolist(),
            }
        return out

    def update(self, in_chunk, out_chunk):
        """Push new samples, return JSON-ready analysis for both signals."""
        result = {"freqs": self.plot_freqs}
        for name, chunk in (("input", in_chunk), ("output", out_chunk)):
            ring = self._push(name, chunk)
            tail = jnp.asarray(ring[-FFT_SIZE:])
            spec_db, chroma = _analyze(
                tail, self.window, self.log_idx, self.pc_map, self.pc_weight,
            )
            result[name] = {
                "spectrum_db": np.asarray(spec_db).round(2).tolist(),
                "chroma": np.asarray(chroma).round(4).tolist(),
            }
        return result
