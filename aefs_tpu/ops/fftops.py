"""On-device STFT framing and overlap-add.

Replaces the reference's host-side NumPy FFT path (spectral.py:53-100) and
generalizes it into the machinery for partitioned FFT convolution (the
convolution-reverb benchmark config, BASELINE.md config 4).  All transforms
run on-device via ``jnp.fft.rfft/irfft``.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from aefs_tpu.ops.precision import DOT_PRECISION


def hann_window(n_fft: int, dtype=jnp.float32):
    """Symmetric Hann window, identical to np.hanning (spectral.py:17)."""
    return jnp.asarray(np.hanning(n_fft), dtype=dtype)


# ---------------------------------------------------------------------------
# rfft/irfft along the last axis, with an env-gated DFT-by-matmul fallback.
#
# XLA CPU's layout assignment has a bug in GSPMD-partitioned modules: it
# inserts a copy to a non-dim0-major layout (e.g. {2,0,1}) immediately
# before an FFT op, and the CPU fft thunk RET_CHECKs
# IsMonotonicWithDim0Major on its operand (fft_thunk.cc:167).  Observed
# whenever the conv reverb's model-sharded spec_hist and the spectral
# filter's FFTs meet in one program on the virtual CPU mesh; barriers and
# real/imag splits don't help because layout assignment runs after user
# graph construction.  GPU lowering is unaffected.  AEFS_FFT_VIA_MATMUL=1
# (set by dryrun_multichip's inner subprocess and the sharded-FFT tests)
# routes the transforms through explicit DFT matmuls, which shard and lay
# out like any other matmul.  f32 matmul DFT error is ~sqrt(N)*eps —
# ~2e-6 relative at N=1024, far under the -100 dBFS comparison bars.
# ---------------------------------------------------------------------------

_DFT_CACHE: dict = {}


def _fft_via_matmul() -> bool:
    import os

    return os.environ.get("AEFS_FFT_VIA_MATMUL", "0") == "1"


def _dft_mats(n: int):
    # NUMPY arrays in the cache (converted per call site): a jnp constant
    # materialized during one trace leaks a tracer into later traces.
    if n not in _DFT_CACHE:
        k = np.arange(n // 2 + 1)
        t = np.arange(n)
        ang = 2.0 * np.pi * np.outer(t, k) / n  # (n, bins) float64
        _DFT_CACHE[n] = (
            np.cos(ang).astype(np.float32),
            np.sin(ang).astype(np.float32),
        )
    c, s = _DFT_CACHE[n]
    return jnp.asarray(c), jnp.asarray(s)


def rfft_last(x):
    """jnp.fft.rfft(x, axis=-1), or the DFT-matmul equivalent under
    AEFS_FFT_VIA_MATMUL (see module comment)."""
    if not _fft_via_matmul():
        return jnp.fft.rfft(x, axis=-1)
    c, s = _dft_mats(x.shape[-1])
    return jax.lax.complex(
        jnp.matmul(x, c, precision=DOT_PRECISION),
        -jnp.matmul(x, s, precision=DOT_PRECISION),
    )


def irfft_last(spec):
    """jnp.fft.irfft(spec, axis=-1) (length 2*(bins-1)), or the DFT-matmul
    equivalent under AEFS_FFT_VIA_MATMUL."""
    if not _fft_via_matmul():
        return jnp.fft.irfft(spec, axis=-1)
    n = 2 * (spec.shape[-1] - 1)
    c, s = _dft_mats(n)
    w = np.full(n // 2 + 1, 2.0 / n)
    w[0] = w[-1] = 1.0 / n
    w = jnp.asarray(w, jnp.float32)
    return (jnp.matmul(jnp.real(spec) * w, c.T, precision=DOT_PRECISION)
            - jnp.matmul(jnp.imag(spec) * w, s.T, precision=DOT_PRECISION))


def frame_signal(tail, x, n_fft: int, hop: int):
    """Slice a block into overlapping analysis frames.

    tail: (n_fft - hop,) carried samples preceding this block.
    x: (N,) current block, N must be a multiple of ``hop``.

    Returns (frames, new_tail) where frames is (N // hop, n_fft): frame i
    covers stream samples [i*hop, i*hop + n_fft) of ``tail ++ x`` — the
    sliding in_buffer of the reference (spectral.py:53-56) batched over all
    hops in the block.
    """
    n = x.shape[-1]
    k = n // hop
    stream = jnp.concatenate([tail, x])
    if n_fft == 2 * hop:
        # 50% overlap: frame i = chunk[i] ++ chunk[i+1] — pure reshape +
        # concat, no gather (this path covers every framing in the
        # framework).
        chunks = stream.reshape(k + 1, hop)
        frames = jnp.concatenate([chunks[:-1], chunks[1:]], axis=1)
    else:
        idx = jnp.arange(k)[:, None] * hop + jnp.arange(n_fft)[None, :]
        frames = jnp.take(stream, idx, axis=-1)
    new_tail = stream[n:]
    return frames, new_tail


def overlap_add(frames, tail, hop: int):
    """50%-overlap-add synthesis (port of spectral.py:77-100).

    frames: (k, 2*hop) processed time-domain frames.
    tail: (hop,) carried second half of the previous frame.

    Returns (y, new_tail): y is (k*hop,) — frame i's first half plus frame
    i-1's second half, exactly the reference's out_accum shift pattern.
    """
    k = frames.shape[0]
    halves = jnp.concatenate([tail[None, :], frames[:-1, hop:]], axis=0)
    y = (frames[:, :hop] + halves).reshape(k * hop)
    return y, frames[-1, hop:]


def partitioned_fft_conv(spec_hist, in_tail, x, ir_spectra, hop: int):
    """Uniformly-partitioned FFT convolution (frequency-domain delay line).

    The impulse response is split into P partitions of ``hop`` samples;
    each partition's rfft (length 2*hop) is a row of ``ir_spectra``.
    Per hop we push the input frame spectrum into a P-deep history and
    accumulate sum_p X[t-p] * H[p] — overlap-save.

    Complex values live only *inside* the compiled program: carried state
    and IR weights are split real/imag float32, so no complex buffer
    crosses a jit boundary.

    spec_hist: (2, P-1, hop+1) float32 — previous input-frame spectra
      (real, imag), chronological (newest last).
    in_tail: (hop,) previous input block (for the overlap-save frame).
    x: (N,) input, N a multiple of ``hop``.
    ir_spectra: (2, P, hop+1) float32 — partition spectra (real, imag).

    Returns (y, new_spec_hist, new_in_tail).
    """
    p = ir_spectra.shape[1]
    n = x.shape[-1]
    k = n // hop

    frames, new_in_tail = frame_signal(in_tail, x, 2 * hop, hop)
    specs = rfft_last(frames)  # (k, hop+1) complex

    # Chronological spectra: P-1 carried, then k new.  Output hop j needs
    # X_{j-q} = full[p-1+j-q] for q = 0..P-1.
    hist_c = jax.lax.complex(spec_hist[0], spec_hist[1])
    ir_c = jax.lax.complex(ir_spectra[0], ir_spectra[1])
    full = jnp.concatenate([hist_c, specs], axis=0)  # (p-1+k, hop+1)
    if k == 1:
        # Streaming path (one hop per block): the window is just `full`
        # reversed — no gather.  Keeps the hot path off gathers AND
        # lets GSPMD shard the partition axis over the
        # 'model' mesh axis (parallel/mesh.py): flip/multiply stay
        # partition-local, the partition sum lowers to one psum of a
        # (hop+1,) spectrum.
        windows = jnp.flip(full, axis=0)[None]  # (1, p, hop+1)
    else:
        base = jnp.arange(k)[:, None] + (p - 1 - jnp.arange(p))[None, :]
        windows = jnp.take(full, base, axis=0)  # (k, p, hop+1)
    y_spec = jnp.sum(windows * ir_c[None, :, :], axis=1)  # (k, hop+1)

    y_frames = irfft_last(y_spec)  # (k, 2*hop)
    # Overlap-save: the second half of each frame is the valid output.
    y = y_frames[:, hop:].reshape(n).astype(x.dtype)

    new_hist = full[k:] if p > 1 else full[:0]
    new_hist = jnp.stack([jnp.real(new_hist), jnp.imag(new_hist)]).astype(jnp.float32)
    return y, new_hist, new_in_tail


def partition_ir(ir, hop: int):
    """Split an impulse response into rfft'd partitions for
    ``partitioned_fft_conv``: partition q covers ir[q*hop:(q+1)*hop],
    zero-padded to 2*hop.  Returns (2, P, hop+1) float32 (real, imag)."""
    ir = np.asarray(ir, np.float32)
    p = max(1, -(-len(ir) // hop))
    padded = np.zeros((p, 2 * hop), np.float32)
    for q in range(p):
        part = ir[q * hop : (q + 1) * hop]
        padded[q, : len(part)] = part
    spec = np.fft.rfft(padded, axis=-1)
    return np.stack([spec.real, spec.imag]).astype(np.float32)
