"""Chronological ring buffers and blocked delay-line solvers.

The reference keeps ring buffers as (buf, write-pointer) pairs updated one
sample at a time inside Numba loops (delay.py:7-22, reverb.py:11-67,
octaver.py:17-82).  Here every buffer is *chronological*: ``hist[..., -1]``
is the most recently written sample and a block update is a single
``concat(hist, new)[... , -S:]``.  Reads become slices / gathers, with no
scatter or modular arithmetic.

Feedback through a delay line shorter than the block is solved by
fixed-point iteration: each application of the block map propagates
correctness by ``dS`` samples, so ``ceil(N / dS_min)`` iterations
(a static count) reach the exact solution.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from aefs_tpu.ops.precision import DOT_PRECISION


def ring_push(hist, new):
    """Append ``new`` (time-last) and keep the trailing window of hist's size."""
    size = hist.shape[-1]
    return jnp.concatenate([hist, new], axis=-1)[..., -size:]


def lane_dynamic_slice(v, start, n: int):
    """out[..., j] = v[..., start + j] for a traced ``start`` — a dynamic
    minor(lane)-dimension slice evaluated as a one-hot contraction (a
    choice made on the first platform, where dynamic minor-dim slices
    lowered to a sequential per-row loop; ROADMAP D4 re-measures it on
    the GPU).  EXACT: one-hot rows select single f32 values at
    DOT_PRECISION.

    Only sensible for small trailing dims (the selection matrix is
    (M, n)); callers gate on size and fall back to lax.dynamic_slice.
    """
    m = v.shape[-1]
    i = jax.lax.broadcasted_iota(jnp.int32, (m, n), 0)
    j = jax.lax.broadcasted_iota(jnp.int32, (m, n), 1)
    sel = (i == j + start).astype(v.dtype)
    return jax.lax.dot_general(
        v, sel, (((v.ndim - 1,), (0,)), ((), ())),
        precision=DOT_PRECISION,
    )


_LANE_MM_MAX = 1024  # largest blocksize routed through the one-hot shift


def chrono_window(ext, start, n: int):
    """ext[start : start + n] with a traced ``start`` (1-D ext): pad to
    n-sample rows, take two rows with a cheap major-dim dynamic slice,
    then align with the one-hot lane shift (see lane_dynamic_slice)."""
    e = ext.shape[-1]
    rows = -(-e // n) + 1
    ext_p = jnp.pad(ext, (0, rows * n - e))
    mat = ext_p.reshape(rows, n)
    r0 = start // n
    o = start % n
    pair = jax.lax.dynamic_slice(mat, (r0, jnp.int32(0)), (2, n)).reshape(2 * n)
    return lane_dynamic_slice(pair, o, n)


def rowring_rows(size: int, blocksize: int) -> int:
    """Row count for a block-row ring covering reads up to ``size`` back."""
    return -(-size // blocksize) + 1


def rowring_read(ring, row, d, n: int):
    """Window of ``n`` samples starting ``d`` samples before the current
    block, from a block-row ring.

    ring: (R, N) — row ``(row - 1 + R) % R`` holds the previous block,
      chronological within rows; ``row`` is the slot the CURRENT block will
      occupy.  N == n == blocksize.
    d: traced int32 in [1, (R-1)*N].  Lanes j >= d of the result depend on
      the current (unwritten) block and are garbage — callers mask them.

    Two single-row dynamic slices + one in-row shift: O(N) per read
    regardless of ring size (the streaming replacement for reads out of a
    chronological buffer, whose per-block maintenance is O(size)).
    """
    r, nn = ring.shape
    assert nn == n
    row_rel = (-d) // n  # floor division (negative)
    o = (-d) % n
    row0 = jnp.mod(row + row_rel, r)
    row1 = jnp.mod(row0 + 1, r)
    ra = jax.lax.dynamic_slice(ring, (row0, jnp.int32(0)), (1, n))
    rb = jax.lax.dynamic_slice(ring, (row1, jnp.int32(0)), (1, n))
    pair = jnp.concatenate([ra, rb], axis=1)[0]
    if n <= _LANE_MM_MAX:
        return lane_dynamic_slice(pair, o, n)
    return jax.lax.dynamic_slice(pair[None], (jnp.int32(0), o), (1, n))[0]


def rowring_write(ring, row, blk):
    """Write ``blk`` into slot ``row`` of a block-row ring.

    ``row`` is LOCKSTEP — identical across any stream vmap (it is a pure
    per-block counter, and every serving-pool slot steps on every
    dispatch, so rows never diverge; ``Chain.state_axes`` maps such
    leaves to vmap axis None).  The alternatives, as first compared on
    another platform (ROADMAP D4 re-measures them on the GPU):

    - PER-STREAM row + dynamic_update_slice: the batched-index DUS
      lowers to a sequential per-stream loop plus full-ring copies;
    - lockstep row + DUS (batch-uniform start): O(N) slice semantics,
      but WITHOUT buffer donation XLA still materializes a full-ring
      copy before the in-place update;
    - lockstep row + one-hot select (this impl): full-ring masked pass
      (read+write R*N), but it FUSES with the consumer instead of
      standing as a copy."""
    oh = jax.lax.broadcasted_iota(jnp.int32, (ring.shape[0], 1), 0) == row
    return jnp.where(oh, blk[None, :], ring)


def rowring_push(ring, row, blk):
    """Write one block into its slot and advance the row pointer."""
    return rowring_write(ring, row, blk), jnp.mod(row + 1, ring.shape[0])


def feedback_delay_block_rows(ring, row, x, d_samples, feedback, min_delay: int,
                              n_iters: int | None = None):
    """``feedback_delay_block`` on a block-row ring: same math
    (delay_kernel, delay.py:7-22), O(blocksize) state maintenance.

    ring: (R, N) written values w; row: current slot; x: (N,).
    n_iters: static fixed-point pass count override; defaults to the
    worst case ceil(n / min_delay).  Callers that can prove d >= n for the
    whole block (the common long-delay case) pass 1 — see
    models/delay.py's scalar ``lax.cond`` dispatch.  (A dynamic-trip
    while_loop was tried and is a trap: XLA's vmapped-while lowering
    carries the whole ring through the loop state and spills to scratch.)

    Returns (y, new_ring) — the caller advances the shared row pointer.
    """
    n = x.shape[-1]
    n_idx = jnp.arange(n)
    base_hist = rowring_read(ring, row, d_samples, n)
    in_hist = n_idx < d_samples

    k = n_iters or max(1, -(-n // max(1, min_delay)))
    y = _feedback_solve(x, base_hist, in_hist, d_samples, feedback, k)
    w = x + feedback * y
    return y, rowring_write(ring, row, w)


def _feedback_solve(x, base_hist, in_hist, d, feedback, k: int):
    """Solve y[n] = (base_hist[n] if n < d else x[n-d] + fb*y[n-d]) by
    geometric DOUBLING of the affine fixed point: with zero-filling shifts
    S_m, y = sum_j fb^j S_{j*d} c for c = where(n < d, base_hist, x[n-d]),
    and the partial sum doubles via P_{2m} = P_m + fb^m S_{m*d} P_m —
    ceil(log2(k)) dynamic shifts instead of k (k can reach ~90 at
    superblock sizes, which as a plain unroll also explodes XLA compile
    time)."""
    n = x.shape[-1]
    if k <= 1:
        return jnp.where(in_hist, base_hist, 0.0)
    c = jnp.where(in_hist, base_hist, _shift_dyn(x, d))
    y = c
    m = 1
    amp = feedback
    while m < k:
        shift = jnp.minimum(m * d, n)  # clamp: shifts past the block are 0
        y = y + amp * _shift_dyn(y, shift)
        amp = amp * amp
        m *= 2
    return y


def _shift_dyn(y, d):
    """y[n - d] with zeros for n < d; ``d`` may be traced (int32 scalar).

    Small blocks evaluate the shift directly as a shifted-identity
    contraction sel[i, j] = (i + d == j): out[j] = y[j - d], zeros where
    j < d fall out of the empty column — half the select-matrix volume
    of padding to 2n and lane-slicing (and exact, like all the one-hot
    selects).  Long signals use a contiguous dynamic_slice of the
    zero-padded signal — never a gather."""
    n = y.shape[-1]
    if n <= _LANE_MM_MAX:
        # lane_dynamic_slice at start = -d IS the shifted identity
        # sel[i, j] = (i == j - d): out[j] = y[j - d], zeros where j < d
        # fall out of the empty columns.
        return lane_dynamic_slice(y, -d, n)
    padded = jnp.concatenate([jnp.zeros_like(y), y], axis=-1)
    return jax.lax.dynamic_slice_in_dim(padded, n - d, n, axis=-1)


def delay_read(hist, x, d_samples):
    """Pure delay: y[n] = stream[n - d], stream = hist ++ x.

    Port of ``pure_delay_kernel`` (reverb.py:12-31).  ``d_samples`` is a
    traced int32 scalar in [0, S] where S = hist length; d = 0 passes
    ``x`` through unchanged (reverb.py:14-22).  The read window is
    contiguous, so it lowers to one dynamic_slice.

    hist: (..., S) chronological; x: (..., N).  Returns y: (..., N).
    """
    s = hist.shape[-1]
    n = x.shape[-1]
    ext = jnp.concatenate([hist, x], axis=-1)
    if n <= _LANE_MM_MAX and ext.ndim == 1:
        return chrono_window(ext, s - d_samples, n)
    return jax.lax.dynamic_slice_in_dim(ext, s - d_samples, n, axis=-1)


def feedback_delay_block(hist, x, d_samples, feedback, min_delay: int):
    """Feedback echo over one block (port of delay_kernel, delay.py:7-22).

        y[n] = w[n - d]           (the delayed read)
        w[n] = x[n] + feedback * y[n]   (written back into the line)

    hist: (S,) chronological history of *written* values w.
    d_samples: traced int32 in [min_delay, S].
    min_delay: static lower bound on d, sets the fixed-point iteration
      count K = ceil(N / min_delay).

    Returns (y, new_hist).
    """
    s = hist.shape[-1]
    n = x.shape[-1]
    n_idx = jnp.arange(n)

    # Reads that land in the history region (n < d): one dynamic_slice.
    ext = jnp.concatenate([hist, jnp.zeros((n,), hist.dtype)], axis=-1)
    base_hist = jax.lax.dynamic_slice_in_dim(ext, s - d_samples, n, axis=-1)
    in_hist = n_idx < d_samples

    k = max(1, -(-n // max(1, min_delay)))
    y = _feedback_solve(x, base_hist, in_hist, d_samples, feedback, k)
    w = x + feedback * y
    return y, ring_push(hist, w)


def comb_damped_block(hist, lp_prev, x, g, h):
    """Damped feedback comb over one block (port of comb_damped_kernel,
    reverb.py:33-46).  Lag equals the history length L (static).

        y[n]      = w[n - L]
        damped[n] = (1-h) * y[n] + h * damped[n-1]
        w[n]      = x[n] + g * damped[n]

    hist: (L,) chronological written values; lp_prev: scalar damping state.
    Returns (y, new_hist, new_lp).
    """
    from aefs_tpu.ops.scan import affine_scan

    lag = hist.shape[-1]
    n = x.shape[-1]

    if n <= lag:
        # All reads predate this block: y is just the history head.
        y = hist[:n]
        damped = affine_scan(h, (1.0 - h) * y, lp_prev)
    else:
        # Fixed point: corrections propagate L samples per iteration.
        n_idx = jnp.arange(n)
        hist_pad = jnp.pad(hist, (0, n - lag))
        x_shift = jnp.concatenate([jnp.zeros((lag,), x.dtype), x[:-lag]])
        in_hist = n_idx < lag
        k = -(-n // lag)
        y = jnp.zeros_like(x)
        damped = jnp.zeros_like(x)
        for _ in range(k):
            damped = affine_scan(h, (1.0 - h) * y, lp_prev)
            d_shift = jnp.concatenate([jnp.zeros((lag,), x.dtype), damped[:-lag]])
            y = jnp.where(in_hist, hist_pad, x_shift + g * d_shift)
        damped = affine_scan(h, (1.0 - h) * y, lp_prev)

    w = x + g * damped
    return y, ring_push(hist, w), damped[-1]


def comb_bank_block(hists, lps, x, lags, g, h, min_lag: int):
    """A bank of damped feedback combs sharing one input (the reverb's four
    parallel combs per side, reverb.py:234-241), vectorized over the bank.

    Buffers are padded to a common length: ``hists[b, -lags[b]:]`` is comb
    b's real chronological window; reads at lag L land at
    ``hists[b, Lmax - L + n]`` so differing lags stay a single gather.

    hists: (B, Lmax); lps: (B,) damping states; x: (N,) shared input or
    (B, N) per-comb inputs (e.g. both stereo sides' banks merged into one
    call); lags: (B,) int32; g: (B,) feedback gains; h: scalar damping;
    min_lag: static lower bound of lags, sets the fixed-point count.

    Returns (y, new_hists, new_lps) with y: (B, N) raw delayed outputs
    (the comb output is the undamped read, reverb.py:41-43).
    """
    from aefs_tpu.ops.scan import const_affine_hillis

    b, lmax = hists.shape
    n = x.shape[-1]
    n_idx = jnp.arange(n)

    # History reads are contiguous windows at per-comb offsets: one
    # dynamic_slice per comb (B descriptors), never a per-element gather.
    ext = jnp.concatenate([hists, jnp.zeros((b, n), hists.dtype)], axis=-1)
    base_hist = jax.vmap(
        lambda row, lag: jax.lax.dynamic_slice_in_dim(row, lmax - lag, n)
    )(ext, lags)  # valid where n < lag
    in_hist = n_idx[None, :] < lags[:, None]

    xb = jnp.broadcast_to(x, (b, n)) if x.ndim == 1 else x
    shift = jax.vmap(_shift_dyn, in_axes=(0, 0))
    x_shift = shift(xb, lags)
    lps_col = lps[:, None]
    g_col = g[:, None]

    k = max(1, -(-n // max(1, min_lag)))
    y = jnp.zeros((b, n), x.dtype)
    for _ in range(k):
        damped = const_affine_hillis(h, (1.0 - h) * y, lps_col)
        y = jnp.where(in_hist, base_hist, x_shift + g_col * shift(damped, lags))
    damped = const_affine_hillis(h, (1.0 - h) * y, lps_col)

    w = xb + g_col * damped
    new_hists = jnp.concatenate([hists, w], axis=-1)[:, -lmax:]
    return y, new_hists, damped[:, -1]


def comb_bank_block_static(hists, lps, x, lags, g, h):
    """Streaming comb bank for blocks no longer than the shortest lag
    (always true at mic blocksizes — min comb lag ~29.4 ms vs 5.3 ms
    blocks): every lag-L read predates the block, so the outputs are
    STATIC per-comb history windows (lags are compile-time topology,
    reverb.py:158-177), and the damping recurrence — constant-coefficient
    within a block — is a log-depth Hillis prefix with h^s by repeated
    squaring (``const_affine_hillis``).  No dynamic slices, no
    sequential scans, and no (N, N) Toeplitz propagator (too much memory
    traffic once the serving pool vmaps it per stream).

    hists: (B, Lmax); lps: (B,); x: (N,) shared or (B, N) per-comb input;
    lags: static ints (B,); g: (B,) traced; h: traced scalar.
    Returns (y, new_hists, new_lps) like ``comb_bank_block``.
    """
    from aefs_tpu.ops.scan import const_affine_hillis

    b, lmax = hists.shape
    n = x.shape[-1]
    lags = tuple(int(l) for l in lags)
    assert n <= min(lags), (n, lags)
    xb = jnp.broadcast_to(x, (b, n)) if x.ndim == 1 else x

    y = jnp.stack([hists[c, lmax - lag : lmax - lag + n] for c, lag in enumerate(lags)])

    # Constant-coefficient damping recurrence as a Hillis prefix over
    # lanes (ops/scan.py:const_affine_hillis).  The previous closed form
    # (one T_h Toeplitz matmul) materializes an (N, N) propagator, which
    # under the serving pool's stream vmap becomes (S, N, N) — ~33 MB of
    # memory traffic per step at S=128 against ~1 MB here.
    damped = const_affine_hillis(h, (1.0 - h) * y, lps[:, None])
    w = xb + g[:, None] * damped
    new_hists = jnp.concatenate([hists, w], axis=-1)[:, -lmax:]
    return y, new_hists, damped[:, -1]


def comb_chunk(lags) -> int:
    """Chunk size C of the whole-signal comb solve: C = min(lags), valid
    when every lag satisfies C <= L < 2C (each chunk then reads only the
    two chunks before it)."""
    c = min(int(l) for l in lags)
    if not all(c <= lag < 2 * c for lag in lags):
        raise ValueError(f"comb lags {tuple(lags)} violate C <= L < 2C for C={c}")
    return c


def comb_bank_file(x, lags, g, h, side_of=None):
    """Whole-signal damped comb bank from *fresh* state — the file-mode
    fast path (one pass over the entire signal, no per-block scan).

    The joint recurrence (reverb.py:33-46, rewritten on the damped state)

        y[n]      = x[side_of[b], n - L_b] + g_b * damped[n - L_b]
        damped[n] = h * damped[n-1] + (1 - h) * y[n]

    is solved in chunks of C samples (``comb_chunk``): every lag-L read
    lands in the previous two chunks, never the current one.  Lowered for
    the GPU this is the Triton kernel (ops/pallas/comb.py); elsewhere the
    plain ``lax.scan`` of ``_comb_bank_scan``.

    x: (S, N) raw source signals; comb b reads ``x[side_of[b]]`` at lag
    ``lags[b]`` (``side_of`` defaults to the identity, S == B).
    lags: static python ints (B,); g: (B,) traced gains; h: traced damping.

    Returns (y, damped), both (B, N): raw comb outputs and damping states
    (from which the final ring state is reconstructed: w = x + g * damped).
    """
    from aefs_tpu.ops.pallas import gpu_or_plain

    lags = tuple(int(l) for l in lags)
    side_of = tuple(range(len(lags))) if side_of is None else tuple(side_of)
    c = comb_chunk(lags)
    n = x.shape[-1]
    y, damped = gpu_or_plain(
        _comb_kernel(lags, side_of, c),
        lambda x, g, h: _comb_bank_scan(x, lags, g, h, side_of, c),
        x, jnp.asarray(g, jnp.float32), jnp.asarray(h, jnp.float32),
    )
    return y[:, :n], damped[:, :n]


def _comb_kernel(lags, side_of, c):
    """The Triton comb kernel for one static topology as a single-signal
    op.  Under ``vmap`` (batch rendering) the batch folds into the
    kernel's own file axis — one launch, one program per (file, comb)."""
    from aefs_tpu.ops.pallas.comb import comb_bank_pallas

    @jax.custom_batching.custom_vmap
    def files(x, g, h):  # x: (F, S, N), g: (F, B), h: (F,)
        return comb_bank_pallas(x, g, h, lags, side_of, c)

    @files.def_vmap
    def _files_vmap(axis_size, in_batched, x, g, h):
        args = [
            a if bat else jnp.broadcast_to(a, (axis_size,) + a.shape)
            for a, bat in zip((x, g, h), in_batched)
        ]
        lead = args[0].shape[:2]  # (batch, F)
        y, d = files(*(a.reshape((-1,) + a.shape[2:]) for a in args))
        return (y.reshape(lead + y.shape[1:]), d.reshape(lead + d.shape[1:])), (
            True, True)

    def one(x, g, h):
        y, d = files(x[None], g[None], h[None])
        return y[0], d[0]

    return one


def _comb_bank_scan(x, lags, g, h, side_of, c):
    """Plain-XLA comb bank: one ``lax.scan`` step per chunk, the in-chunk
    damping as a lower-triangular Toeplitz product T_h[j, i] = h^(j-i).
    Returns (y, damped) as (B, M*C)."""
    from jax import lax

    _, n = x.shape
    b = len(lags)
    m = -(-n // c)
    n_pad = m * c
    # Per-comb lag-shifted chunks, built chunk-major: (M, B, C).
    xs = jnp.stack(
        [
            jnp.pad(x[side_of[i]], (lag, n_pad - n))[:n_pad].reshape(m, c)
            for i, lag in enumerate(lags)
        ],
        axis=1,
    )
    j_i = jnp.arange(c)[:, None] - jnp.arange(c)[None, :]
    t_h = jnp.where(j_i >= 0, jnp.power(h, jnp.maximum(j_i, 0).astype(x.dtype)), 0.0)
    hpow = jnp.power(h, jnp.arange(1, c + 1, dtype=x.dtype))  # h^(j+1)
    g_col = g[:, None]
    one_mh = 1.0 - h

    def step(carry, xs_chunk):
        prev2, prev1, d_last = carry
        ext = jnp.concatenate([prev2, prev1], axis=1)  # (B, 2C)
        # damped[n - L] = ext[b, 2C - L + j]: a static slice per comb.
        r = jnp.stack([ext[i, 2 * c - lag : 3 * c - lag] for i, lag in enumerate(lags)])
        y = xs_chunk + g_col * r
        damped = (
            jnp.einsum("ji,bi->bj", t_h, one_mh * y, precision=DOT_PRECISION)
            + d_last[:, None] * hpow[None, :]
        )
        return (prev1, damped, damped[:, -1]), (y, damped)

    zeros = jnp.zeros_like(xs[0])  # (B, C), typed like the signal (shard_map)
    _, (ys, damps) = lax.scan(step, (zeros, zeros, zeros[:, 0]), xs)
    return (jnp.moveaxis(ys, 0, 1).reshape(b, n_pad),
            jnp.moveaxis(damps, 0, 1).reshape(b, n_pad))


def allpass_block(hist, x, a, lag: int):
    """Gardner/Moorer allpass diffuser over one block (port of
    allpass_kernel, reverb.py:48-67).  ``lag`` is static (reverb topology
    is fixed at prepare time, reverb.py:158-177).

        y[n] = w[n - lag] - a * x[n]
        w[n] = x[n] + a * y[n]

    which unrolls to the lag-affine recurrence
        y[n] = base[n] + a * y[n - lag],
        base[n] = (hist[n] if n < lag else x[n - lag]) - a * x[n]

    hist: (lag,) chronological written values.  Returns (y, new_hist).
    """
    from aefs_tpu.ops.scan import lag_affine_scan

    n = x.shape[-1]
    if n <= lag:
        delayed = hist[:n]
        y = delayed - a * x
    else:
        head = hist - a * x[:lag]
        tail = x[: n - lag] - a * x[lag:]
        base = jnp.concatenate([head, tail])
        k = (n - 1) // lag  # highest feedback order reaching into the block
        if k <= 8:
            # Streaming blocks (n a few lags at most): unroll the lag-affine
            # solution y = sum_j a^j base[n - j*lag] as static-shift Horner
            # steps — a handful of aligned pad/slice ops instead of a
            # residue-class reshape at an unaligned lane width.
            zeros = jnp.zeros((lag,), x.dtype)
            y = base
            for _ in range(k):
                y = base + a * jnp.concatenate([zeros, y[:-lag]])
        else:
            y = lag_affine_scan(base, a, lag)

    w = x + a * y
    return y, ring_push(hist, w)


def cubic_hermite(frac, y0, y1, y2, y3):
    """4-point Hermite interpolation (port of cubic_interp, octaver.py:9-15)."""
    c0 = y1
    c1 = 0.5 * (y2 - y0)
    c2 = y0 - 2.5 * y1 + 2.0 * y2 - 0.5 * y3
    c3 = 0.5 * (y3 - y0) + 1.5 * (y1 - y2)
    return ((c3 * frac + c2) * frac + c1) * frac + c0


def cubic_tap_weights(fr):
    """4-point cubic-Hermite (Catmull-Rom) tap weights at fraction fr —
    the basis polynomials ``fractional_read_cubic`` evaluates (reference
    octaver.py:9-15), factored out so callers that need the weights and
    the one-hot positions SEPARATELY (the flanger's split tap operator)
    share one definition with the fused ``cubic_onehot_matrix``."""
    w0 = fr * (-0.5 + fr * (1.0 - 0.5 * fr))
    w1 = 1.0 + fr * fr * (-2.5 + 1.5 * fr)
    w2 = fr * (0.5 + fr * (2.0 - 1.5 * fr))
    w3 = fr * fr * (0.5 * fr - 0.5)
    return w0, w1, w2, w3


def onehot_matrix(t0, length: int):
    """(…, N, length) float32 one-hot rows: row i is e_{t0[i]}.

    The single-comparison building block of the dense tap operators: one
    compare per (row, col) instead of ``cubic_onehot_matrix``'s four
    compare+FMA passes — callers reconstruct the 4-tap structure with
    static SHIFTED SLICES of this matrix (tap k at column t0+k is this
    matrix's column t0 read k entries earlier), which is 4x less build
    work when the operator feeds many contractions (flanger file path)."""
    col = jnp.arange(length, dtype=jnp.int32)
    return (col == t0[..., None]).astype(jnp.float32)


def cubic_onehot_matrix(t0, fr, length: int):
    """Dense one-hot form of the 4-tap cubic-Hermite read operator.

    Materializes the read ``fractional_read_cubic`` performs as a
    weight matrix W with W[..., i, t0[i] + k] = w_k(fr[i]) — four int
    comparisons carrying the Hermite basis polynomials — so a tap
    becomes one matrix contraction instead of a vmapped dynamic_slice
    with per-batch starts (a gather with one start per row).  Worth it whenever the operator is reused (the
    flanger's sweep loop) or lives inside a scan at step cadence (the
    chorus's chunked file pass); positions must already be in-range
    (no wrap patch).

    t0: (..., N) int32 — ext column of the FIRST tap (y0) per row;
    fr: (..., N) float32 interpolation fraction; length: ext width L.
    Returns (..., N, L) float32.
    """
    col = jnp.arange(length, dtype=jnp.int32)
    w0, w1, w2, w3 = cubic_tap_weights(fr)
    t = t0[..., None]
    return (
        w0[..., None] * (col == t)
        + w1[..., None] * (col == t + 1)
        + w2[..., None] * (col == t + 2)
        + w3[..., None] * (col == t + 3)
    )


def fractional_read_cubic(hist, x, ago):
    """Cubic-interpolated tap at a fractional distance into the past.

    Port of the tap logic in pitch_shift_kernel_cubic (octaver.py:37-62),
    re-derived in chronological coordinates: the reference reads ring
    positions floor(w - a + size) + {-1, 0, 1, 2} (mod size), which are the
    samples (ceil(a) + {1, 0, -1, -2}) mod size in the past, interpolated at
    frac = ceil(a) - a.

    hist: (S,) last S input samples (the octaver writes raw input, so the
      whole extended stream is known up front and the read is one parallel
      gather — no recurrence).
    x: (N,) current block; ago: (N,) float distances a = p * size in [0, S).

    Returns (N,) interpolated samples.
    """
    s = hist.shape[-1]
    n = x.shape[-1]
    ext = jnp.concatenate([hist, x])
    ca = jnp.ceil(ago)
    frac = (ca - ago).astype(x.dtype)
    ca = ca.astype(jnp.int32)
    base = s + jnp.arange(n)

    # The four taps sit at consecutive ext indices (ago = ca+1 .. ca-2), so
    # the bulk fetch is ONE 4-wide sliced gather (N starts, not 4N);
    # ring-boundary wrap
    # lanes are patched afterwards (_wrap_patch).
    start = jnp.clip(base - (ca + 1), 0, s + n - 4)
    quads = jax.vmap(lambda i: jax.lax.dynamic_slice(ext, (i,), (4,)))(start)

    bulk = cubic_hermite(frac, quads[:, 0], quads[:, 1], quads[:, 2], quads[:, 3])
    return _wrap_patch(ext, s, n, ca, frac, bulk)


def _wrap_patch(ext, s, n, ca, frac, bulk):
    """Overwrite the rare ring-boundary lanes with the reference's wrap
    semantics (octaver.py:45-48): when ca is within 1 of the ring boundary,
    the wrapped ago values all land in {0, 1, 2} or {s-3, s-2, s-1}, whose
    reads are *static shifts* of the stream — no extra gather."""
    shifts = {
        j: ext[s - j : s - j + n] for j in (0, 1, 2, s - 3, s - 2, s - 1)
    }

    def wrap_tap(offset):
        back = jnp.mod(ca + offset, s)
        out = shifts[0]
        for j in (1, 2, s - 3, s - 2, s - 1):
            out = jnp.where(back == j, shifts[j], out)
        return out

    needs_wrap = (ca <= 1) | (ca >= s - 1)
    wrapped = cubic_hermite(frac, wrap_tap(1), wrap_tap(0), wrap_tap(-1), wrap_tap(-2))
    return jnp.where(needs_wrap, wrapped, bulk)
