"""Blocked linear-recurrence solvers (associative scans).

The reference implements every IIR recurrence as a per-sample Numba loop
(biquad_kernel filter.py:8-40, comb damping reverb.py:39-41, gate smoothing
gate.py:33-36).  On the device a per-sample loop serializes; instead we
solve each recurrence for a whole block at once:

- first-order affine recurrences  y[n] = m[n]*y[n-1] + b[n]
  -> ``affine_scan`` (log-depth ``lax.associative_scan``)
- second-order recurrences (biquad) -> ``biquad_block`` via 2x2
  companion-matrix prefix products
- lag-L recurrences  y[n] = b[n] + a*y[n-L]  (allpass diffusers)
  -> ``lag_affine_scan``: reshape to (M, L) residue classes, scan over rows

All math is float32 end-to-end (matching the reference kernels); parity vs
the float64 NumPy oracles is enforced at <= -80 dBFS by tests/test_ops.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from aefs_tpu.ops.precision import DOT_PRECISION


def affine_scan(mult, add, init, axis: int = 0):
    """Solve y[n] = mult[n] * y[n-1] + add[n] with y[-1] = init.

    Args:
      mult: multiplier per step; broadcastable to ``add`` along ``axis``
        (e.g. shape ``(N, 1)`` against ``add`` of ``(N, L)``, or ``(N,)``).
      add: additive term per step, scan runs along ``axis``.
      init: carried-in value y[-1] (broadcastable to one slice of ``add``).

    Returns:
      y with the same shape as ``add``.
    """
    add = jnp.asarray(add)
    mult = jnp.broadcast_to(jnp.asarray(mult, add.dtype), _bshape(mult, add, axis))

    def combine(e1, e2):
        a1, b1 = e1
        a2, b2 = e2
        return a2 * a1, a2 * b1 + b2

    a_cum, b_cum = lax.associative_scan(combine, (mult, add), axis=axis)
    return a_cum * init + b_cum


def affine_scan_long(mult, add, init, chunk: int = 512):
    """1-D ``affine_scan`` for long signals, two-level blocked: an
    in-chunk scan over (N/chunk, chunk) rows, then a tiny cross-row affine
    scan over the row summaries.

    The in-chunk scan is a hand-rolled Hillis-Steele over contiguous
    lane shifts (pad + static slice), NOT ``lax.associative_scan``: the
    Blelloch lowering emits strided slices in the lane dimension
    (``[0:c:2]``), which cost a layout pass each on the platform this was
    first tuned for.  Same math, one
    reassociation (max observed divergence 6e-7, far under the -80 dBFS
    oracle bar).

    mult, add: (N,); init: scalar.  Returns y: (N,).
    """
    n = add.shape[0]
    c = int(chunk)
    if n <= c:
        return affine_scan(mult, add, init)
    m = -(-n // c)
    dt = add.dtype
    a_c = jnp.pad(jnp.broadcast_to(mult, (n,)), (0, m * c - n),
                  constant_values=1.0).reshape(m, c)
    b_c = jnp.pad(add, (0, m * c - n)).reshape(m, c)

    s = 1
    while s < c:  # inclusive prefix of the affine maps, doubling span
        a_sh = jnp.pad(a_c, ((0, 0), (s, 0)), constant_values=1.0)[:, :c]
        b_sh = jnp.pad(b_c, ((0, 0), (s, 0)))[:, :c]
        b_c = a_c * b_sh + b_c
        a_c = a_c * a_sh
        s *= 2

    def combine(e1, e2):
        a1, b1 = e1
        a2, b2 = e2
        return a2 * a1, a2 * b1 + b2

    sa, sb = lax.associative_scan(combine, (a_c[:, -1], b_c[:, -1]))
    s_out = sa * init + sb  # value leaving each row
    s_in = jnp.concatenate([jnp.asarray(init, dt)[None], s_out[:-1]])
    y = a_c * s_in[:, None] + b_c
    return y.reshape(m * c)[:n]


def affine_hillis(mult, add, init):
    """``affine_scan`` over the LAST axis as a hand-rolled Hillis-Steele:
    log2(N) levels of contiguous pad + static slice + FMA on the (a, b)
    pair.  Same math as ``lax.associative_scan`` up to reassociation, but
    none of its Blelloch strided lane slices (``[0:c:2]``; see
    ``affine_scan_long``).

    mult, add: (..., N) with matching shapes (broadcast ``mult`` first);
    init: broadcastable to one last-axis slice.  Returns y = (..., N).
    """
    add = jnp.asarray(add)
    n = add.shape[-1]
    a = jnp.broadcast_to(jnp.asarray(mult, add.dtype), add.shape)
    b = add
    pad = [(0, 0)] * (add.ndim - 1)
    s = 1
    while s < n:
        a_sh = jnp.pad(a, pad + [(s, 0)], constant_values=1.0)[..., :n]
        b_sh = jnp.pad(b, pad + [(s, 0)])[..., :n]
        b = a * b_sh + b
        a = a * a_sh
        s *= 2
    return a * jnp.asarray(init, add.dtype) + b


def maxtimes_hillis(mult, add, init):
    """Solve y[n] = max(add[n], mult[n] * y[n-1]) over the LAST axis,
    y[-1] = init — the (max, x) semiring analogue of ``affine_hillis``.

    The map y -> max(b, a*y) with a >= 0 composes associatively:
    (a2, b2) o (a1, b1) = (a1*a2, max(b2, a2*b1)) — multiplication by a
    nonnegative constant distributes over max.  This is the decay stage
    of a peak detector (compressor/limiter envelope): a = per-sample
    release multiplier in (0, 1), b = |x| >= 0, entirely in the LINEAR
    domain (no per-sample log/exp).  Identity element (1, 0) — valid
    because every operand is nonnegative.

    mult, add: (..., N) nonnegative (broadcast ``mult`` first);
    init: nonnegative, broadcastable to one last-axis slice.
    """
    add = jnp.asarray(add)
    n = add.shape[-1]
    a = jnp.broadcast_to(jnp.asarray(mult, add.dtype), add.shape)
    b = add
    pad = [(0, 0)] * (add.ndim - 1)
    s = 1
    while s < n:
        a_sh = jnp.pad(a, pad + [(s, 0)], constant_values=1.0)[..., :n]
        b_sh = jnp.pad(b, pad + [(s, 0)])[..., :n]  # pad 0 = max identity
        b = jnp.maximum(a * b_sh, b)
        a = a * a_sh
        s *= 2
    return jnp.maximum(a * jnp.asarray(init, add.dtype), b)


def maxtimes_scan_long(mult, add, init, chunk: int = 512):
    """1-D ``maxtimes_hillis`` for long signals, two-level blocked exactly
    like ``affine_scan_long``: in-chunk Hillis over (N/chunk, chunk) rows,
    then a tiny cross-row (max, x) scan over the row summaries.

    mult, add: (N,) nonnegative; init: nonnegative scalar.  Returns (N,).
    """
    n = add.shape[0]
    c = int(chunk)
    if n <= c:
        return maxtimes_hillis(mult, add, init)
    m = -(-n // c)
    dt = add.dtype
    a_c = jnp.pad(jnp.broadcast_to(mult, (n,)), (0, m * c - n),
                  constant_values=1.0).reshape(m, c)
    b_c = jnp.pad(add, (0, m * c - n)).reshape(m, c)

    s = 1
    while s < c:
        a_sh = jnp.pad(a_c, ((0, 0), (s, 0)), constant_values=1.0)[:, :c]
        b_sh = jnp.pad(b_c, ((0, 0), (s, 0)))[:, :c]
        b_c = jnp.maximum(a_c * b_sh, b_c)
        a_c = a_c * a_sh
        s *= 2

    def combine(e1, e2):
        a1, b1 = e1
        a2, b2 = e2
        return a2 * a1, jnp.maximum(a2 * b1, b2)

    sa, sb = lax.associative_scan(combine, (a_c[:, -1], b_c[:, -1]))
    s_out = jnp.maximum(sa * init, sb)  # value leaving each row
    s_in = jnp.concatenate([jnp.asarray(init, dt)[None], s_out[:-1]])
    y = jnp.maximum(a_c * s_in[:, None], b_c)
    return y.reshape(m * c)[:n]


def const_affine_hillis(h, add, init):
    """Solve y[n] = h * y[n-1] + add[n] over the LAST axis for a
    constant (traced, broadcastable) coefficient ``h``, y[-1] = init.

    Hillis-Steele span doubling with ``h^s`` tracked by repeated
    squaring: log2(N) levels of contiguous pad + static slice + FMA on
    the ``add`` tensor itself.  Two wins over the alternatives for the
    batched serving step (one chain per vmapped stream, per-stream h):

    - vs the T_h Toeplitz matmul (``comb_bank_block_static``'s original
      closed form): no (S, N, N) propagator materialization — the
      batched build wrote/read ~33 MB per step at S=128, N=256 where
      this touches log2(N) x the (S, B, N) 1 MB operand;
    - vs ``lax.associative_scan``: no Blelloch strided lane slices
      (see ``affine_scan_long``).

    Same math as ``affine_scan`` up to reassociation (constant
    coefficient makes every combine exact in structure; observed
    divergence vs the float64 oracle stays under the -80 dBFS bar).

    h: scalar or broadcastable to ``add`` minus its last axis (e.g.
    (B, 1) against (B, N)); add: (..., N); init: broadcastable to one
    last-axis slice of ``add`` — e.g. (B, 1) against (B, N).
    Returns y with the shape of ``add``.
    """
    add = jnp.asarray(add)
    n = add.shape[-1]
    dt = add.dtype
    h = jnp.asarray(h, dt)
    assert not h.ndim or h.shape[-1] == 1, h.shape
    b = add
    hp = h
    pad = [(0, 0)] * (add.ndim - 1)
    s = 1
    while s < n:
        shifted = jnp.pad(b, pad + [(s, 0)])[..., :n]
        b = b + hp * shifted
        hp = hp * hp
        s *= 2
    # Carried-in value: y[n] += init * h^(n+1).
    hpow = h * jnp.power(h, jnp.arange(n, dtype=dt))
    return b + jnp.asarray(init, dt) * hpow


def _bshape(mult, add, axis):
    """Shape for mult: same scan-axis length as add, broadcast elsewhere."""
    mult = jnp.asarray(mult)
    if mult.ndim == 0:
        shape = [1] * add.ndim
        shape[axis] = add.shape[axis]
        return tuple(shape)
    return mult.shape


def lag_affine_scan(base, a, lag: int, row_chunk: int = 128):
    """Solve y[n] = base[n] + a * y[n-lag] for n >= lag, y[n] = base[n] else.

    ``lag`` must be static, ``a`` a (traced) scalar.  Samples fall into
    ``lag`` independent residue classes; reshaping to (M, lag) rows turns
    the recurrence into a first-order constant-coefficient scan over rows.

    Tiny row counts scan the rows directly.  Everything else (the reverb
    allpasses in file mode: lag 81 -> 11k rows; the 375 ms delay: 50 rows)
    uses the same closed form as the comb/biquad solvers: within a chunk
    of C rows the response is one lower-triangular Toeplitz matmul
    T[j, i] = a^(j-i), and the cross-chunk carries are an
    a^C-coefficient affine scan over the (M/C, lag) chunk summaries —
    ~2 passes over the signal instead of log2(M) scan levels.

    The blocking is EXACT at any C; C only trades einsum FLOPs
    (∝ N·C) against carry-scan levels (log2(M/C)).

    base: (N,) float32.  Returns y: (N,).
    """
    n = base.shape[-1]
    m = -(-n // lag)  # ceil
    dt = base.dtype
    a = jnp.asarray(a, dt)
    padded = jnp.pad(base, (0, m * lag - n)).reshape(m, lag)

    if m <= 8:
        y = affine_scan(a, padded, jnp.zeros((lag,), dt))
        return y.reshape(m * lag)[:n]

    c = min(int(row_chunk), -(-m // 8) * 8)  # sublane-aligned, <= row_chunk
    mp = -(-m // c)
    chunks = jnp.pad(padded, ((0, mp * c - m), (0, 0))).reshape(mp, c, lag)
    h = jnp.power(a, jnp.arange(c + 1, dtype=dt))  # a^j, j = 0..C
    t_a = toeplitz_lower(h, c)
    y_loc = jnp.einsum(
        "ji,kil->kjl", t_a, chunks, precision=DOT_PRECISION
    )
    # Cross-chunk carries: s_k = a^C * s_{k-1} + y_loc[k, -1, :], s_{-1} = 0.
    s = affine_scan(h[c], y_loc[:, -1, :], jnp.zeros((lag,), dt), axis=0)
    s_in = jnp.concatenate([jnp.zeros((1, lag), dt), s[:-1]], axis=0)
    y = y_loc + h[1 : c + 1][None, :, None] * s_in[:, None, :]
    return y.reshape(mp * c * lag)[: m * lag][:n]


def _combine2(e1, e2):
    """Associative combine for 2x2-matrix affine maps
    (M, b) -> elements (p, q, r, s, bu, bv): matrix [[p,q],[r,s]], vec [bu,bv]."""
    p1, q1, r1, s1, u1, v1 = e1
    p2, q2, r2, s2, u2, v2 = e2
    return (
        p2 * p1 + q2 * r1,
        p2 * q1 + q2 * s1,
        r2 * p1 + s2 * r1,
        r2 * q1 + s2 * s1,
        p2 * u1 + q2 * v1 + u2,
        r2 * u1 + s2 * v1 + v2,
    )


def toeplitz_lower(h, c: int):
    """Lower-triangular Toeplitz T[j, i] = h[j - i] (j >= i, else 0) for a
    (>= c)-length kernel ``h`` — built gather-free by the tile/reshape
    rotation trick: b[j, i] = u[(i + j) mod L] for u = 0^c ++ h[:c] ++ 0,
    then T = b[:, 1:c+1] reversed (c + j - i never wraps mod L = 2c+1)."""
    u = jnp.concatenate([jnp.zeros((c,), h.dtype), h[:c], jnp.zeros((1,), h.dtype)])
    el = 2 * c + 1
    b = jnp.tile(u, c + 1)[: c * (el + 1)].reshape(c, el + 1)
    return b[:, 1 : c + 1][:, ::-1]


def _signed_pow(p, k):
    """p**k for real (possibly negative or zero) p and integer k >= 0,
    elementwise and branch-free: sign(p)**k * exp(k * log|p|)."""
    mag = jnp.exp(k * jnp.log(jnp.maximum(jnp.abs(p), 1e-30)))
    mag = jnp.where(k == 0, 1.0, mag)  # p**0 = 1 even at p = 0
    odd = (k.astype(jnp.int32) % 2).astype(mag.dtype)
    return mag * jnp.where(p < 0, 1.0 - 2.0 * odd, 1.0)


def ar2_impulse(a1, a2, length: int):
    """h[0..length-1] of the AR(2) recurrence h[n] = -a1 h[n-1] - a2 h[n-2]
    (h[0] = 1), in CLOSED FORM over the pole structure — fully parallel
    (no sequential scan) and, unlike the log-doubling formulation this
    replaces, numerically stable at near-unit pole radius.  The doubling
    h[K+j] = p*h[j] + q*h[j-1] squares the companion-power entries
    (p, q ~ +-40 at q_filter ~ 6 with near-cancelling contributions), so
    float32 rounding compounded multiplicatively: measured |error| ~ 20
    on |h| <= 50 at pole radius 0.9985 (a legal RBJ biquad, fc=136 Hz,
    Q=6.1), which then fed an explosively wrong chunk-boundary transition
    in ``linrec2_file`` (~1e27 output).  Closed form vs the float64
    recurrence: |error| <= ~0.05 worst-case over the legal RBJ range —
    the remaining gap is the problem's own float32 conditioning.

    Poles p = -a1/2 +- sqrt(a1^2/4 - a2):
      complex (disc < 0):  h[n] = r^n sin((n+1)t)/sin t,  r e^{+-it} poles
      real    (disc > 0):  h[n] = (p1^{n+1} - p2^{n+1}) / (p1 - p2)
      critical (disc ~ 0): h[n] = (n+1) p^n
    selected branch-free with jnp.where (coefficients are traced).
    """
    dt = jnp.result_type(a1, jnp.float32)
    a1 = jnp.asarray(a1, dt)
    a2 = jnp.asarray(a2, dt)
    if length == 1:
        return jnp.ones((1,), dt)
    n = jnp.arange(length, dtype=dt)
    m = -0.5 * a1  # mean pole
    disc = m * m - a2
    scale = m * m + jnp.abs(a2) + 1e-30
    is_crit = jnp.abs(disc) <= 1e-6 * scale
    is_cplx = disc < 0

    # Complex pair r e^{+-it}: atan2 is well-conditioned at small angles.
    q_ = jnp.sqrt(jnp.maximum(-disc, 1e-30))
    r = jnp.sqrt(jnp.maximum(a2, 1e-30))
    t = jnp.arctan2(q_, m)
    r_n = jnp.exp(n * jnp.log(jnp.maximum(r, 1e-30)))
    h_cplx = r_n * jnp.sin((n + 1.0) * t) / jnp.maximum(
        jnp.sin(t), 1e-30
    )

    # Distinct real poles.
    s = jnp.sqrt(jnp.maximum(disc, 1e-30))
    h_real = (_signed_pow(m + s, n + 1.0) - _signed_pow(m - s, n + 1.0)) / (
        2.0 * s
    )

    # Repeated pole.
    h_crit = (n + 1.0) * _signed_pow(m, n)

    h = jnp.where(is_crit, h_crit, jnp.where(is_cplx, h_cplx, h_real))
    return h.at[0].set(1.0)


def linrec2_file(v, a1, a2, y1, y2, chunk: int = 256):
    """Constant-coefficient second-order recurrence over a whole signal:
    y[n] = v[n] - a1*y[n-1] - a2*y[n-2], solved in chunks (file-mode fast
    path for the biquad, the same design move as the comb bank's T_h solve,
    ops/ringbuf.py:comb_bank_file):

    - chunk-local response: one lower-triangular Toeplitz matmul against
      the impulse response h (~2 passes over the signal instead
      of the associative scan's ~40),
    - boundary responses: y[-1] contributes h[j+1], y[-2] contributes
      -a2*h[j] (exact, by induction on the recurrence),
    - cross-chunk (y[-1], y[-2]) states: a tiny 2x2 affine associative
      scan over the M = N/chunk chunk summaries.

    v: (N,); a1, a2, y1, y2: traced scalars.  Returns y: (N,).
    """
    n = v.shape[-1]
    c = int(chunk)
    m = -(-n // c)
    dt = v.dtype
    vp = jnp.pad(v, (0, m * c - n)).reshape(m, c)

    # Impulse response h[0..c] of the AR part (closed form over the pole
    # structure — NOT log-doubling, which ar2_impulse's docstring records
    # as catastrophically unstable at near-unit pole radius).
    h = jnp.asarray(ar2_impulse(a1, a2, c + 1), dt)

    t_mat = toeplitz_lower(h, c)
    y_local = jnp.einsum(
        "mi,ji->mj", vp, t_mat, precision=DOT_PRECISION
    )

    h1 = h[1 : c + 1]  # response to y[-1] = 1
    h2 = -a2 * h[:c]  # response to y[-2] = 1

    # Chunk-exit states s_k = (y[c-1], y[c-2]) obey s_k = G s_{k-1} + b_k.
    ones = jnp.ones((m,), dt)
    elems = (
        h1[c - 1] * ones, h2[c - 1] * ones,
        h1[c - 2] * ones, h2[c - 2] * ones,
        y_local[:, c - 1], y_local[:, c - 2],
    )
    cp, cq, cr, cs, cu, cv = lax.associative_scan(_combine2, elems)
    out1 = cp * y1 + cq * y2 + cu  # y[-1] entering chunk k+1
    out2 = cr * y1 + cs * y2 + cv  # y[-2] entering chunk k+1
    in1 = jnp.concatenate([jnp.asarray(y1, dt)[None], out1[:-1]])
    in2 = jnp.concatenate([jnp.asarray(y2, dt)[None], out2[:-1]])

    y = y_local + in1[:, None] * h1[None, :] + in2[:, None] * h2[None, :]
    return y.reshape(m * c)[:n]


def linrec2_file_fir(x, b0, b1, b2, a1, a2, x1, x2, y1, y2,
                     chunk: int = 256):
    """Whole biquad B(z)/A(z) over a long signal with the FIR part FOLDED
    into the chunk impulse response: y_base = x_chunks @ T(conv(b, h))
    plus two rank-1 x-boundary terms, then the same 2x2 carry scan as
    ``linrec2_file``.  Folding removes the shifted-x materializations
    (two lane-offset concats that XLA lowers as whole-signal
    dynamic-update-slices) and the
    separate v = B*x pass.

    Boundary algebra: within chunk k, v[0] reads x[-1] (via b1) and
    x[-2] (via b2), v[1] reads x[-1] (via b2) — all KNOWN samples of
    chunk k-1 (or the carried x1/x2 state for k=0), so their responses
    hx1 = b1*h + b2*shift(h), hx2 = b2*h join y_base outside the scan;
    only the y[-1]/y[-2] carries need the associative scan, exactly as
    in linrec2_file.

    x: (N,); coefficients and initial conditions are traced scalars.
    Returns y: (N,).
    """
    n = x.shape[-1]
    c = int(chunk)
    m = -(-n // c)
    dt = x.dtype
    xp = jnp.pad(x, (0, m * c - n)).reshape(m, c)

    h = jnp.asarray(ar2_impulse(a1, a2, c + 1), dt)  # AR impulse h[0..c]
    z1 = jnp.zeros((1,), dt)
    h_ba = (b0 * h[:c]
            + b1 * jnp.concatenate([z1, h[: c - 1]])
            + b2 * jnp.concatenate([z1, z1, h[: c - 2]]))
    t_mat = toeplitz_lower(h_ba, c)
    y_base = jnp.einsum(
        "mi,ji->mj", xp, t_mat, precision=DOT_PRECISION
    )

    # Previous-chunk x boundary samples (known, not part of the carry).
    xp1 = jnp.concatenate([jnp.asarray(x1, dt)[None], xp[:-1, c - 1]])
    xp2 = jnp.concatenate([jnp.asarray(x2, dt)[None], xp[:-1, c - 2]])
    hx1 = b1 * h[:c] + b2 * jnp.concatenate([z1, h[: c - 1]])
    hx2 = b2 * h[:c]
    y_base = y_base + xp1[:, None] * hx1[None, :] + xp2[:, None] * hx2[None, :]

    h1 = h[1 : c + 1]  # response to y[-1] = 1
    h2 = -a2 * h[:c]  # response to y[-2] = 1
    ones = jnp.ones((m,), dt)
    elems = (
        h1[c - 1] * ones, h2[c - 1] * ones,
        h1[c - 2] * ones, h2[c - 2] * ones,
        y_base[:, c - 1], y_base[:, c - 2],
    )
    cp, cq, cr, cs, cu, cv = lax.associative_scan(_combine2, elems)
    out1 = cp * y1 + cq * y2 + cu
    out2 = cr * y1 + cs * y2 + cv
    in1 = jnp.concatenate([jnp.asarray(y1, dt)[None], out1[:-1]])
    in2 = jnp.concatenate([jnp.asarray(y2, dt)[None], out2[:-1]])

    y = y_base + in1[:, None] * h1[None, :] + in2[:, None] * h2[None, :]
    return y.reshape(m * c)[:n]


def linrec2(v, a1, a2, y1, y2):
    """Solve y[n] = v[n] - a1*y[n-1] - a2*y[n-2] with y[-1]=y1, y[-2]=y2.

    v: (N,) float32; coefficients and initial conditions are scalars.
    Returns y: (N,).  2x2 companion-matrix prefix maps
    s[n] = M @ s[n-1] + [v[n], 0],  M = [[-a1, -a2], [1, 0]],
    s[n] = [y[n], y[n-1]], accumulated by a hand-rolled Hillis-Steele
    over contiguous lane shifts, the codebase's standard form for
    lane-axis scans (``lax.associative_scan`` there lowers to strided
    slices; see affine_scan_long).
    """
    n = v.shape[0]
    dt = v.dtype
    a1 = jnp.asarray(a1, dt)
    a2 = jnp.asarray(a2, dt)
    # Companion matrix components, constant across the block.
    cp = jnp.broadcast_to(-a1, (n,))
    cq = jnp.broadcast_to(-a2, (n,))
    cr = jnp.ones((n,), dt)
    cs = jnp.zeros((n,), dt)
    cu = v
    cv = jnp.zeros((n,), dt)

    def shift(x, k, fill):
        return jnp.concatenate([jnp.full((k,), fill, dt), x[: n - k]])

    k = 1
    while k < n:
        # e[j] <- combine(e[j - k], e[j]): matrix M @ M1, vector M @ b1 + b
        # (combine applies the right element AFTER the shifted left one);
        # identity fill (M1 = I, b1 = 0) past the left edge.
        p1 = shift(cp, k, 1.0)
        q1 = shift(cq, k, 0.0)
        r1 = shift(cr, k, 0.0)
        s1 = shift(cs, k, 1.0)
        u1 = shift(cu, k, 0.0)
        v1 = shift(cv, k, 0.0)
        cp, cq, cr, cs, cu, cv = (
            cp * p1 + cq * r1,
            cp * q1 + cq * s1,
            cr * p1 + cs * r1,
            cr * q1 + cs * s1,
            cp * u1 + cq * v1 + cu,
            cr * u1 + cs * v1 + cv,
        )
        k *= 2
    return cp * y1 + cq * y2 + cu


def minaffine_hillis(mult, add, cap, init):
    """Solve y[n] = min(cap[n], mult[n]*y[n-1] + add[n]) over the LAST
    axis, y[-1] = init — the capped-affine recurrence of a limiter's
    release smoother (rise exponentially, but never above the window
    floor).

    The map y -> min(c, a*y + b) with a >= 0 composes closed:
      f2 o f1 = (a2*a1,  a2*b1 + b2,  min(c2, a2*c1 + b2)),
    identity (1, 0, +inf) — so it Hillis-scans like ``affine_hillis``
    with one extra min lane.

    mult, add, cap: (..., N) with a >= 0 (broadcast ``mult`` first);
    init broadcastable to one last-axis slice.  Returns y = (..., N).
    """
    add = jnp.asarray(add)
    n = add.shape[-1]
    dt = add.dtype
    inf = jnp.asarray(jnp.inf, dt)
    a = jnp.broadcast_to(jnp.asarray(mult, dt), add.shape)
    b = add
    c = jnp.broadcast_to(jnp.asarray(cap, dt), add.shape)
    pad = [(0, 0)] * (add.ndim - 1)
    s = 1
    while s < n:
        a1 = jnp.pad(a, pad + [(s, 0)], constant_values=1.0)[..., :n]
        b1 = jnp.pad(b, pad + [(s, 0)])[..., :n]
        c1 = jnp.pad(c, pad + [(s, 0)], constant_values=jnp.inf)[..., :n]
        a, b, c = (
            a * a1,
            a * b1 + b,
            jnp.minimum(c, a * c1 + b),
        )
        s *= 2
    return jnp.minimum(c, a * jnp.asarray(init, dt) + b)


def window_min_trailing(ext, w: int, n: int):
    """min over the trailing ``w``-sample window, for the last ``n``
    positions of ``ext`` (..., H + n) with H >= w - 1 history.

    Log-doubling dilation: power-of-2 window mins by pairwise min with
    a static shift, then one overlapping combine for arbitrary w (valid
    for idempotent min, unlike sums).  All slices static.
    """
    m = ext
    k = 1
    while 2 * k <= w:
        m = jnp.minimum(m[..., k:], m[..., :-k])  # window 2k mins
        k *= 2
    # m[i] = min over [i, i+k) of ext; combine two k-windows covering w.
    if w > k:
        m = jnp.minimum(m[..., w - k:], m[..., : m.shape[-1] - (w - k)])
    return m[..., -n:]


def window_sum_trailing(ext, w: int, n: int):
    """Sum over the trailing ``w``-sample window for the last ``n``
    positions of ``ext`` — w decomposed in binary into DISJOINT
    power-of-2 chunk sums (sums cannot use the min's overlapping
    combine).  No long cumsum: every partial is a local sum of <= w
    terms, so float32 stays exact-ish at any signal length (a plain
    cumsum's running total loses ~ulp(N) per sample, catastrophic for
    gain signals at file lengths).
    """
    sums = {1: ext}
    k = 1
    while 2 * k <= w:
        s = sums[k]
        sums[2 * k] = s[..., k:] + s[..., :-k]
        k *= 2
    total = None
    off = 0  # distance already consumed at the window's trailing end
    k = 1
    while k <= w:
        if w & k:
            s = sums[k]
            sl = s[..., s.shape[-1] - n - off: s.shape[-1] - off]
            total = sl if total is None else total + sl
            off += k
        k *= 2
    return total


def mat2_affine_hillis(mp, mq, mr, ms, bu, bv, init1, init2):
    """Solve the order-2 VECTOR recurrence s[n] = M[n] @ s[n-1] + b[n]
    over the LAST axis, with PER-SAMPLE matrices — the time-varying
    generalization of ``linrec2`` (whose companion matrix is constant
    across the block; a MODULATED filter's is not).

    M[n] = [[mp, mq], [mr, ms]][n],  b[n] = [bu, bv][n],
    s[-1] = [init1, init2].

    All six coefficient arrays are (..., N) with matching shapes;
    init1/init2 broadcast to one last-axis slice.  Returns (s1, s2),
    each (..., N) — the state components at every n.

    Same hand-rolled Hillis-Steele as ``affine_hillis`` (contiguous
    pad + static slice per level, no strided lane slices); each of the
    log2(N) levels composes the affine maps: M <- M @ M1 (eight FMAs),
    b <- M @ b1 + b, with identity fill past the left edge.
    """
    bu = jnp.asarray(bu)
    dt = bu.dtype
    n = bu.shape[-1]
    shp = bu.shape
    cp = jnp.broadcast_to(jnp.asarray(mp, dt), shp)
    cq = jnp.broadcast_to(jnp.asarray(mq, dt), shp)
    cr = jnp.broadcast_to(jnp.asarray(mr, dt), shp)
    cs = jnp.broadcast_to(jnp.asarray(ms, dt), shp)
    cu = bu
    cv = jnp.broadcast_to(jnp.asarray(bv, dt), shp)
    pad = [(0, 0)] * (bu.ndim - 1)

    def shift(x, k, fill):
        return jnp.pad(x, pad + [(k, 0)], constant_values=fill)[..., :n]

    k = 1
    while k < n:
        p1 = shift(cp, k, 1.0)
        q1 = shift(cq, k, 0.0)
        r1 = shift(cr, k, 0.0)
        s1 = shift(cs, k, 1.0)
        u1 = shift(cu, k, 0.0)
        v1 = shift(cv, k, 0.0)
        cp, cq, cr, cs, cu, cv = (
            cp * p1 + cq * r1,
            cp * q1 + cq * s1,
            cr * p1 + cs * r1,
            cr * q1 + cs * s1,
            cp * u1 + cq * v1 + cu,
            cr * u1 + cs * v1 + cv,
        )
        k *= 2
    i1 = jnp.asarray(init1, dt)
    i2 = jnp.asarray(init2, dt)
    return cp * i1 + cq * i2 + cu, cr * i1 + cs * i2 + cv


def biquad_block(x, b0, b1, b2, a1, a2, state):
    """Direct-Form-I biquad over a block, per channel.

    Port of the reference biquad recurrence (filter.py:8-40) as an
    FIR part (shift-and-scale, fully parallel) + second-order scan.

    x: (C, N) float32
    state: (C, 4) float32, [x1, x2, y1, y2] per channel
    coefficients: traced scalars (constant within the block,
    filter.py:100-107).

    Returns (y, new_state).
    """
    c, n = x.shape
    x1 = state[:, 0:1]
    x2 = state[:, 1:2]
    y1 = state[:, 2]
    y2 = state[:, 3]

    if n >= 1024:
        # Long signals (file mode / superblocks): chunked Toeplitz solve
        # with the FIR folded into the chunk impulse response
        # (linrec2_file_fir) — one matrix product per 256-chunk versus the
        # associative scan's ~40 memory passes, and no shifted-x
        # materializations.  Streaming blocks keep the associative scan:
        # the matmul form loses ~12 dB under per-block coefficient glides
        # (boundary-state handoff cancellation at high Q), and profiling
        # shows the scan is NOT a hot spot at mic blocksizes.
        y = jax.vmap(
            lambda xx, i1, i2, j1, j2: linrec2_file_fir(
                xx, b0, b1, b2, a1, a2, i1, i2, j1, j2
            )
        )(x, x1[:, 0], x2[:, 0], y1, y2)
        xm1_last = x[:, -2]
    else:
        xm1 = jnp.concatenate([x1, x[:, :-1]], axis=1)[:, :n]  # x[n-1]
        xm2 = jnp.concatenate([x2, x1, x[:, :-2]], axis=1)[:, :n]  # x[n-2]
        v = b0 * x + b1 * xm1 + b2 * xm2
        y = jax.vmap(lambda vv, i1, i2: linrec2(vv, a1, a2, i1, i2))(v, y1, y2)
        xm1_last = xm1[:, -1]

    ym2 = y[:, -2] if n >= 2 else y1
    new_state = jnp.stack([x[:, -1], xm1_last, y[:, -1], ym2], axis=1)
    return y, new_state
