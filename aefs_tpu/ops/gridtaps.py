"""Closed-form octaver taps for exact power-of-two pitch ratios.

The octaver's pitch ratio is r = 2^(semitones/12) (reference
octaver.py:121-122); at whole-octave settings (semitones = 12*e — the
instrument's namesake use, including the flagship bench's -12) r = 2^e is
an exact binary float and, from fresh phase (file mode), every tap
position is an exact rational on a fixed grid:

    ago[n] = mod(n * (1 - r), S)          (phasor * ring size)
    q[n]   = S + n - ago[n]               (read position in hist ++ block)

For r = 1/D (D = 2^-e, pitch down) the positions advance 1/D per output
sample, so output lanes split into D *classes* by n mod D, each class
reading at a constant fractional offset c/D — the 4-point Hermite
interpolation (octaver.py:9-15) collapses into D static 4-tap FIRs of the
stream.  Within a grain (between phasor wraps, every D*M samples with
M = S/(D-1)) the integer read index advances by exactly +1, so each
grain's reads are ONE contiguous slice: the whole tap evaluation is
"FIR -> reshape into rows -> interleave classes", with zero gathers,
zero rolls and zero matvecs.  For r = R (pitch up) positions are all
integers with stride R: a strided view + overlapping rows.

This replaces the banded Pallas resampler on the file-mode fast path when
the baked ``file_semitones`` is a whole octave — and because every
position is exact (integer arithmetic end to end), it removes the float32
phase-accumulation floor entirely: parity vs the float64 oracle reaches
the <= -80 dBFS bar the rest of the framework meets.

Grain-restart lanes (ago crossing 0) keep the reference's ring-wrap
semantics via the shared ``_wrap_patch`` (ops/ringbuf.py, reference
octaver.py:45-48).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from aefs_tpu.ops.precision import DOT_PRECISION


def pow2_exponent(semitones):
    """e such that 2^(semitones/12) == 2^e exactly, else None."""
    if semitones is None:
        return None
    s = float(semitones)
    if not (-24.0 <= s <= 24.0) or s != round(s) or int(round(s)) % 12:
        return None
    return int(round(s)) // 12


def pow2_geometry_ok(size: int, e: int) -> bool:
    """Divisibility conditions for the exact grid decomposition."""
    s = int(size)
    if s % 2:
        return False
    if e == 0:
        return True
    if e < 0:
        d = 1 << (-e)
        if s % (d - 1):
            return False
        m = s // (d - 1)
        return m % 2 == 0
    r = 1 << e
    if s % (r - 1) or s % r or (s // 2) % r:
        return False
    mp = s // (r - 1)
    return mp % (2 * r) == 0


def _hermite_fir_weights(frac: float):
    """Static 4-tap weights: H(frac; y0..y3) of cubic_hermite
    (ops/ringbuf.py:292-298) collapsed per basis vector, in float64."""
    ws = []
    for k in range(4):
        y = [0.0] * 4
        y[k] = 1.0
        y0, y1, y2, y3 = y
        c0 = y1
        c1 = 0.5 * (y2 - y0)
        c2 = y0 - 2.5 * y1 + 2.0 * y2 - 0.5 * y3
        c3 = 0.5 * (y3 - y0) + 1.5 * (y1 - y2)
        ws.append(((c3 * frac + c2) * frac + c1) * frac + c0)
    return ws


def _fir_frac(ext, frac: float):
    """F[j] = H(frac; ext[j-1], ext[j], ext[j+1], ext[j+2]) — a static
    4-tap FIR (frac == 0 returns ext itself)."""
    if frac == 0.0:
        return ext
    w0, w1, w2, w3 = (np.float32(w) for w in _hermite_fir_weights(frac))
    e = jnp.pad(ext, (1, 2))
    n = ext.shape[0]
    return (
        w0 * e[0:n] + w1 * e[1 : n + 1] + w2 * e[2 : n + 2] + w3 * e[3 : n + 3]
    )


def _rows(f, start: int, stride: int, row_len: int, n_rows: int):
    """rows[k, u] = f[start + k*stride + u] for u < row_len, gather-free:
    reshape into stride-sized chunks and concat the (row_len/stride)
    consecutive slabs (rows may overlap when row_len > stride)."""
    n_slabs = -(-row_len // stride)
    need = (n_rows + n_slabs - 1) * stride
    f = f[start:]
    if f.shape[0] < need:
        f = jnp.pad(f, (0, need - f.shape[0]))
    chunks = f[:need].reshape(n_rows + n_slabs - 1, stride)
    if n_slabs == 1:
        return chunks[:, :row_len]
    rows = jnp.concatenate(
        [chunks[i : i + n_rows] for i in range(n_slabs)], axis=1
    )
    return rows[:, :row_len]


def _interleave_rows(rows):
    """out[k, u*d + c] = rows[c][k, u] — class streams interleaved back
    into time order.

    The obvious ``stack(rows, -1).reshape`` makes XLA materialize a
    layout-transposed copy of the whole grain tensor (a small minor dim
    d).  When the row length is a multiple of 128 the interleave is
    instead evaluated as d one-hot matrix contractions
    (exact: one-hot rows select single f32 values, summands are disjoint),
    the same trick as ops/ringbuf.py:lane_dynamic_slice."""
    d = len(rows)
    if d == 1:
        return rows[0]
    n_rows, m = rows[0].shape
    if m % 128:
        return jnp.stack(rows, axis=-1).reshape(n_rows, m * d)
    sel = []
    for c in range(d):
        e = np.zeros((128, 128 * d), np.float32)
        e[np.arange(128), np.arange(128) * d + c] = 1.0
        sel.append(jnp.asarray(e))
    out = None
    for c in range(d):
        a = rows[c].reshape(n_rows * (m // 128), 128)
        term = jax.lax.dot_general(
            a, sel[c], (((1,), (0,)), ((), ())),
            precision=DOT_PRECISION,
        )
        out = term if out is None else out + term
    return out.reshape(n_rows, m * d)


def pow2_stream_geometry_ok(size: int, e: int, blocksize: int) -> bool:
    """Divisibility/size conditions for the STREAMING exact-grid path
    (``octaver_taps_pow2_stream``): the class decomposition needs the
    block to split evenly into D phase classes and at most ONE grain wrap
    per class slice per block."""
    s, n = int(size), int(blocksize)
    if s % 2 or n > s:
        return False
    if e < 0:
        d = 1 << (-e)
        return n % d == 0 and n // d <= s // (d - 1)
    r = 1 << e
    if s % r:
        return False
    return r == 1 or n * (r - 1) <= s


def _slice1(vec, start, length: int):
    """Dynamic slice whose START must be batch-uniform under vmap.

    With an unbatched ``start`` (the phase-locked pool / any single
    stream), a vmapped ``lax.dynamic_slice`` lowers to one static-batch
    slice.  With a PER-BATCH start it becomes a gather with one start per
    stream — which is why the pool's grid serving
    mode phase-locks all slots to one shared scalar phase instead of
    carrying per-slot phases (server/pool.py)."""
    return jax.lax.dynamic_slice(vec, (start,), (length,))


def octaver_taps_pow2_stream(hist, x, e: int, num):
    """Both octaver taps for ratio 2^e from an ARBITRARY carried phase,
    exactly — the streaming extension of ``octaver_taps_pow2``.

    The phase is carried as an integer numerator ``num``:

        e <  0 (ratio 1/D):  phase = num / (D*S),  num in [0, D*S)
        e >= 0 (ratio R):    phase = num / S,      num in [0, S)

    advanced per sample by +(D-1) mod D*S (down) / -(R-1) mod S (up) — an
    exact integer recurrence with a closed-form block advance, so the
    float32 phase-accumulation floor of the compensated phasor
    (models/octaver.py) disappears entirely and streaming parity reaches
    the <= -80 dBFS bar (reference semantics: octaver.py:17-82).

    The per-block tap evaluation is gather-free: output lanes split into D
    classes by n mod D (class offset set by ``num`` at runtime), each class
    reading a CONTIGUOUS run of a static 4-tap FIR of the stream — per
    class, two dynamic slices (before/after the single grain wrap) + a
    select, then classes interleave via repeat + shift + mask.  All
    dynamic-slice starts are runtime scalars derived from ``num``, so the
    same code vmaps over a batch of per-session phases (the pool's
    serving path) as a small batched sliced-gather.

    hist: (S,) chronological ring history; x: (N,) current block.
    Returns (s1, s2, p1, p2, new_num).
    """
    from aefs_tpu.ops.ringbuf import _wrap_patch

    s = hist.shape[-1]
    n = x.shape[-1]
    assert pow2_stream_geometry_ok(s, e, n), (s, e, n)
    f32 = jnp.float32
    i32 = jnp.int32
    num = num.astype(i32) if hasattr(num, "astype") else jnp.asarray(num, i32)
    i = jnp.arange(n, dtype=i32)

    if e < 0:
        d = 1 << (-e)
        ds = d * s
        l = n // d
        ext = jnp.concatenate([hist, x, jnp.zeros((l + 16,), f32)])
        firs = [_fir_frac(ext, c / d) for c in range(d)]
        j = jnp.arange(l, dtype=i32)

        def tap(r0):
            r = jnp.mod(r0 + i * (d - 1), ds)
            ca = (r + d - 1) // d
            frac = (ca * d - r).astype(f32) / f32(d)
            acc = jnp.zeros((n,), f32)
            zpad = jnp.zeros((d,), f32)
            for c in range(d):
                n0 = jnp.mod(r0 + c, d)
                rf = jnp.mod(r0 + n0 * (d - 1), ds)
                caf = (rf + d - 1) // d
                start = s + n0 - caf
                pre = _slice1(firs[c], start, l)
                post = _slice1(firs[c], start + s, l)
                vals = jnp.where(rf + j * (d * (d - 1)) >= ds, post, pre)
                rep = jnp.repeat(vals, d)
                shifted = _slice1(jnp.concatenate([zpad, rep]), d - n0, n)
                acc = acc + jnp.where(jnp.mod(i - r0 - c, d) == 0, shifted, 0.0)
            return _wrap_patch(ext, s, n, ca, frac, acc), r

        s1, r1 = tap(num)
        s2, r2 = tap(jnp.mod(num + ds // 2, ds))
        p1 = r1.astype(f32) / f32(ds)
        p2 = r2.astype(f32) / f32(ds)
        new_num = jnp.mod(num + n * (d - 1), ds)
        return s1, s2, p1, p2, new_num

    # e >= 0: ratio R = 2^e — integer positions, one stride-R grid per tap.
    r_up = 1 << e
    sr = s // r_up
    ext = jnp.concatenate([hist, x])
    nrows = (s + n) // r_up + 2
    ext_p = jnp.concatenate(
        [ext, jnp.zeros((nrows * r_up + r_up - (s + n),), f32)]
    )
    zfront = jnp.zeros((sr,), f32)
    ztail = jnp.zeros((n,), f32)

    def tap(r0):
        r = jnp.mod(r0 - i * (r_up - 1), s)
        idx0 = s - r0
        off = jnp.mod(idx0, r_up)
        view = _slice1(ext_p, off, nrows * r_up).reshape(nrows, r_up)[:, 0]
        k0 = (idx0 - off) // r_up
        streamp = jnp.concatenate([zfront, view, ztail])
        pre = _slice1(streamp, k0 + sr, n)
        post = _slice1(streamp, k0, n)
        vals = jnp.where(i * (r_up - 1) > r0, post, pre)
        return _wrap_patch(ext, s, n, r, jnp.zeros((n,), f32), vals), r

    s1, r1 = tap(num)
    s2, r2 = tap(jnp.mod(num + s // 2, s))
    p1 = r1.astype(f32) / f32(s)
    p2 = r2.astype(f32) / f32(s)
    new_num = jnp.mod(num - n * (r_up - 1), s)
    return s1, s2, p1, p2, new_num


def octaver_taps_pow2(hist, x, e: int):
    """Both octaver taps + exact phasor streams for ratio 2^e from fresh
    phase.

    hist: (S,) chronological ring history; x: (N,) current signal.
    Returns (s1, s2, p1, p2): interpolated taps (ring-wrap lanes patched to
    reference semantics) and the exact phasors in [0, 1) driving the Hann
    crossfade gains.
    """
    from aefs_tpu.ops.ringbuf import _wrap_patch

    s = hist.shape[-1]
    n = x.shape[-1]
    assert pow2_geometry_ok(s, e), (s, e)
    f32 = jnp.float32
    n_idx = jnp.arange(n, dtype=jnp.int32)
    ext_plain = jnp.concatenate([hist, x])

    if e == 0:
        # ratio 1: ago1 = 0 (every lane wrap-patched), ago2 = S/2 constant.
        bulk1 = ext_plain[s : s + n]
        bulk2 = ext_plain[s // 2 : s // 2 + n]
        r1 = jnp.zeros((n,), jnp.int32)
        r2 = jnp.full((n,), s // 2, jnp.int32)
        p1 = jnp.zeros((n,), f32)
        p2 = jnp.full((n,), 0.5, f32)
        s1 = _wrap_patch(ext_plain, s, n, r1, jnp.zeros((n,), f32), bulk1)
        s2 = _wrap_patch(ext_plain, s, n, r2, jnp.zeros((n,), f32), bulk2)
        return s1, s2, p1, p2

    if e < 0:
        d = 1 << (-e)
        m = s // (d - 1)
        w = d * m  # grain period in output samples
        tail = 2 * w + 16
        ext = jnp.concatenate([ext_plain, jnp.zeros((tail,), f32)])

        firs = [_fir_frac(ext, c / d) for c in range(d)]

        def interleave(start: int, n_rows: int):
            rows = [_rows(firs[c], start, w, m, n_rows) for c in range(d)]
            return _interleave_rows(rows).reshape(n_rows * w)

        k1 = -(-n // w)
        bulk1 = interleave(s, k1)[:n]
        k2 = -(-(n + w // 2) // w)
        bulk2 = interleave((s - m) // 2, k2)[w // 2 : w // 2 + n]

        ds = d * s
        r1 = jnp.mod(n_idx * (d - 1), ds)  # ago1 * D, exact integers
        r2 = jnp.mod(r1 + ds // 2, ds)
        p1 = r1.astype(f32) / f32(ds)
        p2 = r2.astype(f32) / f32(ds)
        outs = []
        for r, bulk in ((r1, bulk1), (r2, bulk2)):
            ca = (r + d - 1) // d
            frac = ca.astype(f32) - r.astype(f32) / f32(d)
            outs.append(_wrap_patch(ext, s, n, ca, frac, bulk))
        return outs[0], outs[1], p1, p2

    # e > 0: ratio R, integer positions at stride R.
    r_up = 1 << e
    mp = s // (r_up - 1)  # grain period in output samples
    tail = 2 * r_up * mp + 16
    ext = jnp.concatenate([ext_plain, jnp.zeros((tail,), f32)])
    elen = (ext.shape[0] // r_up) * r_up
    ext_str = ext[:elen].reshape(-1, r_up)[:, 0]  # ext[R*i]

    k1 = -(-n // mp)
    bulk1 = _rows(ext_str, 0, mp // r_up, mp, k1).reshape(k1 * mp)[:n]

    lead = mp // (2 * r_up)
    ext_str2 = jnp.concatenate([jnp.zeros((lead,), f32), ext_str])
    k2 = -(-(n + mp // 2) // mp)
    bulk2 = _rows(ext_str2, 0, mp // r_up, mp, k2).reshape(k2 * mp)[
        mp // 2 : mp // 2 + n
    ]

    r1 = jnp.mod(-n_idx * (r_up - 1), s)  # ago1, exact integers
    r2 = jnp.mod(r1 + s // 2, s)
    p1 = r1.astype(f32) / f32(s)
    p2 = r2.astype(f32) / f32(s)
    zero = jnp.zeros((n,), f32)
    s1 = _wrap_patch(ext, s, n, r1, zero, bulk1)
    s2 = _wrap_patch(ext, s, n, r2, zero, bulk2)
    return s1, s2, p1, p2
