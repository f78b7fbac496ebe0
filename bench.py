"""Benchmark harness — the five BASELINE.json configs on the GPU.

    python bench.py

Prints ONE JSON line as the last line of stdout:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "device": {"platform", "kind", "count", "card"}, "detail": {...}}

value        = realtime factor on the 48 kHz stereo 5-effect chain
               (BASELINE config 5 topology, whole-file fast path, one
               device dispatch for the whole signal).
vs_baseline  = value / 1.0: the reference's implied operating point is the
               PortAudio realtime deadline (1.0x, engine.py:18-19 — it must
               process 256 samples in 5.33 ms).

Every time is host wall clock around work that ends in
``jax.block_until_ready``.  Detail lines go to stderr.  The harness
exits non-zero, with no result line, when JAX's first device is not a
GPU, and exits non-zero after the result line when any section failed or
the watchdog (AEFS_BENCH_DEADLINE_S, default 3000 s) fired.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

import numpy as np


FS = 48000
DURATION_S = 18.6  # rain-demo.wav length (BASELINE.md demo asset)
DEADLINE_S = 256 / FS  # one 256-sample block period


def rain_like(duration_s=DURATION_S, fs=FS, channels=1, seed=7):
    """Deterministic stand-in for the demo asset: broadband noise with a
    slow amplitude ripple and sparse droplet transients."""
    n = int(duration_s * fs)
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    base = rng.standard_normal((n, channels)) * 0.12
    ripple = (0.6 + 0.4 * np.sin(2 * np.pi * 0.31 * t))[:, None]
    drops = np.zeros((n, channels), np.float32)
    if n > 400:
        for i in rng.integers(0, n - 400, 600):
            env = np.exp(-np.arange(400) / 60.0)
            drops[i : i + 400, 0] += 0.25 * env * np.sin(
                2 * np.pi * rng.uniform(800, 4000) * np.arange(400) / fs
            )
    return np.clip(base * ripple + drops, -1, 1).astype(np.float32)


CONFIGS = {
    # BASELINE.json configs 1-5
    "1_biquad_lowpass": [
        {"effect_id": "f", "type": "filter",
         "params": {"filter_type": 0, "cutoff_hz": 1000, "q": 0.707}},
    ],
    "2_rain_delay": [
        {"effect_id": "d", "type": "delay",
         "params": {"feedback": 0.2, "delay_ms": 375, "mix_dry": 1,
                    "mix_wet": 1, "offset_ms": 0}},
        {"effect_id": "r", "type": "reverb",
         "params": {"rt60_s": 2.1, "mix_wet": 0.4, "mix_dry": 0.8,
                    "damp": 0.05, "pre_delay_ms": 0}},
    ],
    "3_distortion": [
        {"effect_id": "w", "type": "waveshaper",
         "params": {"drive": 8.0, "shape": 1, "mix": 1.0, "out_gain": 0.7}},
        {"effect_id": "f", "type": "filter",
         "params": {"filter_type": 0, "cutoff_hz": 3500, "q": 0.9}},
    ],
    "4_conv_reverb": [
        {"effect_id": "c", "type": "convreverb",
         "params": {"ir_seconds": 2.5, "mix_dry": 0.7, "mix_wet": 0.4}},
    ],
    # Opt-in (AEFS_BENCH_EXTENDED=1): the newer effect families —
    # modulated resonator, regenerative comb, lo-fi pair, brickwall —
    # as one chain; not part of the BASELINE headline.
    "x_new_effects": [
        {"effect_id": "w", "type": "wah",
         "params": {"rate_hz": 1.5, "min_hz": 350, "max_hz": 2200,
                    "res": 3.0, "mix": 0.7, "mode": 0.3, "sens": 6.0,
                    "env_ms": 30.0}},
        {"effect_id": "fl", "type": "flanger",
         "params": {"rate_hz": 0.3, "depth_ms": 2.0, "base_ms": 2.5,
                    "feedback": 0.6, "mix": 0.5, "spread": 0.25}},
        {"effect_id": "bc", "type": "bitcrusher",
         "params": {"bits": 8.0, "rate_hz": 12000.0, "mix": 0.6}},
        {"effect_id": "rm", "type": "ringmod",
         "params": {"carrier_hz": 330.0, "mix": 0.3, "spread": 0.25}},
        {"effect_id": "sw", "type": "stereowidth",
         "params": {"width": 1.4, "pan": 0.1}},
        {"effect_id": "li", "type": "limiter",
         "params": {"ceiling_db": -1.0, "release_ms": 80.0,
                    "drive_db": 3.0, "lookahead_ms": 5.0}},
    ],
    "5_five_effect": [
        {"effect_id": "g", "type": "gate",
         "params": {"threshold_db": -45, "attack_ms": 5, "release_ms": 100}},
        {"effect_id": "o", "type": "octaver",
         "params": {"semitones": -12, "mix": 0.4}},
        {"effect_id": "f", "type": "filter",
         "params": {"filter_type": 0, "cutoff_hz": 4000, "q": 0.8}},
        {"effect_id": "d", "type": "delay",
         "params": {"delay_ms": 375, "feedback": 0.2, "mix_dry": 1.0,
                    "mix_wet": 0.6, "offset_ms": 10}},
        {"effect_id": "r", "type": "reverb",
         "params": {"rt60_s": 2.1, "damp": 0.05, "pre_delay_ms": 0,
                    "mix_dry": 0.8, "mix_wet": 0.4}},
    ],
}

# Published peaks by JAX device_kind.  Source: NVIDIA H100 Tensor Core GPU
# data sheet, SXM5 part, dense rates without sparsity, at the 700 W
# power limit.  Every dot on an effect path runs in full float32
# (ops/precision.py), so the compute roof is the non-tensor-core f32 rate.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "f32_flops": 67e12,
        "tf32_flops": 495e12,
        "bf16_flops": 989e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peaks_for(device_kind: str) -> dict:
    """The published peaks of ``device_kind``; an unknown kind is an
    error, never a default."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; add its "
            f"data-sheet rates to bench.PEAKS"
        ) from None


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def timed(fn, *args, reps=5):
    """(first-call seconds incl. compile, median steady seconds)."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return first, float(np.median(ts))


def roofline(lowerable, args, device_s, peaks):
    """XLA's cost model (flops, bytes accessed) of the compiled program
    over the measured time, against the card's f32 and HBM peaks.
    Returns {"roofline_pct", "bound"} or {} when the backend exposes no
    cost analysis.  HLO "bytes accessed" is a per-instruction upper
    bound (operands re-read by several fusions count once per reader)."""
    ca = lowerable.lower(*args).compile().cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    if not ca:
        return {}
    flops = float(ca.get("flops", 0.0))
    byts = float(ca.get("bytes accessed", 0.0))
    f_pct = flops / device_s / peaks["f32_flops"] * 100.0
    b_pct = byts / device_s / peaks["hbm_bytes_per_s"] * 100.0
    return {
        "roofline_pct": max(f_pct, b_pct),
        "bound": "hbm" if b_pct >= f_pct else "f32",
    }


def file_static_overrides(cfgs):
    from aefs_tpu.core.fileopts import file_static_overrides as ov

    return ov(cfgs)


def bench_file_mode(name, cfgs, x, superblock, peaks):
    """Realtime factor of one config through the whole-file fast path:
    input staged on the device, median of steady runs."""
    import jax
    from aefs_tpu.core.chain import build_chain

    chain, _, tmap = build_chain(
        cfgs, FS, superblock, channels_in=1,
        static_overrides=file_static_overrides(cfgs),
    )
    targets = chain.targets(tmap)
    init_cfg = {c["effect_id"]: c["params"] for c in cfgs}
    pad = (-len(x)) % superblock
    xd = jax.device_put(np.concatenate([x, np.zeros((pad, 1), np.float32)]).T)
    state = chain.init_state(init_cfg)
    fn = jax.jit(chain.process_whole)
    compile_s, dev_s = timed(fn, state, targets, xd)
    rtf = (len(x) / FS) / dev_s
    out = {"rtf": rtf, "ms": dev_s * 1e3, "first_call_s": compile_s}
    out.update(roofline(fn, (state, targets, xd), dev_s, peaks))
    log(f"[bench] {name}: {dev_s*1e3:.3f} ms for {len(x)/FS:.1f} s of audio "
        f"-> {rtf:.0f}x realtime (first call {compile_s:.1f} s)")
    return out


def bench_stream_latency(cfgs, n_blocks=1000):
    """The engine's 256-sample mic step (packed dispatch): per-block
    dispatch-to-ready p50/p99, and the device-loop step time."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from aefs_tpu.core.chain import build_chain

    chain, pystate, tmap = build_chain(cfgs, FS, 256, channels_in=1)
    targets = chain.targets(tmap)
    runner = chain.packed_step()
    state = runner.pack_state(pystate)
    tgroups = runner.pack_targets(targets)
    xb = jax.device_put(rain_like(256 / FS)[:256].T)
    state, y = runner(state, tgroups, xb)
    jax.block_until_ready(y)
    lats = []
    for _ in range(n_blocks):
        t0 = time.perf_counter()
        state, y = runner(state, tgroups, xb)
        jax.block_until_ready(y)
        lats.append(time.perf_counter() - t0)
    lats = np.asarray(lats) * 1e3

    def many(st, tg, x):
        def body(_, carry):
            st, acc = carry
            st, yb = chain.process_block(st, tg, x)
            return st, acc + yb[0, -1]  # keep every block's output live

        return lax.fori_loop(0, n_blocks, body, (st, jnp.float32(0.0)))

    _, loop_s = timed(jax.jit(many), pystate, targets, xb, reps=3)
    dev_ms = loop_s / n_blocks * 1e3
    p50, p99 = float(np.percentile(lats, 50)), float(np.percentile(lats, 99))
    log(f"[bench] stream 256-block: dispatch p50={p50:.3f} ms p99={p99:.3f} ms; "
        f"device-loop step {dev_ms:.4f} ms vs {DEADLINE_S*1e3:.2f} ms period")
    return {"p50_ms": p50, "p99_ms": p99, "loop_step_ms": dev_ms}


def _batched_serving_step(cfgs, n_streams, blocksize, static_overrides=None):
    """(batched step, state, targets, x) for one serving topology — the
    vmapped product step with per-slot parameter targets, like the pool
    (server/pool.py target_axes)."""
    import jax
    import jax.numpy as jnp
    from aefs_tpu.core.chain import build_chain

    chain, _, tmap = build_chain(cfgs, FS, blocksize, channels_in=1,
                                 static_overrides=static_overrides)
    targets = chain.targets(tmap)
    init_cfg = {c["effect_id"]: c["params"] for c in cfgs}
    state = chain.batch_state(chain.init_state(init_cfg), n_streams)
    state_axes = chain.state_axes()
    # ``grid_phase`` is the phase-locked batch-uniform scalar (axis None).
    targets = tuple(
        {k: (v if k == "grid_phase" else jnp.broadcast_to(jnp.asarray(v), (n_streams,)))
         for k, v in tg.items()}
        for tg in targets
    )
    target_axes = tuple(
        {k: (None if k == "grid_phase" else 0) for k in tg} for tg in targets
    )

    def batched(st, tg, x):
        return jax.vmap(chain.process_block,
                        in_axes=(state_axes, target_axes, 0),
                        out_axes=(state_axes, 0))(st, tg, x)

    x = jnp.asarray(
        0.1 * np.random.default_rng(3).standard_normal((n_streams, 1, blocksize)),
        jnp.float32,
    )
    return batched, state, targets, x


def _loop_step_s(steps, args, iters=50):
    """Seconds per iteration of an on-device loop applying every
    (step, (state, targets, x)) pair once per iteration."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    def many(*flat):
        def body(_, carry):
            sts, acc = carry
            new = []
            for (step, (_, tg, x)), st in zip(zip(steps, args), sts):
                st, y = step(st, tg, x)
                new.append(st)
                acc = acc + y[0, 0, -1]
            return tuple(new), acc

        return lax.fori_loop(0, iters, body, (flat, jnp.float32(0.0)))

    _, t = timed(jax.jit(many), *[a[0] for a in args], reps=3)
    return t / iters


def bench_multistream(cfgs):
    """Serving density: S sessions stepped together (vmapped) per 256-
    sample block, generic (live semitones) and exact-grid (pool --grid),
    plus the two buckets stepped together as a MultiPool serves them."""
    from aefs_tpu.server.pool import grid_static_overrides

    out = {}
    grid_ov = grid_static_overrides(cfgs)
    built = {}
    for mode, ov, s in (("generic", None, 256), ("generic", None, 512),
                        ("grid", grid_ov, 256)):
        step, st, tg, x = _batched_serving_step(cfgs, s, 256, ov)
        built[(mode, s)] = (step, (st, tg, x))
        t = _loop_step_s([step], [(st, tg, x)])
        out[f"{mode}_S{s}_step_ms"] = t * 1e3
        out[f"{mode}_S{s}_streams"] = s * DEADLINE_S / t
        log(f"[bench] multistream[{mode}] S={s}: {t*1e3:.3f} ms/step -> "
            f"{s*DEADLINE_S/t:.0f} realtime streams")
    (sa, aa), (sb, ab) = built[("generic", 256)], built[("grid", 256)]
    t = _loop_step_s([sa, sb], [aa, ab])
    out["hetero_2x256_step_ms"] = t * 1e3
    out["hetero_2x256_streams"] = 512 * DEADLINE_S / t
    log(f"[bench] multistream hetero 2x256: {t*1e3:.3f} ms/step -> "
        f"{512*DEADLINE_S/t:.0f} realtime streams")
    return out


def bench_batch_render(cfgs, x, b=16, superblock=4096):
    """Bulk offline rendering: B files through the flagship chain in one
    vmapped dispatch (engine.render_batch's compute core)."""
    import jax
    from aefs_tpu.core.chain import build_chain

    chain, one, tmap = build_chain(
        cfgs, FS, superblock, channels_in=1,
        static_overrides=file_static_overrides(cfgs),
    )
    targets = chain.targets(tmap)
    pad = (-len(x)) % superblock
    xp = np.concatenate([x, np.zeros((pad, 1), np.float32)])
    xb = jax.device_put(np.broadcast_to(xp.T[None], (b, 1, xp.shape[0])).copy())
    state = chain.batch_state(one, b)
    state_axes = chain.state_axes()
    fn = jax.jit(
        lambda st, tg, xx: jax.vmap(
            chain.process_whole, in_axes=(state_axes, None, 0),
            out_axes=(state_axes, 0),
        )(st, tg, xx)
    )
    _, per = timed(fn, state, targets, xb, reps=4)
    agg = b * (len(x) / FS) / per
    log(f"[bench] batch render B={b}: {per*1e3:.2f} ms/dispatch -> "
        f"{agg:.0f}x realtime aggregate")
    return {"ms": per * 1e3, "aggregate_rtf": agg}


def device_record():
    import jax

    from aefs_tpu.utils.platform import card_name_and_power_limit

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()), "card": card_name_and_power_limit(),
            "xla_flags": os.environ.get("XLA_FLAGS", "")}


def emit(results, errors, device):
    """Print THE result line (last line of stdout)."""
    headline = results.get("5_five_effect", {}).get("rtf", 0.0)
    out = {
        "metric": "realtime_factor_48k_stereo_5fx_chain",
        "value": headline,
        "unit": "x_realtime",
        "vs_baseline": headline,
        "device": device,
        "detail": results,
    }
    if errors:
        out["errors"] = errors
    print(json.dumps(out), flush=True)


def main() -> int:
    import jax

    from aefs_tpu.utils.platform import enable_compile_cache

    enable_compile_cache()
    d = jax.devices()[0]
    if d.platform != "gpu":
        log(f"[bench] needs a GPU; JAX's first device is {d.platform} "
            f"({d.device_kind}) — no result")
        return 2
    peaks = peaks_for(d.device_kind)
    device = device_record()
    log(f"[bench] device: {device}")

    results, errors = {}, {}
    lock = threading.Lock()
    deadline_s = float(os.environ.get("AEFS_BENCH_DEADLINE_S", "3000"))

    def watchdog():
        time.sleep(deadline_s)
        with lock:
            errors["watchdog"] = f"deadline {deadline_s:.0f} s hit (partial)"
            emit(dict(results), dict(errors), device)
        os._exit(3)

    threading.Thread(target=watchdog, daemon=True).start()

    def section(key, fn):
        try:
            r = fn()
            with lock:
                results[key] = r
        except Exception as e:
            log(f"[bench] {key} FAILED: {type(e).__name__}: {e}")
            with lock:
                errors[key] = f"{type(e).__name__}: {e}"

    x = rain_like()
    extended = os.environ.get("AEFS_BENCH_EXTENDED", "0") == "1"
    for name in CONFIGS:
        if extended or not name.startswith("x_"):
            section(name, lambda name=name: bench_file_mode(
                name, CONFIGS[name], x, 4096, peaks))
    flagship = CONFIGS["5_five_effect"]
    section("stream", lambda: bench_stream_latency(flagship))
    section("multistream", lambda: bench_multistream(flagship))
    section("batch16", lambda: bench_batch_render(flagship, x))
    with lock:
        emit(results, errors, device)
        return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
