"""Per-source-line device-time profiler for the hot programs.

Runs a target program a few times under ``jax.profiler.trace``, filters
the trace to the GPU's device lanes, and aggregates op durations by the
HLO metadata's ``source`` attribution — a table of "which line of this
repo costs what on the device".

    python scripts/profile_step.py file      # whole-file flagship pass
    python scripts/profile_step.py stream    # batched S=128 serving step
    python scripts/profile_step.py stream --streams 256 --blocksize 512
    python scripts/profile_step.py stream --grid   # pool --grid serving mode

The stream target mirrors the PRODUCT pool step (server/pool.py): per-slot
parameter targets, lockstep state axes, and — with ``--grid`` — the
phase-locked exact-grid octaver (batch-uniform ``grid_phase``).

Needs the GPU; on the CPU the trace has no device lanes and the script
reports module wall only.
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)  # repo root (bench import)


def report(trace_dir, runs, module_prefix, top):
    files = glob.glob(trace_dir + "/**/*.trace.json.gz", recursive=True)
    if not files:
        print("no trace produced (CPU backend?)")
        return
    f = max(files, key=os.path.getmtime)  # newest trace, not longest name
    ev = json.loads(gzip.open(f).read().decode())["traceEvents"]
    dev_pids = set()
    for e in ev:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            nm = (e.get("args") or {}).get("name", "")
            if "GPU" in nm and "Host" not in nm:
                dev_pids.add(e["pid"])
    by_src = collections.Counter()
    by_op = collections.Counter()
    mod = 0.0
    for e in ev:
        if e.get("ph") != "X" or e.get("pid") not in dev_pids or "dur" not in e:
            continue
        if e["name"].startswith(module_prefix):
            mod += e["dur"]
            continue
        if e["name"].startswith(("jit_", "pjit")):
            continue
        src = (e.get("args") or {}).get("source", "?")
        by_src[src] += e["dur"]
        by_op[e["name"]] += e["dur"]
    print(f"module total: {mod/runs/1000:.3f} ms/run")
    print(f"-- top sources ({runs} runs averaged) --")
    for s, d in by_src.most_common(top):
        print(f"  {d/runs/1000:8.3f} ms  {s}")
    print("-- top ops --")
    for s, d in by_op.most_common(top):
        print(f"  {d/runs/1000:8.3f} ms  {s}")


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("target", choices=["file", "stream"])
    ap.add_argument("--streams", type=int, default=128)
    ap.add_argument("--blocksize", type=int, default=256)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--top", type=int, default=16)
    ap.add_argument("--grid", action="store_true",
                    help="exact-grid phase-locked serving (pool --grid)")
    ap.add_argument("--config", default="5_five_effect",
                    help="bench.CONFIGS key to profile (default flagship)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from bench import CONFIGS, FS, rain_like, file_static_overrides
    from aefs_tpu.core.chain import build_chain
    from aefs_tpu.utils.platform import enable_compile_cache

    enable_compile_cache()
    cfgs = CONFIGS[args.config]
    d = tempfile.mkdtemp(prefix="aefs_prof_", dir=os.path.join(REPO, ".scratch"))

    if args.target == "file":
        superblock = 4096
        ch, _, tm = build_chain(cfgs, FS, superblock, channels_in=1,
                                static_overrides=file_static_overrides(cfgs))
        tg = ch.targets(tm)
        x = rain_like()
        pad = (-len(x)) % superblock
        xd = jax.device_put(np.concatenate([x, np.zeros((pad, 1), np.float32)]).T)
        fn = jax.jit(ch.process_whole)
        st = ch.init_state({c["effect_id"]: c["params"] for c in cfgs})
        jax.block_until_ready(fn(st, tg, xd))
        t0 = time.time()
        with jax.profiler.trace(d):
            for _ in range(args.runs):
                st2, y = fn(st, tg, xd)
            jax.block_until_ready(y)
        print(f"wall: {(time.time()-t0)/args.runs*1000:.2f} ms/run")
        report(d, args.runs, "jit_process_whole", args.top)
    else:
        s, n = args.streams, args.blocksize
        ov = None
        if args.grid:
            from aefs_tpu.server.pool import grid_static_overrides

            ov = grid_static_overrides(cfgs) or None
        ch, _, tm = build_chain(cfgs, FS, n, channels_in=1,
                                static_overrides=ov)
        tg = ch.targets(tm)
        st = ch.batch_state(
            ch.init_state({c["effect_id"]: c["params"] for c in cfgs}), s
        )
        axes = ch.state_axes()
        # Per-slot targets like the product pool (grid_phase stays the
        # batch-uniform phase-locked scalar — bench._batched_serving_step).
        tg = tuple(
            {k: (v if k == "grid_phase"
                 else jnp.broadcast_to(jnp.asarray(v), (s,)))
             for k, v in g.items()}
            for g in tg
        )
        tg_axes = tuple(
            {k: (None if k == "grid_phase" else 0) for k in g} for g in tg
        )
        fn = jax.jit(
            lambda st, tg, x: jax.vmap(
                ch.process_block, in_axes=(axes, tg_axes, 0),
                out_axes=(axes, 0),
            )(st, tg, x)
        )
        xx = jnp.asarray(
            0.1 * np.random.default_rng(3).standard_normal((s, 1, n)), jnp.float32
        )
        st, y = jax.block_until_ready(fn(st, tg, xx))
        runs = max(args.runs, 10)
        t0 = time.time()
        with jax.profiler.trace(d):
            for _ in range(runs):
                st, y = fn(st, tg, xx)
            jax.block_until_ready(y)
        print(f"wall: {(time.time()-t0)/runs*1000:.2f} ms/step")
        report(d, runs, "jit__lambda", args.top)


if __name__ == "__main__":
    main()
