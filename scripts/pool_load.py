"""Load generator for the multi-session pool server (server/pool.py).

Drives K concurrent WebSocket sessions against a pool server — each
session streams mono blocks at the realtime cadence (or flat out with
--max-rate), optionally wiggling a parameter mid-stream — and reports
per-session block round-trip latency and the pool's achieved aggregate
throughput vs realtime.

Self-contained by default: spawns the pool server as a subprocess
(AEFS_PLATFORM=cpu works for smoke runs; on the GPU host leave it unset),
waits for the port, runs the load, tears the server down.

    python scripts/pool_load.py --sessions 8 --blocks 200
    python scripts/pool_load.py --url ws://host:8766 --sessions 64

The reference architecture serves ONE client per backend process
(backend.py:73-75); this script is the working demonstration that one
GPU-backed pool process serves many.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


async def run_session(url, n_blocks, blocksize, fs, realtime, wiggle, results, idx):
    import websockets

    rng = np.random.default_rng(idx)
    lats = []
    plats = []
    # Generous open timeout: a GPU-backed pool may be mid-compile or
    # mid-dispatch when many sessions connect at once.
    async with websockets.connect(url, max_size=2**24, open_timeout=120) as ws:
        ready = json.loads(await ws.recv())
        if ready.get("type") != "session_ready":
            results[idx] = {"error": ready}
            return
        slot = ready["slot"]
        deadline = blocksize / fs
        for k in range(n_blocks):
            block = (0.1 * rng.standard_normal(blocksize)).astype(np.float32)
            t0 = time.time()
            await ws.send(json.dumps(
                {"command": "stream_block", "audio": block.tolist()}
            ))
            msg = json.loads(await ws.recv())
            lats.append(time.time() - t0)
            assert msg["type"] == "processed_block", msg
            assert len(msg["output"]) == blocksize
            if wiggle and k % 8 == 4:
                # Acked param update: the control-plane latency under
                # full streaming load (must stay well under one block
                # period — the pool's step must never block control ops).
                tp = time.time()
                await ws.send(json.dumps({
                    "command": "update_param", "effect_id": wiggle[0],
                    "param": wiggle[1],
                    "value": wiggle[2] * (1.0 + rng.uniform(-0.1, 0.1)),
                    "ack": True,
                }))
                ack = json.loads(await ws.recv())
                plats.append(time.time() - tp)
                assert ack["type"] == "param_ack", ack
            if realtime:
                sleep = deadline - (time.time() - t0)
                if sleep > 0:
                    await asyncio.sleep(sleep)
        results[idx] = {"slot": slot, "lats": lats, "plats": plats}


def wait_port(port, timeout=420.0):
    """Pools compile their vmapped step before serving — allow for a
    cold-cache compile."""
    t0 = time.time()
    while time.time() - t0 < timeout:
        with socket.socket() as s:
            if s.connect_ex(("127.0.0.1", port)) == 0:
                return True
        time.sleep(0.5)
    return False


async def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--url", help="existing pool server URL (skips spawning)")
    ap.add_argument("--sessions", type=int, default=8)
    ap.add_argument("--blocks", type=int, default=100)
    ap.add_argument("--preset", default="Rain Delay")
    ap.add_argument("--port", type=int, default=8766)
    ap.add_argument("--max-rate", action="store_true",
                    help="stream flat out instead of the realtime cadence")
    args = ap.parse_args()

    proc = None
    url = args.url
    if not url:
        # One extra slot: the blocksize probe connection below holds a
        # slot whose release races the load sessions' connects.
        proc = subprocess.Popen(
            [sys.executable, "-m", "aefs_tpu.server.pool",
             "--preset", args.preset, "--slots", str(args.sessions + 1),
             "--port", str(args.port)],
            cwd=REPO,
        )
        if not wait_port(args.port):
            proc.terminate()
            raise SystemExit("pool server did not come up")
        url = f"ws://127.0.0.1:{args.port}"

    try:
        # Probe one session for blocksize/fs.
        import websockets

        async with websockets.connect(url, open_timeout=120) as ws:
            ready = json.loads(await ws.recv())
            if ready.get("type") == "error":  # e.g. pool full
                raise SystemExit(f"pool refused the probe session: "
                                 f"{ready.get('error')}")
            blocksize, fs = ready["blocksize"], ready["sample_rate"]
            chain = ready.get("chain", [])
        # Acked-update target: the first effect with a known wiggleable
        # param (value stays near its preset default).
        wiggleable = {"filter": ("cutoff_hz", 900.0),
                      "delay": ("delay_ms", 300.0),
                      "reverb": ("rt60_s", 2000.0 / 1000),
                      "gate": ("threshold_db", -40.0),
                      "octaver": ("mix", 0.5),
                      "waveshaper": ("drive", 4.0)}
        wiggle = None
        for c in chain:
            if c.get("type") in wiggleable:
                p, v = wiggleable[c["type"]]
                wiggle = (c["effect_id"], p, v)
                break

        results = {}
        t0 = time.time()
        await asyncio.gather(*[
            run_session(url, args.blocks, blocksize, fs,
                        not args.max_rate, wiggle, results, i)
            for i in range(args.sessions)
        ])
        wall = time.time() - t0

        all_lats = np.concatenate([
            np.asarray(r["lats"]) for r in results.values() if "lats" in r
        ]) * 1000.0
        all_plats = np.concatenate([
            np.asarray(r["plats"]) for r in results.values()
            if r.get("plats")
        ] or [np.zeros(0)]) * 1000.0
        ok = sum(1 for r in results.values() if "lats" in r)
        audio_s = ok * args.blocks * blocksize / fs
        deadline_ms = blocksize / fs * 1000

        # The pool's own verdict: its batched step time vs the deadline
        # (per-block RTT above also pays network + batching window).
        pool_stats = {}
        try:
            async with websockets.connect(url, open_timeout=60) as ws2:
                json.loads(await ws2.recv())  # session_ready
                await ws2.send(json.dumps({"command": "get_pool_stats"}))
                pool_stats = json.loads(await asyncio.wait_for(ws2.recv(), 30))
        except Exception:
            pass

        print(json.dumps({
            "sessions_ok": ok,
            "sessions": args.sessions,
            "blocks_per_session": args.blocks,
            "block_ms": round(deadline_ms, 2),
            "rtt_p50_ms": round(float(np.percentile(all_lats, 50)), 2),
            "rtt_p99_ms": round(float(np.percentile(all_lats, 99)), 2),
            "param_update_p50_ms": (
                round(float(np.percentile(all_plats, 50)), 3)
                if all_plats.size else None
            ),
            "param_update_p99_ms": (
                round(float(np.percentile(all_plats, 99)), 3)
                if all_plats.size else None
            ),
            "aggregate_audio_s": round(audio_s, 2),
            "wall_s": round(wall, 2),
            "aggregate_x_realtime": round(audio_s / wall, 2),
            "pool_step_ms": pool_stats.get("step_ms"),
            "pool_realtime_ok": pool_stats.get("realtime_ok"),
        }))
    finally:
        if proc is not None:
            proc.terminate()
            proc.wait(timeout=10)


if __name__ == "__main__":
    asyncio.run(main())
