"""Smoke test of the whole system on the GPU, through the entry points a
user calls, with every output checked against the same program on the
CPU backend and the float64 oracles.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # the sharded paths on four cards

Phases (one card), each printing one JSON line:

- file:    the five BASELINE configs over music/rain-demo.wav (18.6 s,
           892,800 frames) through AudioEngine.process_wav_file, the flow
           the WebSocket backend calls;
- stream:  AudioEngine.process_stream_block, flagship chain, 2,000 blocks
           of 256 samples;
- serving: a MultiPool with the flagship and "Rain Delay" buckets, 256
           slots each (512 sessions), 200 blocks of step_blocks, live
           semitones and cutoff differing across slots;
- batch:   ``python -m aefs_tpu.cli --batch`` over 16 seeded files of the
           demo's length;
- oracles: tests/test_on_card.py — reverb, octaver, chorus, flanger and
           convreverb against their float64 oracles over 4 s;
- sockets: the pool server over real WebSocket connections, 4 clients x
           100 blocks.

Parity bar: <= -80 dBFS peak error.  The script exits non-zero, and
prints no result line, when JAX's first device is not a GPU, when a phase
raises, or when a parity check misses.  Its last line is
``{"ok": true, "device": {"platform", "kind", "count"}}``; the line
before it is the card's ``name, power.limit`` from nvidia-smi.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))
WORK = os.path.join(ROOT, ".smoke")  # listed in .gitignore

import numpy as np

BAR_DB = -80.0
FS = 48000
BLOCK = 256


def err_dbfs(a, b):
    """Peak error of ``a`` against ``b`` in dB relative to full scale."""
    e = float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))
    return -np.inf if e == 0 else 20.0 * np.log10(e)


def report(phase, card, misses, **fields):
    """Print one phase line; record every parity figure above the bar.
    ``steady_ms`` of the per-block phases is the mean after 10 warm-up
    blocks; p50/p99 cover every block."""
    for k, v in fields.items():
        if k.startswith("parity") and isinstance(v, (int, float)) and v > BAR_DB:
            misses.append(f"{phase}.{k} = {v:.1f} dBFS > {BAR_DB}")
    line = {"phase": phase, "card": card}
    line.update(fields)
    print(json.dumps(line, default=float), flush=True)


def demo_audio():
    from aefs_tpu.engine.wavio import read_wav_file

    return read_wav_file(os.path.join(ROOT, "music", "rain-demo.wav"))


def on_cpu():
    import jax

    return jax.default_device(jax.devices("cpu")[0])


# -- phases --------------------------------------------------------------

class _Socket:
    """Stands in for the client's WebSocket: keeps what the engine sends."""

    def __init__(self):
        self.sent = []

    async def send(self, msg):
        self.sent.append(msg)


def phase_file(card, misses, configs, audio, fs):
    import jax

    from aefs_tpu import native
    from aefs_tpu.core.chain import build_chain
    from aefs_tpu.core.fileopts import file_static_overrides
    from aefs_tpu.engine.engine import AudioEngine, process_offline
    from aefs_tpu.engine.wavio import decode_wav, encode_wav_int16

    url = "data:audio/wav;base64," + native.b64encode(
        encode_wav_int16(audio, fs)).decode("ascii")
    frames = audio.shape[0]
    for name, cfgs in configs.items():
        engine = AudioEngine()
        engine.build_chain(cfgs)
        walls = []
        for _ in range(2):  # the first call compiles
            sock = _Socket()
            t0 = time.perf_counter()
            asyncio.run(engine.process_wav_file(url, sock))
            walls.append(time.perf_counter() - t0)
            assert sock.sent, f"{name}: no file_processed reply"
            reply = json.loads(sock.sent[-1])
            assert reply["type"] == "file_processed", reply.get("type")
            out, out_fs = decode_wav(native.b64decode(
                reply["processed_b64"].split(",", 1)[1]))
            assert out_fs == fs and out.shape == (frames, 2), out.shape
            assert np.isfinite(out).all()
        engine.close()

        # Device time of the whole-file pass alone.
        chain, state, tmap = build_chain(
            cfgs, fs, 4096, channels_in=1,
            static_overrides=file_static_overrides(cfgs))
        pad = (-frames) % 4096
        mono = audio.mean(axis=1, keepdims=True).astype(np.float32)
        xd = jax.device_put(np.concatenate([mono, np.zeros((pad, 1), np.float32)]).T)
        fn = jax.jit(chain.process_whole)
        targets = chain.targets(tmap)
        t0 = time.perf_counter()
        jax.block_until_ready(fn(state, targets, xd))
        compile_s = time.perf_counter() - t0
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(state, targets, xd))
            ts.append(time.perf_counter() - t0)
        chain.release()

        _, gpu = process_offline(cfgs, audio, fs)
        t0 = time.perf_counter()
        with on_cpu():
            _, cpu = process_offline(cfgs, audio, fs)
        report("file", card, misses, config=name, frames=frames,
               compile_s=compile_s, steady_ms=float(np.median(ts)) * 1e3,
               e2e_first_s=walls[0], e2e_steady_s=walls[1],
               cpu_ref_s=time.perf_counter() - t0,
               parity_vs_cpu_dbfs=err_dbfs(gpu, cpu))


def _stream(cfgs, blocks):
    from aefs_tpu.engine.engine import AudioEngine

    engine = AudioEngine()
    t0 = time.perf_counter()
    engine.build_chain(cfgs)  # compiles and warms the step
    build_s = time.perf_counter() - t0
    outs, lats = [], []
    for blk in blocks:
        t0 = time.perf_counter()
        outs.append(engine.process_stream_block(blk))
        lats.append(time.perf_counter() - t0)
    engine.close()
    return build_s, np.stack(outs), np.asarray(lats)


def phase_stream(card, misses, cfgs, audio, n_blocks):
    mono = audio.mean(axis=1, keepdims=True).astype(np.float32)
    blocks = [mono[i * BLOCK:(i + 1) * BLOCK] for i in range(n_blocks)]
    build_s, gpu, lats = _stream(cfgs, blocks)
    t0 = time.perf_counter()
    with on_cpu():
        _, cpu, _ = _stream(cfgs, blocks)
    cpu_s = time.perf_counter() - t0
    assert gpu.shape == (n_blocks, BLOCK, 2) and np.isfinite(gpu).all()
    report("stream", card, misses, blocks=n_blocks, compile_s=build_s,
           steady_ms=float(lats[10:].mean() * 1e3),
           p50_ms=float(np.percentile(lats, 50) * 1e3),
           p99_ms=float(np.percentile(lats, 99) * 1e3),
           period_ms=BLOCK / FS * 1e3, cpu_ref_s=cpu_s,
           parity_vs_cpu_dbfs=err_dbfs(gpu, cpu))


def _serve(flagship, rain, n_slots, n_blocks):
    """Two live topology buckets; returns (build s, per-block s, outs)."""
    from aefs_tpu.server.pool import MultiPool

    t0 = time.perf_counter()
    mp = MultiPool(flagship, n_slots=n_slots)
    flag = mp.default_pool
    f_slots = [flag.claim() for _ in range(n_slots)]
    placed = [mp.build_session(rain) for _ in range(n_slots)]
    build_s = time.perf_counter() - t0
    rain_pool = placed[0][1]
    r_slots = [p[2] for p in placed]
    assert all(p[1] is rain_pool for p in placed) and None not in r_slots
    for s in f_slots[::3]:  # live params diverging across slots
        assert flag.update_param(s, "o", "semitones", -12.0 + (s % 13) * 1.5) is None
    for s in f_slots[1::4]:
        assert flag.update_param(s, "f", "cutoff_hz", 800.0 + 37.0 * s) is None
    rng = np.random.default_rng(11)
    outs, lats = [], []
    for _ in range(n_blocks):
        xs = (0.1 * rng.standard_normal((2 * n_slots, BLOCK))).astype(np.float32)
        t0 = time.perf_counter()
        of = flag.step_blocks({s: xs[i] for i, s in enumerate(f_slots)})
        orr = rain_pool.step_blocks({s: xs[n_slots + i] for i, s in enumerate(r_slots)})
        lats.append(time.perf_counter() - t0)
        outs.append(np.stack([of[s] for s in f_slots] + [orr[s] for s in r_slots]))
    for p in mp.buckets().values():
        p.close()
    return build_s, np.asarray(lats), np.stack(outs)


def phase_serving(card, misses, flagship, rain, n_slots, n_blocks):
    build_s, lats, gpu = _serve(flagship, rain, n_slots, n_blocks)
    t0 = time.perf_counter()
    with on_cpu():
        _, _, cpu = _serve(flagship, rain, n_slots, n_blocks)
    cpu_s = time.perf_counter() - t0
    assert np.isfinite(gpu).all()
    report("serving", card, misses, sessions=2 * n_slots, blocks=n_blocks,
           compile_s=build_s, steady_ms=float(lats[10:].mean() * 1e3),
           p50_ms=float(np.percentile(lats, 50) * 1e3),
           p99_ms=float(np.percentile(lats, 99) * 1e3),
           period_ms=BLOCK / FS * 1e3, cpu_ref_s=cpu_s,
           parity_vs_cpu_dbfs=err_dbfs(gpu, cpu))


def batch_inputs(n_files, frames):
    """Seeded WAV files of ``frames`` frames and a flagship config file."""
    from aefs_tpu.engine.wavio import write_wav_file

    import bench

    d = os.path.join(WORK, "batch_in")
    os.makedirs(d, exist_ok=True)
    paths, audios = [], []
    for i in range(n_files):
        a = bench.rain_like(frames / FS, seed=100 + i)[:frames, 0]
        p = os.path.join(d, f"take{i:02d}.wav")
        write_wav_file(p, a, FS)
        paths.append(p)
        audios.append(a)
    cfg = os.path.join(WORK, "flagship.json")
    with open(cfg, "w") as f:
        json.dump(bench.CONFIGS["5_five_effect"], f)
    return paths, cfg


def run_cli_batch(paths, cfg, out_dir, shard=False):
    from aefs_tpu import cli
    from aefs_tpu.engine.wavio import read_wav_file

    argv = ["--batch", out_dir, *paths, "--config", cfg] + (["--shard"] if shard else [])
    t0 = time.perf_counter()
    assert cli.main(argv) == 0
    wall = time.perf_counter() - t0
    outs = [read_wav_file(os.path.join(out_dir, os.path.basename(p)))[0] for p in paths]
    return wall, np.stack(outs)


def phase_batch(card, misses, n_files, frames):
    from aefs_tpu.engine.engine import render_batch
    from aefs_tpu.engine.wavio import decode_wav, encode_wav_int16, read_wav_file

    import bench

    paths, cfg = batch_inputs(n_files, frames)
    first, gpu = run_cli_batch(paths, cfg, os.path.join(WORK, "batch_out"))
    steady, gpu2 = run_cli_batch(paths, cfg, os.path.join(WORK, "batch_out"))
    assert gpu.shape == (n_files, frames, 2) and np.isfinite(gpu).all()
    audios = [read_wav_file(p)[0] for p in paths]
    t0 = time.perf_counter()
    with on_cpu():
        cpu = render_batch(bench.CONFIGS["5_five_effect"], audios, FS)
    cpu_s = time.perf_counter() - t0
    # The CLI writes 16-bit WAVs: put the CPU render through the same codec.
    cpu = np.stack([decode_wav(encode_wav_int16(c, FS))[0] for c in cpu])
    # Device time of the batched whole-file pass alone.
    ms = bench.bench_batch_render(bench.CONFIGS["5_five_effect"],
                                  np.asarray(audios[0]).reshape(-1, 1), b=n_files)["ms"]
    report("batch", card, misses, files=n_files, frames=frames,
           compile_s=first, e2e_steady_s=steady, steady_ms=ms,
           repeat_bitwise=bool(np.array_equal(gpu, gpu2)), cpu_ref_s=cpu_s,
           parity_vs_cpu_dbfs=err_dbfs(gpu, cpu))


def phase_oracles(card, misses, frames):
    import test_on_card

    for kind in sorted(test_on_card.CASES):
        t0 = time.perf_counter()
        errs = test_on_card.oracle_parity(kind, frames=frames)
        report("oracles", card, misses, effect=kind, frames=frames,
               wall_s=time.perf_counter() - t0,
               parity_stream_dbfs=errs["stream"], parity_file_dbfs=errs["file"])


def phase_sockets(card, misses, flagship, n_clients, n_blocks):
    """The pool server on a localhost port, ``n_clients`` WebSocket
    sessions streaming flat out."""
    import socket

    import websockets

    from aefs_tpu.server.pool import MultiPool, PoolServer

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    async def client(url, idx, lats):
        rng = np.random.default_rng(idx)
        outs = []
        async with websockets.connect(url, max_size=2**24, open_timeout=300) as ws:
            ready = json.loads(await ws.recv())
            assert ready["type"] == "session_ready", ready
            for _ in range(n_blocks):
                blk = (0.1 * rng.standard_normal(BLOCK)).astype(np.float32)
                t0 = time.perf_counter()
                await ws.send(json.dumps({"command": "stream_block", "audio": blk.tolist()}))
                msg = json.loads(await ws.recv())
                lats.append(time.perf_counter() - t0)
                assert msg["type"] == "processed_block", msg.get("type")
                outs.append(np.stack([msg["output"], msg["output_r"]]))
        return np.stack(outs)

    async def run():
        t0 = time.perf_counter()
        server = PoolServer(MultiPool(flagship, n_slots=n_clients))
        build_s = time.perf_counter() - t0
        task = asyncio.create_task(server.batcher())
        lats = []
        async with websockets.serve(server.handler, "localhost", port,
                                    max_size=2**24):
            url = f"ws://localhost:{port}"
            outs = await asyncio.gather(*(client(url, i, lats) for i in range(n_clients)))
        task.cancel()
        server.pool.close()
        return build_s, lats, outs

    build_s, lats, outs = asyncio.run(run())
    for o in outs:
        assert o.shape == (n_blocks, 2, BLOCK) and np.isfinite(o).all()
    lats = np.asarray(lats)
    report("sockets", card, misses, clients=n_clients, blocks=n_blocks,
           compile_s=build_s, p50_ms=float(np.percentile(lats, 50) * 1e3),
           p99_ms=float(np.percentile(lats, 99) * 1e3))


# -- four cards ----------------------------------------------------------

def spread_over(arrays, n_dev):
    """Check that sharded arrays really live on ``n_dev`` devices: every
    array's shards sit on n_dev distinct devices, every array that is not
    replicated holds distinct slices (not full copies), and at least one
    is split n_dev ways.  Returns the count of split arrays."""
    n_split, widest = 0, 1
    for a in arrays:
        shards = a.addressable_shards
        assert len({s.device for s in shards}) == n_dev, (a.shape, a.sharding)
        if a.sharding.is_fully_replicated:
            continue
        n_split += 1
        parts = len({str(s.index) for s in shards})
        assert parts > 1 and all(s.data.size < a.size for s in shards), (
            a.shape, a.sharding)
        widest = max(widest, parts)
    assert n_split and widest == n_dev, (n_split, widest)
    return n_split


def four_cards(card, misses, n_dev, n_slots, n_files, frames):
    import jax
    import jax.numpy as jnp

    import bench
    from aefs_tpu.core.chain import build_chain
    from aefs_tpu.parallel.mesh import ShardedStreams, make_mesh
    from aefs_tpu.server.pool import SessionPool

    flagship = bench.CONFIGS["5_five_effect"]

    # Sharded serving pool vs the unsharded pool: bit for bit.
    pools = [SessionPool(flagship, n_slots=n_slots, shard=sh) for sh in (True, False)]
    slots = [[p.claim() for _ in range(n_slots)] for p in pools]
    assert slots[0] == slots[1]
    outs = []
    for p, sl in zip(pools, slots):
        assert p.update_param(sl[0], "o", "semitones", -5.0) is None
        assert p.update_param(sl[-1], "f", "cutoff_hz", 1234.0) is None
        rng = np.random.default_rng(7)
        res = None
        for _ in range(5):
            res = p.step_blocks({s: (0.1 * rng.standard_normal(BLOCK)).astype(np.float32)
                                 for s in sl})
        outs.append(np.stack([res[s] for s in sl]))
    n_split = spread_over(jax.tree.leaves(pools[0].state), n_dev)
    for p in pools:
        p.close()
    report("pool_sharded", card, misses, slots=n_slots, devices=n_dev,
           split_arrays=n_split,
           bitwise=bool(np.array_equal(outs[0], outs[1])),
           parity_vs_unsharded_dbfs=err_dbfs(outs[0], outs[1]))
    if not np.array_equal(outs[0], outs[1]):
        misses.append("pool_sharded: not bit-identical to the unsharded pool")

    # ShardedStreams on a (data=2, model=2) mesh vs the unsharded step.
    mesh = make_mesh(n_devices=n_dev, model_parallel=2)
    conv = [{"effect_id": "c", "type": "convreverb",
             "params": {"mix_dry": 0.7, "mix_wet": 0.4},
             "ir_seconds": 0.4, "partition_multiple": mesh.shape["model"]}]
    for name, cfgs in (("flagship", flagship), ("convreverb", conv)):
        chain, _, tmap = build_chain(cfgs, FS, BLOCK, channels_in=1)
        targets = chain.targets(tmap)
        init = {c["effect_id"]: c["params"] for c in cfgs}
        n_streams = 2 * mesh.shape["data"] * 4
        x = (0.1 * np.random.default_rng(1).standard_normal(
            (4, n_streams, 1, BLOCK))).astype(np.float32)
        runner = ShardedStreams(chain, mesh, n_streams)
        st, _ = runner.init_state(init)
        n_split = spread_over(jax.tree.leaves(st), n_dev)
        ys = []
        for k in range(4):
            st, y, _ = runner.run_block(st, targets, x[k])
            ys.append(np.asarray(y))
        axes = chain.state_axes()
        ref_step = jax.jit(jax.vmap(chain.process_block, in_axes=(axes, None, 0),
                                    out_axes=(axes, 0)))
        st1 = chain.batch_state(chain.init_state(init), n_streams)
        refs = []
        for k in range(4):
            st1, y1 = ref_step(st1, targets, jnp.asarray(x[k]))
            refs.append(np.asarray(y1))
        report("sharded_streams", card, misses, chain=name,
               mesh=dict(mesh.shape), streams=n_streams, split_arrays=n_split,
               parity_vs_unsharded_dbfs=err_dbfs(np.stack(ys), np.stack(refs)))

    # cli --batch --shard vs the unsharded batch.
    paths, cfg = batch_inputs(n_files, frames)
    _, ref = run_cli_batch(paths, cfg, os.path.join(WORK, "batch_out"))
    _, got = run_cli_batch(paths, cfg, os.path.join(WORK, "batch_shard"), shard=True)
    report("batch_sharded", card, misses, files=n_files, devices=n_dev,
           bitwise=bool(np.array_equal(got, ref)),
           parity_vs_unsharded_dbfs=err_dbfs(got, ref))


# -- main ----------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths, on four cards")
    args = ap.parse_args(argv)

    import jax

    from aefs_tpu.utils.platform import card_name_and_power_limit, enable_compile_cache

    enable_compile_cache()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX's first device is "
              f"{devs[0].platform} ({devs[0].device_kind})", file=sys.stderr)
        return 1
    card = card_name_and_power_limit()
    os.makedirs(WORK, exist_ok=True)
    misses = []
    t_all = time.perf_counter()

    import bench

    if args.four_cards:
        if len(devs) != 4:
            print(f"chip_smoke: --four-cards needs 4 GPUs, found {len(devs)}",
                  file=sys.stderr)
            return 1
        four_cards(card, misses, 4, n_slots=512, n_files=16,
                   frames=int(bench.DURATION_S * FS))
    else:
        audio, fs = demo_audio()
        assert fs == FS
        configs = {k: v for k, v in bench.CONFIGS.items() if not k.startswith("x_")}
        flagship, rain = bench.CONFIGS["5_five_effect"], bench.CONFIGS["2_rain_delay"]
        phase_file(card, misses, configs, audio, fs)
        phase_stream(card, misses, flagship, audio, n_blocks=2000)
        phase_serving(card, misses, flagship, rain, n_slots=256, n_blocks=200)
        phase_batch(card, misses, n_files=16, frames=audio.shape[0])
        phase_oracles(card, misses, frames=192_000)
        phase_sockets(card, misses, flagship, n_clients=4, n_blocks=100)

    print(json.dumps({"phase": "total", "wall_s": time.perf_counter() - t_all}), flush=True)
    if misses:
        for m in misses:
            print(f"chip_smoke: parity miss: {m}", file=sys.stderr)
        return 1
    print(card, flush=True)
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {"platform": d.platform,
                                             "kind": d.device_kind,
                                             "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
