"""Multi-session pool server: many clients, one batched device dispatch.

Two concurrent sessions stream blocks through a shared-topology pool with
PER-SESSION parameters; their outputs must reflect their own params, and
a released slot must come back fresh for the next claimant.
"""

import asyncio
import json

import numpy as np
import pytest


CFG = [{"effect_id": "f", "type": "filter",
        "params": {"filter_type": 0, "cutoff_hz": 8000, "q": 0.707}}]


def _tone(n, f, fs=48000, amp=0.3):
    return (amp * np.sin(2 * np.pi * f * np.arange(n) / fs)).astype(np.float32)


def test_pool_two_sessions_per_session_params(tmp_path):
    websockets = pytest.importorskip("websockets")

    async def scenario():
        import websockets as ws
        from aefs_tpu.server.pool import PoolServer, SessionPool

        pool = SessionPool(CFG, n_slots=2)
        srv = PoolServer(pool)
        server = await ws.serve(srv.handler, "127.0.0.1", 0, max_size=2**26)
        port = server.sockets[0].getsockname()[1]
        batcher = asyncio.create_task(srv.batcher())

        async def rms_of_stream(client, n_blocks=40):
            vals = []
            for _ in range(n_blocks):
                await client.send(json.dumps({
                    "command": "stream_block",
                    "audio": _tone(pool.blocksize, 6000).tolist()}))
                msg = json.loads(await asyncio.wait_for(client.recv(), 60))
                assert msg["type"] == "processed_block"
                vals.append(np.sqrt(np.mean(np.square(msg["output"]))))
            return float(np.mean(vals[n_blocks // 2:]))  # settled half

        try:
            async with ws.connect(f"ws://127.0.0.1:{port}", max_size=2**26) as a, \
                    ws.connect(f"ws://127.0.0.1:{port}", max_size=2**26) as b:
                ra = json.loads(await a.recv())
                rb = json.loads(await b.recv())
                assert {ra["slot"], rb["slot"]} == {0, 1}
                assert ra["chain"] == CFG

                # session B turns its cutoff far below the 6 kHz tone;
                # session A keeps the open 8 kHz default.
                await b.send(json.dumps({
                    "command": "update_param", "effect_id": "f",
                    "param": "cutoff_hz", "value": 300}))
                # cutoff glides multiplicatively ~10%/block: give it blocks
                # to converge, interleaving both sessions concurrently
                rms_a, rms_b = await asyncio.gather(
                    rms_of_stream(a), rms_of_stream(b))
                assert rms_a > 0.1, rms_a          # open filter passes the tone
                assert rms_b < rms_a / 4, (rms_a, rms_b)  # B's lowpass bites

                # pool full: a third session is refused
                async with ws.connect(f"ws://127.0.0.1:{port}") as c:
                    msg = json.loads(await asyncio.wait_for(c.recv(), 30))
                    assert msg["type"] == "error" and "full" in msg["error"]

                # stats
                await a.send(json.dumps({"command": "get_pool_stats"}))
                msg = json.loads(await asyncio.wait_for(a.recv(), 30))
                assert msg["type"] == "pool_stats"
                assert msg["slots"] == 2 and msg["active"] == 2
                assert msg["deadline_ms"] == pytest.approx(
                    msg["blocksize"] / 48000 * 1000, abs=1e-3  # payload rounds to 3dp
                )
                assert isinstance(msg["realtime_ok"], bool)

            # both sessions gone: slots return, and a new claimant gets
            # FRESH state/targets (B's 300 Hz cutoff must not leak)
            await asyncio.sleep(0.2)
            async with ws.connect(f"ws://127.0.0.1:{port}", max_size=2**26) as c:
                json.loads(await c.recv())
                rms_c_first = None
                for _ in range(6):
                    await c.send(json.dumps({
                        "command": "stream_block",
                        "audio": _tone(pool.blocksize, 6000).tolist()}))
                    msg = json.loads(await asyncio.wait_for(c.recv(), 60))
                    rms_c_first = np.sqrt(np.mean(np.square(msg["output"])))
                assert rms_c_first > 0.1, rms_c_first
        finally:
            batcher.cancel()
            server.close()
            await server.wait_closed()

    asyncio.run(scenario())


def test_pool_sharded_matches_unsharded():
    """shard=True distributes the slot axis over the (virtual 8-device)
    mesh; outputs must match the single-device pool bit-for-bit-ish,
    including per-slot divergent parameters."""
    from aefs_tpu.server.pool import SessionPool

    cfg = [
        {"effect_id": "f", "type": "filter",
         "params": {"filter_type": 0, "cutoff_hz": 4000, "q": 0.8}},
        {"effect_id": "r", "type": "reverb",
         "params": {"rt60_s": 1.5, "damp": 0.1, "pre_delay_ms": 5,
                    "mix_dry": 0.7, "mix_wet": 0.5}},
    ]
    import jax
    assert len(jax.devices()) >= 8  # conftest virtual mesh

    pa = SessionPool(cfg, n_slots=8)
    pb = SessionPool(cfg, n_slots=8, shard=True)
    for p in (pa, pb):
        p.update_param(3, "f", "cutoff_hz", 500)
        p.update_param(5, "r", "rt60_s", 4.0)

    rng = np.random.default_rng(0)
    for i in range(4):
        blocks = {s: rng.standard_normal(pa.blocksize).astype(np.float32) * 0.2
                  for s in (0, 3, 5)}
        oa = pa.step_blocks(dict(blocks))
        ob = pb.step_blocks(dict(blocks))
        for s in blocks:
            err = np.max(np.abs(oa[s] - ob[s]))
            assert err < 1e-5, (i, s, err)
    # slots 3 and 0 diverge (different cutoffs) — the per-slot params bite
    assert not np.allclose(oa[0], oa[3])


def test_pool_dynamics_chain_sharded_matches_unsharded():
    """Round-3 effects in the batched pool: the compressor's
    (max, x)-semiring scan and the RBJ shelf must vmap over the slot
    axis and shard over the mesh exactly like the original effects —
    per-slot divergent thresholds/gains included."""
    from aefs_tpu.server.pool import SessionPool

    cfg = [
        {"effect_id": "c", "type": "compressor",
         "params": {"threshold_db": -24, "ratio": 6, "attack_ms": 5,
                    "release_ms": 80, "knee_db": 4, "makeup_db": 2}},
        {"effect_id": "f", "type": "filter",
         "params": {"filter_type": 5, "cutoff_hz": 5000, "q": 0.707,
                    "gain_db": 6.0}},
    ]
    import jax
    assert len(jax.devices()) >= 8

    pa = SessionPool(cfg, n_slots=8)
    pb = SessionPool(cfg, n_slots=8, shard=True)
    for p in (pa, pb):
        p.update_param(2, "c", "threshold_db", -40)
        p.update_param(6, "f", "gain_db", -12.0)

    rng = np.random.default_rng(7)
    for i in range(4):
        blocks = {s: rng.standard_normal(pa.blocksize).astype(np.float32) * 0.5
                  for s in (0, 2, 6)}
        oa = pa.step_blocks(dict(blocks))
        ob = pb.step_blocks(dict(blocks))
        for s in blocks:
            assert np.all(np.isfinite(oa[s]))
            err = np.max(np.abs(oa[s] - ob[s]))
            assert err < 1e-5, (i, s, err)
    # the divergent threshold (slot 2, 16 dB lower) compresses harder
    assert not np.allclose(oa[0], oa[2])
    assert not np.allclose(oa[0], oa[6])


def test_pool_modulation_chain_sharded_matches_unsharded():
    """Modulation trio in the batched pool: per-slot compensated LFO
    phasors (tremolo/phaser state scalars) and the chorus's per-slot
    fractional taps must vmap and shard exactly."""
    from aefs_tpu.server.pool import SessionPool

    cfg = [
        {"effect_id": "ch", "type": "chorus",
         "params": {"rate_hz": 1.2, "depth_ms": 4.0, "base_ms": 15.0,
                    "mix": 0.6, "spread": 0.25}},
        {"effect_id": "ph", "type": "phaser",
         "params": {"rate_hz": 0.8, "min_hz": 300, "max_hz": 2000,
                    "mix": 0.5, "spread": 0.0}},
        {"effect_id": "tr", "type": "tremolo",
         "params": {"rate_hz": 5.0, "depth": 0.4, "spread": 0.5}},
    ]
    import jax
    assert len(jax.devices()) >= 8

    pa = SessionPool(cfg, n_slots=8)
    pb = SessionPool(cfg, n_slots=8, shard=True)
    for p in (pa, pb):
        p.update_param(1, "tr", "depth", 1.0)
        p.update_param(4, "ph", "rate_hz", 4.0)

    rng = np.random.default_rng(11)
    for i in range(3):
        blocks = {s: rng.standard_normal(pa.blocksize).astype(np.float32) * 0.3
                  for s in (0, 1, 4)}
        oa = pa.step_blocks(dict(blocks))
        ob = pb.step_blocks(dict(blocks))
        for s in blocks:
            assert np.all(np.isfinite(oa[s]))
            assert np.max(np.abs(oa[s] - ob[s])) < 1e-5, (i, s)
    assert not np.allclose(oa[0], oa[1])  # divergent depth bites


def test_pool_lofi_chain_sharded_matches_unsharded():
    """Integer-phase effects in the batched pool: per-slot uint32 phase
    accumulators (ringmod carrier, bitcrusher decimation clock) and the
    bitcrusher's per-slot held sample must vmap and shard exactly —
    and, being integer state, slots with identical params stay BITWISE
    in phase forever."""
    from aefs_tpu.server.pool import SessionPool

    cfg = [
        {"effect_id": "bc", "type": "bitcrusher",
         "params": {"bits": 6.0, "rate_hz": 9001.0, "mix": 1.0}},
        {"effect_id": "rm", "type": "ringmod",
         "params": {"carrier_hz": 880.0, "mix": 0.5, "spread": 0.25}},
        # feedback-state effect: per-slot delay-line history + nilpotent
        # in-chunk solve must vmap/shard exactly too
        {"effect_id": "fl", "type": "flanger",
         "params": {"rate_hz": 0.8, "depth_ms": 1.5, "base_ms": 2.0,
                    "feedback": 0.5, "mix": 0.4, "spread": 0.0}},
    ]
    import jax
    assert len(jax.devices()) >= 8

    pa = SessionPool(cfg, n_slots=8)
    pb = SessionPool(cfg, n_slots=8, shard=True)
    for p in (pa, pb):
        p.update_param(1, "rm", "carrier_hz", 55.0)
        p.update_param(4, "bc", "bits", 2.0)

    rng = np.random.default_rng(12)
    for i in range(3):
        blocks = {s: rng.standard_normal(pa.blocksize).astype(np.float32) * 0.3
                  for s in (0, 1, 4)}
        blocks[3] = blocks[0]  # slot 3 mirrors slot 0 bit-for-bit
        oa = pa.step_blocks(dict(blocks))
        ob = pb.step_blocks(dict(blocks))
        for s in blocks:
            assert np.all(np.isfinite(oa[s]))
            assert np.max(np.abs(oa[s] - ob[s])) < 1e-5, (i, s)
    # same input + same params -> bitwise identical integer-phase output
    np.testing.assert_array_equal(oa[0], oa[3])
    assert not np.allclose(oa[0], oa[1])  # divergent carrier bites
    assert not np.allclose(oa[0], oa[4])  # divergent bit depth bites


def test_pool_multiband_sharded_matches_unsharded():
    """The multiband expansion (LR4 splitters over the parallel
    container) must batch and shard like any chain — per-slot lifted
    branch params included (a crossover move on one slot only)."""
    from aefs_tpu.server.pool import SessionPool

    cfg = [{"effect_id": "mb", "type": "multiband",
            "crossover_hz": [800.0],
            "branches": [[{"effect_id": "c", "type": "compressor",
                           "params": {"threshold_db": -20.0, "ratio": 4.0,
                                      "attack_ms": 5.0, "release_ms": 120.0,
                                      "knee_db": 6.0, "makeup_db": 0.0}}],
                         []]}]
    import jax
    assert len(jax.devices()) >= 8

    pa = SessionPool(cfg, n_slots=8)
    pb = SessionPool(cfg, n_slots=8, shard=True)
    for pool in (pa, pb):
        pool.update_param(2, "mb", "b0_0_cutoff_hz", 300.0)  # move crossover

    rng = np.random.default_rng(13)
    for i in range(3):
        blocks = {0: rng.standard_normal(pa.blocksize).astype(np.float32) * 0.4}
        blocks[2] = blocks[0]  # same input; only the crossover diverges
        oa = pa.step_blocks(dict(blocks))
        ob = pb.step_blocks(dict(blocks))
        for s in blocks:
            assert np.all(np.isfinite(oa[s]))
            assert np.max(np.abs(oa[s] - ob[s])) < 1e-5, (i, s)
    assert not np.allclose(oa[0], oa[2])  # divergent crossover bites


def test_pool_batcher_survives_step_failure():
    """A failing dispatch must neither kill the batcher task (every later
    submission would hang) nor the session: the waiter gets the error,
    the next block processes normally."""
    websockets = pytest.importorskip("websockets")

    async def scenario():
        import websockets as ws
        from aefs_tpu.server.pool import PoolServer, SessionPool

        pool = SessionPool(CFG, n_slots=1)
        # The batcher's default path is the depth-1 pipelined step —
        # inject the fault there.
        orig = pool.step_blocks_pipelined
        calls = {"n": 0}

        def flaky(blocks):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("injected device fault")
            return orig(blocks)

        pool.step_blocks_pipelined = flaky
        srv = PoolServer(pool)
        server = await ws.serve(srv.handler, "127.0.0.1", 0, max_size=2**26)
        port = server.sockets[0].getsockname()[1]
        batcher = asyncio.create_task(srv.batcher())
        try:
            async with ws.connect(f"ws://127.0.0.1:{port}") as client:
                ready = json.loads(await client.recv())
                n = ready["blocksize"]
                blk = (0.1 * np.random.default_rng(0).standard_normal(n)).tolist()
                # First block hits the injected fault: the handler logs it
                # and sends nothing, but the connection stays open.
                await client.send(json.dumps(
                    {"command": "stream_block", "audio": blk}))
                with pytest.raises(asyncio.TimeoutError):
                    await asyncio.wait_for(client.recv(), 2)
                # Second block processes normally through the same batcher.
                await client.send(json.dumps(
                    {"command": "stream_block", "audio": blk}))
                msg = json.loads(await asyncio.wait_for(client.recv(), 30))
                assert msg["type"] == "processed_block"
                assert len(msg["output"]) == n
        finally:
            batcher.cancel()
            server.close()
            await server.wait_closed()
        assert calls["n"] >= 2

    asyncio.run(scenario())


def test_pool_with_parallel_branch_chain():
    """The pool accepts any registry chain — including the parallel
    container with lifted branch params; a session's branch-gain update
    routes through the batched per-slot targets."""
    websockets = pytest.importorskip("websockets")

    par_cfg = [{
        "effect_id": "p", "type": "parallel",
        "branches": [
            [{"effect_id": "bf", "type": "filter",
              "params": {"filter_type": 0, "cutoff_hz": 8000, "q": 0.707}}],
            [{"effect_id": "bd", "type": "delay",
              "params": {"delay_ms": 100, "feedback": 0.1,
                         "mix_dry": 0.0, "mix_wet": 1.0}}],
        ],
        "params": {},
    }]

    async def scenario():
        import websockets as ws
        from aefs_tpu.server.pool import PoolServer, SessionPool

        pool = SessionPool(par_cfg, n_slots=1)
        srv = PoolServer(pool)
        server = await ws.serve(srv.handler, "127.0.0.1", 0, max_size=2**26)
        port = server.sockets[0].getsockname()[1]
        batcher = asyncio.create_task(srv.batcher())
        try:
            async with ws.connect(f"ws://127.0.0.1:{port}") as client:
                ready = json.loads(await client.recv())
                n = ready["blocksize"]

                async def rms(n_blocks=30):
                    vals = []
                    for _ in range(n_blocks):
                        await client.send(json.dumps({
                            "command": "stream_block",
                            "audio": _tone(n, 1000).tolist()}))
                        msg = json.loads(
                            await asyncio.wait_for(client.recv(), 60))
                        assert msg["type"] == "processed_block"
                        vals.append(np.sqrt(np.mean(np.square(msg["output"]))))
                    return float(np.mean(vals[n_blocks // 2:]))

                loud = await rms()
                # Mute both branches via the lifted per-branch gains.
                for param in ("gain_0", "gain_1"):
                    await client.send(json.dumps({
                        "command": "update_param", "effect_id": "p",
                        "param": param, "value": 0.0}))
                quiet = await rms()
                assert quiet < loud * 0.2, (loud, quiet)
        finally:
            batcher.cancel()
            server.close()
            await server.wait_closed()

    asyncio.run(scenario())


def test_pool_sharded_release_reclaim_and_fault_recovery(monkeypatch):
    """The multi-chip product surface under churn: a sharded pool with
    donation must (a) keep per-slot params divergent, (b) hand a released
    slot back FRESH (state reset queued at release, applied at the next
    dispatch), and (c) recover from a failed dispatch that consumed the
    donated state — all bit-matching an unsharded pool driven through the
    identical op sequence."""
    import jax
    from aefs_tpu.server.pool import SessionPool

    assert len(jax.devices()) >= 8  # conftest virtual mesh
    monkeypatch.setenv("AEFS_POOL_DONATE", "1")

    cfg = [
        {"effect_id": "f", "type": "filter",
         "params": {"filter_type": 0, "cutoff_hz": 4000, "q": 0.8}},
        {"effect_id": "d", "type": "delay",
         "params": {"delay_ms": 50, "feedback": 0.4, "mix_dry": 0.6,
                    "mix_wet": 0.8, "offset_ms": 5}},
    ]
    pa = SessionPool(cfg, n_slots=8)
    pb = SessionPool(cfg, n_slots=8, shard=True)
    assert pa._donate and pb._donate

    rng = np.random.default_rng(1)
    sig = [rng.standard_normal(pa.blocksize).astype(np.float32) * 0.2
           for _ in range(10)]

    def drive(pool):
        outs = []
        slots = [pool.claim() for _ in range(3)]       # 0, 1, 2
        pool.update_param(slots[1], "f", "cutoff_hz", 400)
        # slot 2 diverges via a param with immediate effect (the filter
        # glide bites within a few blocks; a delay-tail change would not
        # surface inside this test's 10-block horizon)
        pool.update_param(slots[2], "f", "cutoff_hz", 800)
        pool.update_param(slots[2], "d", "feedback", 0.7)
        for k in range(3):
            outs.append(pool.step_blocks({s: sig[k] for s in slots}))
        # slot 1 leaves; its 400 Hz cutoff and delay tail must not leak
        # (the FIFO free-list hands the next claimant a different slot
        # first — drive the released slot explicitly after reclaiming it)
        pool.release(slots[1])
        while True:
            re = pool.claim()
            if re == slots[1]:
                break
        for k in range(3, 6):
            outs.append(pool.step_blocks({s: sig[k] for s in (0, re, 2)}))
        # inject a device fault mid-serving: the donated state is gone,
        # recovery resets it; the pool keeps serving
        orig = pool._step
        def boom(*a, **k):
            raise RuntimeError("injected fault")
        pool._step = boom
        try:
            pool.step_blocks({0: sig[6]})
            raise AssertionError("expected injected fault")
        except RuntimeError:
            pass
        finally:
            pool._step = orig
        for k in range(7, 10):
            outs.append(pool.step_blocks({s: sig[k] for s in (0, re, 2)}))
        return outs

    oa, ob = drive(pa), drive(pb)
    for i, (da, db) in enumerate(zip(oa, ob)):
        assert da.keys() == db.keys()
        for s in da:
            err = np.max(np.abs(da[s] - db[s]))
            assert err < 1e-5, (i, s, err)
    # per-slot divergence held through the churn
    last = oa[-1]
    assert not np.allclose(last[0], last[2])


def test_pool_grid_octaver_specialization():
    """grid=True bakes whole-octave octaver ratios: outputs match the
    grid-specialized single chain, and live semitone updates are refused
    with a warning instead of silently doing nothing."""
    from aefs_tpu.core.chain import build_chain
    from aefs_tpu.server.pool import SessionPool, grid_static_overrides

    cfg = [{"effect_id": "o", "type": "octaver",
            "params": {"semitones": -12, "mix": 0.9}}]
    ov = grid_static_overrides(cfg)
    assert ov == {"o": {"grid_semitones": -12.0, "grid_phase_lock": True}}

    pool = SessionPool(cfg, n_slots=2, grid=True)
    err = pool.update_param(0, "o", "semitones", -7)
    assert err and "grid-specialized" in err
    err = pool.update_param(0, "o", "grid_phase", 7)
    assert err and "pool-managed" in err
    assert pool.update_param(0, "o", "mix", 0.9) is None

    # Reference: the same phase-locked chain driven single-stream, with
    # the grid_phase target advanced per block exactly as the pool does.
    chain, state, tmap = build_chain(
        cfg, pool.fs, pool.blocksize, channels_in=1, channels_out=2,
        static_overrides=ov,
    )
    model = dict(chain.effects)["o"]
    adv, mod = model.grid_phase_advance()
    phase = 0
    rng = np.random.default_rng(2)
    for _ in range(6):
        blk = rng.standard_normal(pool.blocksize).astype(np.float32) * 0.3
        out = pool.step_blocks({0: blk})
        tm = {k: dict(v) for k, v in tmap.items()}
        tm.setdefault("o", {})["grid_phase"] = float(phase)
        state, y = chain.process_block(state, chain.targets(tm), blk[None, :])
        phase = (phase + adv) % mod
        err = np.max(np.abs(out[0] - np.asarray(y).T))
        assert err < 1e-6, err
    # the pool's shared phase actually advanced
    row = next(iter(pool._phase_rows))
    assert pool._tbuf[row, 0] == phase
    # a released slot keeps the shared phase (fresh state, same grid)
    pool.release(0)
    assert pool._tbuf[row, 0] == pool._tbuf[row, 1] == phase


def test_pool_sharded_grid_matches_unsharded_grid():
    """shard=True composes with grid=True: the batch-uniform grid_phase
    scalar reads across the sharded target buffer and the outputs match
    the single-device grid pool."""
    import jax
    from aefs_tpu.server.pool import SessionPool

    assert len(jax.devices()) >= 8
    cfg = [
        {"effect_id": "o", "type": "octaver",
         "params": {"semitones": -12, "mix": 0.7}},
        {"effect_id": "f", "type": "filter",
         "params": {"filter_type": 0, "cutoff_hz": 3000, "q": 0.8}},
    ]
    pa = SessionPool(cfg, n_slots=8, grid=True)
    pb = SessionPool(cfg, n_slots=8, shard=True, grid=True)
    for p in (pa, pb):
        p.update_param(2, "f", "cutoff_hz", 700)
    rng = np.random.default_rng(4)
    for i in range(5):
        blocks = {s: rng.standard_normal(pa.blocksize).astype(np.float32) * 0.2
                  for s in (0, 2, 5)}
        oa = pa.step_blocks(dict(blocks))
        ob = pb.step_blocks(dict(blocks))
        for s in blocks:
            err = np.max(np.abs(oa[s] - ob[s]))
            assert err < 1e-5, (i, s, err)


def test_pool_pipelined_bit_parity_and_flush(monkeypatch):
    """The depth-1 pipelined batcher path (VERDICT r3 #3): results arrive
    one step late, BITWISE identical to the sync path, and an idle flush
    returns the in-flight batch.  Also covers hybrid-packed dispatch
    arguments (core/packing.py:HybridPacker) vs the plain-pytree step."""
    from aefs_tpu.server.pool import SessionPool

    cfg = [
        {"effect_id": "o", "type": "octaver",
         "params": {"semitones": -12, "mix": 0.7}},
        {"effect_id": "f", "type": "filter",
         "params": {"filter_type": 0, "cutoff_hz": 3000, "q": 0.8}},
    ]
    pa = SessionPool(cfg, n_slots=4)          # sync reference (packed)
    monkeypatch.setenv("AEFS_POOL_PACK", "0")
    pc = SessionPool(cfg, n_slots=4)          # plain pytree arguments
    monkeypatch.delenv("AEFS_POOL_PACK")
    pb = SessionPool(cfg, n_slots=4)          # pipelined (packed)
    assert pa._packer is not None and pc._packer is None
    for p in (pa, pb, pc):
        p.update_param(1, "f", "cutoff_hz", 500)

    rng = np.random.default_rng(7)
    blocks_seq = [
        {s: rng.standard_normal(pa.blocksize).astype(np.float32) * 0.2
         for s in (0, 1, 3)}
        for _ in range(6)
    ]
    sync_outs = [pa.step_blocks(dict(b)) for b in blocks_seq]
    pack_outs = [pc.step_blocks(dict(b)) for b in blocks_seq]

    pipe_outs = []
    first = pb.step_blocks_pipelined(dict(blocks_seq[0]))
    assert first is None  # pipeline was empty
    for b in blocks_seq[1:]:
        pipe_outs.append(pb.step_blocks_pipelined(dict(b)))
    pipe_outs.append(pb.flush_pipeline())  # idle flush drains the last one
    assert pb.flush_pipeline() is None     # now empty

    for k, (sy, pk, pi) in enumerate(zip(sync_outs, pack_outs, pipe_outs)):
        assert set(sy) == set(pk) == set(pi) == {0, 1, 3}
        for s in sy:
            np.testing.assert_array_equal(sy[s], pi[s], err_msg=f"{(k, s)}")
            np.testing.assert_array_equal(sy[s], pk[s], err_msg=f"{(k, s)}")

    # Guard: sync and pipelined calls must not interleave silently.
    pb.step_blocks_pipelined(dict(blocks_seq[0]))
    with pytest.raises(RuntimeError, match="in flight"):
        pb.step_blocks(dict(blocks_seq[0]))
    pb.drop_pipeline()


def test_pool_discard_frees_without_gc():
    """A discarded SessionPool must free under refcounting ALONE: the
    serving process runs gc.disable() (pool.py main), so any
    self -> _step -> closure -> self cycle (or an unreleased chain
    jit-cache cycle) leaks the pool and its compiled executables on
    every rebuild.  The jit closures bind locals, never ``self``; close()
    breaks the chain's cache cycle (Chain.release)."""
    import gc
    import weakref

    from aefs_tpu.server.pool import SessionPool

    pool = SessionPool(CFG, n_slots=2)
    pool.step_blocks({0: _tone(pool.blocksize, 1000)})
    wp = weakref.ref(pool)
    wc = weakref.ref(pool.chain)
    gc.collect()        # clear unrelated garbage first
    gc.disable()        # serving-process conditions: no cycle collector
    try:
        pool.close()
        del pool
        assert wp() is None, "SessionPool kept alive by a closure cycle"
        assert wc() is None, "chain kept alive after close() (jit cache)"
    finally:
        gc.enable()


def test_pool_readback_failure_resets_donated_state():
    """A donated dispatch can fail ASYNCHRONOUSLY — the error surfaces at
    the pipelined READBACK (np.asarray of the previous batch), not at the
    enqueue.  The recovery must be the same as an enqueue failure: drop
    the in-flight generation and rebuild fresh state, or every later step
    raises 'Array has been deleted' and a transient fault becomes a
    permanent outage."""
    from aefs_tpu.server.pool import SessionPool

    class Boom:
        def __array__(self, *a, **k):
            raise RuntimeError("poisoned async result")

    # flush_pipeline path
    pool = SessionPool(CFG, n_slots=2)
    pool._donate = True
    fresh = pool._fresh_batched_state()
    pool._inflight = (Boom(), (0,))
    with pytest.raises(RuntimeError):
        pool.flush_pipeline()
    assert pool._inflight is None
    pool._donate = False  # the real state was never donated in this test
    out = pool.step_blocks({0: _tone(pool.blocksize, 1000)})
    assert np.all(np.isfinite(out[0]))
    pool.close()
    del fresh

    # step_blocks_pipelined path: the poisoned generation is dropped and
    # the state reset even though THIS dispatch succeeded.
    pool = SessionPool(CFG, n_slots=2)
    pool._donate = True
    pool._inflight = (Boom(), (0,))
    with pytest.raises(RuntimeError):
        pool.step_blocks_pipelined({0: _tone(pool.blocksize, 1000)})
    assert pool._inflight is None
    pool._donate = False
    out = pool.step_blocks({0: _tone(pool.blocksize, 1000)})
    assert np.all(np.isfinite(out[0]))
    pool.close()


def test_pool_readback_failure_resets_undonated_state():
    """An asynchronous device/transport failure poisons ``self.state`` even
    WITHOUT donation: the enqueue's tuple assignment already replaced it
    with the failed dispatch chain's error-array output before np.asarray
    raised.  The readback handlers must therefore reset unconditionally
    (ADVICE r4) — in the default non-donated mode a donate-gated reset
    turns one transient fault into a permanent every-step failure."""
    from aefs_tpu.server.pool import SessionPool

    class Boom:
        def __array__(self, *a, **k):
            raise RuntimeError("poisoned async result")

    for path in ("flush", "pipelined"):
        pool = SessionPool(CFG, n_slots=2)
        assert not pool._donate
        resets = []
        orig = pool._fresh_batched_state
        pool._fresh_batched_state = lambda: (resets.append(1), orig())[1]
        pool._inflight = (Boom(), (0,))
        with pytest.raises(RuntimeError):
            if path == "flush":
                pool.flush_pipeline()
            else:
                pool.step_blocks_pipelined({0: _tone(pool.blocksize, 1000)})
        assert resets, f"{path}: no unconditional state reset on readback failure"
        assert pool._inflight is None
        out = pool.step_blocks({0: _tone(pool.blocksize, 1000)})
        assert np.all(np.isfinite(out[0]))
        pool.close()
