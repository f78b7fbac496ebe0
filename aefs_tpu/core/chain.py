"""The effect-graph substrate (functional replacement for the reference's
``EffectsChain``, core.py:109-160).

A ``Chain`` is a static description: sample rate, channel map, blocksize,
and an ordered list of (effect_id, EffectModel).  All mutable data — every
effect's audio state plus the smoothed parameter currents — lives in one
state pytree.  One call to ``process_block`` is one fully-traced block:

    state, y = chain.process_block(state, targets, x)

and the whole chain compiles to a single XLA program per
(blocksize, fs, topology), the analogue of the reference's re-``prepare``
on blocksize change (core.py:123-129).  ``warmup`` runs two dummy blocks to
force compilation off the hot path (core.py:131-136).

File mode (engine.py:67-129) is a ``lax.scan`` of the same block function
over on-device superblocks — one dispatch for the whole file.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from aefs_tpu.core.params import smooth_all


class Chain:
    def __init__(self, fs: int, channels_in: int, channels_out: int,
                 blocksize: int, effects):
        self.fs = int(fs)
        self.ci = int(channels_in)
        self.co = int(channels_out)
        self.blocksize = int(blocksize)
        self.effects = tuple(effects)  # ordered (effect_id, model)
        self.config_seeds = {}  # {effect_id: params} captured by build_chain
        self._jit_cache = {}

    # -- state ----------------------------------------------------------
    def init_state(self, configs=None):
        """configs: optional {effect_id: params-dict} initial live values;
        defaults to the chain-config seeds captured at build time."""
        configs = self.config_seeds if configs is None else configs
        fx, params = [], []
        for eid, model in self.effects:
            fx.append(model.init_state())
            params.append(model.initial_params(configs.get(eid, {})))
        return {"fx": tuple(fx), "params": tuple(params)}

    def state_axes(self, batch_axis: int = 0):
        """vmap in/out axes for a batched (multi-stream) state pytree:
        ``batch_axis`` everywhere except each model's LOCKSTEP_STATE
        leaves, which stay unbatched (None) — they are pure per-block
        counters identical in every stream when all streams step
        together, and keeping them uniform keeps ring-row index ops off
        the batched-index DUS trap (ops/ringbuf.py:rowring_write)."""
        fx = tuple(
            model.state_axes_tree(batch_axis) for eid, model in self.effects
        )
        return {"fx": fx, "params": batch_axis}

    def batch_state(self, one, n_streams: int):
        """Broadcast a single-stream state to ``n_streams`` slots,
        keeping LOCKSTEP_STATE leaves unbatched (shared counters) —
        the batched-state companion of ``state_axes``."""
        bcast = lambda leaf: jnp.broadcast_to(
            leaf[None], (n_streams,) + leaf.shape
        ).copy()
        # Lockstep leaves are COPIED, not aliased: ``one`` may be a shared
        # fresh-state template, and a donated dispatch would otherwise
        # consume the template's buffer.
        copy = lambda leaf: jnp.array(leaf, copy=True)
        fx = tuple(
            model.map_state(bcast, copy, st)
            for (eid, model), st in zip(self.effects, one["fx"])
        )
        return {"fx": fx, "params": jax.tree.map(bcast, one["params"])}

    def graft_slot_state(self, batched, single, slot):
        """Write ``single``'s audio state into one slot of a batched
        state (pool slot reset).  LOCKSTEP_STATE leaves keep the shared
        running counter: a freshly zeroed ring is self-consistent from
        ANY row alignment, and resetting the shared row would desync the
        other slots."""
        fx = tuple(
            model.map_state(
                lambda b, s: b.at[slot].set(s), lambda b, s: b, bst, sst)
            for (eid, model), bst, sst in zip(
                self.effects, batched["fx"], single["fx"])
        )
        params = jax.tree.map(lambda b, s: b.at[slot].set(s),
                              batched["params"], single["params"])
        return {"fx": fx, "params": params}

    def targets(self, per_effect: dict):
        """Build the targets pytree (tuple of dicts in chain order) from a
        host-side {effect_id: {param: float}} map; missing params fall back
        to spec defaults, values are clamped like SmoothParam.set_target
        (core.py:64-66)."""
        out = []
        for eid, model in self.effects:
            cfg = per_effect.get(eid, {})
            out.append(
                {
                    name: jnp.float32(spec.clamp(cfg.get(name, spec.default)))
                    for name, spec in model.PARAMS.items()
                }
            )
        return tuple(out)

    # -- processing -----------------------------------------------------
    def _fan_in(self, x):
        """Channel fan (core.py:147-154): mono->stereo duplicates, otherwise
        copy the common channels and zero the rest."""
        if self.ci == 1 and self.co == 2:
            return jnp.concatenate([x, x], axis=0)
        ch = min(self.ci, self.co)
        pad = self.co - ch
        if pad:
            z = jnp.zeros((pad, x.shape[-1]), x.dtype)
            return jnp.concatenate([x[:ch], z], axis=0)
        return x[:ch]

    def _process(self, state, targets, x, method):
        buf = self._fan_in(x)
        new_fx, new_params = [], []
        for i, (eid, model) in enumerate(self.effects):
            pcur = smooth_all(model.PARAMS, state["params"][i], targets[i], self.fs)
            st, buf = getattr(model, method)(state["fx"][i], pcur, buf)
            new_fx.append(st)
            new_params.append(pcur)
        return {"fx": tuple(new_fx), "params": tuple(new_params)}, buf

    def process_block(self, state, targets, x):
        """x: (ci, N) float32 -> (new_state, (co, N))."""
        return self._process(state, targets, x, "process")

    # -- compiled entry points ------------------------------------------
    def step(self):
        """Jitted single-block step (the mic-mode hot path)."""
        key = ("step", self.blocksize)
        if key not in self._jit_cache:
            self._jit_cache[key] = jax.jit(
                self.process_block, donate_argnums=(0,)
            )
        return self._jit_cache[key]

    def file_fn(self, n_blocks: int):
        """Jitted scan of the block step over a whole file's superblocks."""
        key = ("file", self.blocksize, n_blocks)
        if key not in self._jit_cache:

            def run(state, targets, blocks):
                def scan_fn(carry, xb):
                    st, y = self.process_block(carry, targets, xb)
                    return st, y

                state, ys = lax.scan(scan_fn, state, blocks)
                return state, ys

            self._jit_cache[key] = jax.jit(run, donate_argnums=(0,))
        return self._jit_cache[key]

    def process_whole(self, state, targets, x):
        """Whole-signal pass: like ``process_block`` but routed through each
        effect's ``process_file`` fast path (one parameter-smoothing step,
        then every effect transforms the entire signal in closed form —
        no per-block scan)."""
        return self._process(state, targets, x, "process_file")

    def fast_file_fn(self, n_samples: int):
        key = ("fast", n_samples)
        if key not in self._jit_cache:
            self._jit_cache[key] = jax.jit(self.process_whole, donate_argnums=(0,))
        return self._jit_cache[key]

    def packed_step(self):
        """PackedRunner over the block step: the compiled program takes one
        donated buffer per state dtype (2 for typical chains) plus one
        packed targets vector instead of ~50 leaf buffers — per-argument
        dispatch marshaling is the wall for streaming/serving (see
        core/packing.py).  This is the engine's and pool's hot path."""
        key = ("packed_step", self.blocksize)
        if key not in self._jit_cache:
            from aefs_tpu.core.packing import PackedRunner

            self._jit_cache[key] = PackedRunner(
                self.process_block, self.init_state(), self.targets({})
            )
        return self._jit_cache[key]

    def packed_fast_file_fn(self):
        """PackedRunner over the whole-file fast path (same argument-count
        rationale as ``packed_step``; cuts single-dispatch file latency)."""
        key = "packed_fast"
        if key not in self._jit_cache:
            from aefs_tpu.core.packing import PackedRunner

            self._jit_cache[key] = PackedRunner(
                self.process_whole, self.init_state(), self.targets({})
            )
        return self._jit_cache[key]

    def release(self):
        """Break the chain's reference cycle so it frees under refcounting
        alone.  ``_jit_cache`` holds jitted wrappers (and PackedRunners)
        closing over BOUND METHODS of this chain — chain -> cache -> fn ->
        chain — and the serving processes run with ``gc.disable()``
        (backend.py:123 parity), where cyclic garbage is NEVER collected:
        without this, every chain rebuild / file upload leaked the whole
        chain plus its compiled XLA executables (~MBs each, measured
        30/30 superseded chains alive after 30 rebuilds).  Callers that
        replace or finish with a chain call release() on the old one; a
        concurrent holder of a released chain stays correct — the cache
        just re-jits on next use."""
        self._jit_cache.clear()

    def warmup(self, state, targets):
        """Compile + run two dummy blocks (core.py:131-136); returns a fresh
        state identical to ``state`` (the dummy run is discarded — the step
        donates its input, so the state is rebuilt from the chain-config
        seeds).  The engine's hot path warms the PACKED runner instead
        (engine._warm_runner); this is the plain-pytree parity surface."""
        step = self.step()
        dummy = jnp.zeros((self.ci, self.blocksize), jnp.float32)
        st = state
        for _ in range(2):
            st, y = step(st, targets, dummy)
        # Wait on the audio output (an empty chain carries no state).
        jax.block_until_ready(y)
        return self.init_state()  # seeded via config_seeds

    def process_array(self, state, targets, audio, fast: bool = False):
        """Process a whole (frames, ci) array on-device.

        fast=False: lax.scan of the block step over superblocks (works from
        any carried state).
        fast=True: one whole-signal pass through the effects'
        ``process_file`` closed forms — requires fresh state (file mode).

        Returns (new_state, (frames, co) float32).  Frames are padded up to
        a multiple of the blocksize; the pad is trimmed from the output.
        """
        audio = np.asarray(audio, np.float32)
        frames = audio.shape[0]
        n = self.blocksize
        pad = (-frames) % n
        if pad:
            audio = np.concatenate([audio, np.zeros((pad, audio.shape[1]), np.float32)])
        if fast:
            # Packed dispatch (one buffer per state dtype): the file jobs'
            # single-dispatch latency is dominated by per-argument
            # marshaling on remote backends (core/packing.py).
            runner = self.packed_fast_file_fn()
            x = jnp.asarray(audio.T)  # (ci, N)
            sg, y = runner(runner.pack_state(state),
                           runner.pack_targets(targets), x)
            state = runner.unpack_state(sg)
            out = np.asarray(y).T
        else:
            blocks = jnp.asarray(audio.T.reshape(self.ci, -1, n).transpose(1, 0, 2))
            state, ys = self.file_fn(blocks.shape[0])(state, targets, blocks)
            out = np.asarray(ys.transpose(1, 0, 2).reshape(self.co, -1).T)
        return state, out[:frames]


def build_chain(effects_config, fs, blocksize, channels_in=1, channels_out=2,
                registry=None, static_overrides=None):
    """Chain factory from a JSON-style config list (engine.py:38-65).

    effects_config: [{"effect_id": str, "type": str, "params": {...}}, ...]
    static_overrides: optional extra static config, keyed by effect_id
      (takes precedence) or effect type (e.g. delay min_delay_ms for file
      mode).

    Returns (chain, state, targets_map) where targets_map is the host-side
    {effect_id: params} dict mirroring the initial state.
    """
    from aefs_tpu.models import EFFECT_REGISTRY

    registry = registry or EFFECT_REGISTRY
    static_overrides = static_overrides or {}

    effects, configs = [], {}
    for i, cfg in enumerate(effects_config):
        etype = cfg.get("type")
        if etype == "multiband":
            # Syntactic sugar: a Linkwitz-Riley band split over the
            # parallel container (core/multiband.py) — expansion keeps
            # every downstream mechanism (fast path, lifted params,
            # pool, checkpoints) on the one parallel code path.
            from aefs_tpu.core.multiband import expand_multiband

            cfg = expand_multiband(cfg)
            etype = cfg["type"]
        cls = registry.get(etype)
        if cls is None:
            continue  # unknown types are skipped (engine.py:56)
        # Fallback ids use the raw config index — the same convention as
        # core/fileopts.py, so skipped entries can't shift the numbering.
        eid = cfg.get("effect_id") or f"fx{i}"
        params = dict(cfg.get("params", {}))
        _, static = cls.split_config(params)
        # Extra top-level config keys (e.g. a parallel effect's "branches")
        # are static constructor config too.
        static.update(
            {k: v for k, v in cfg.items() if k not in ("effect_id", "type", "params")}
        )
        static.update(static_overrides.get(etype, {}))
        static.update(static_overrides.get(eid, {}))
        model = cls(fs, blocksize, channels=channels_out, **static)
        # Live/static is decided against the *instance* param table — a
        # parallel effect's lifted branch params exist only per instance,
        # and their branch-config values seed the target map too.
        live = {k: v for k, v in params.items() if k in model.PARAMS}
        live = {**getattr(model, "_initial", {}), **live}
        effects.append((eid, model))
        configs[eid] = live

    chain = Chain(fs, channels_in, channels_out, blocksize, effects)
    chain.config_seeds = configs
    # The raw config this chain was built from, kept ON the chain so
    # consumers that snapshot a chain atomically (engine.save_session)
    # get the MATCHING config — the engine's last_chain_config is the
    # latest *requested* config, which can be newer than the live chain
    # for the whole compile window of a concurrent rebuild (a checkpoint
    # pairing new config with old state is unloadable: leaf mismatch).
    chain.source_config = effects_config
    state = chain.init_state(configs)
    targets_map = {
        eid: {k: float(v) for k, v in configs.get(eid, {}).items()}
        for eid, _ in effects
    }
    return chain, state, targets_map
