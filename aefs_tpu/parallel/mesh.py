"""Multi-chip scaling: sharded multi-stream processing over a device mesh.

The reference has no model parallelism (SURVEY.md §2: two processes + an
audio thread).  The device scaling axes for this domain are:

- **data ("dp")**: independent audio streams/sessions — embarrassingly
  parallel, sharded over the ``data`` mesh axis.  This is the production
  serving axis: one backend hosting hundreds of live chains.
- **model ("tp")**: parallel branches *inside* an effect — the reverb's
  comb bank (4 combs per side, reverb.py:234-241) shards over the
  ``model`` axis; the comb-sum reduction becomes an XLA-inserted
  reduce/all-gather between the cards.  The conv reverb's IR-partition axis is the
  other model axis: its frequency-domain delay line (spec_hist) shards
  per partition, the per-partition complex MAC stays local and the
  partition sum is one psum of a (hop+1,) spectrum per block
  (ops/fftops.py:partitioned_fft_conv, streaming k==1 path).
- a cross-stream metering collective (global peak) exercises a psum across
  the whole mesh every step — the framework's heartbeat for clipping
  telemetry.

Sharding is expressed with ``NamedSharding`` + ``jax.jit`` (GSPMD): we
annotate placements, XLA inserts the collectives (scaling-book recipe).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices=None, model_parallel=1, devices=None):
    """Build a (data, model) mesh over the available devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            # A silent devices[:n] here would run an "N-device" dryrun on
            # however few devices the env actually exposes and report it
            # as passing — fail loudly instead.
            raise ValueError(
                f"requested a {n_devices}-device mesh but only "
                f"{len(devices)} devices are visible"
            )
        devices = devices[:n_devices]
    n = len(devices)
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    arr = np.asarray(devices).reshape(n // model_parallel, model_parallel)
    return Mesh(arr, axis_names=("data", "model"))


class ShardedStreams:
    """Run S independent effect chains (one per stream) across a mesh.

    State pytrees gain a leading stream axis (vmap of the chain step);
    streams shard over ``data``.  Reverb comb banks additionally shard
    their bank axis over ``model``.  Returns a per-step global peak meter
    (a cross-mesh collective).
    """

    def __init__(self, chain, mesh: Mesh, n_streams: int):
        self.chain = chain
        self.mesh = mesh
        self.n_streams = int(n_streams)
        data_size = mesh.shape["data"]
        if self.n_streams % data_size:
            raise ValueError(
                f"n_streams={n_streams} must divide over data axis {data_size}"
            )
        self._step = {}

    # -- sharding rules --------------------------------------------------
    def _state_shardings(self, state_batched):
        """Leading axis (streams) -> 'data'; reverb comb-bank leaves also
        shard combs over 'model'."""
        mesh = self.mesh

        def spec_for(path, leaf):
            keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
            if "combs" in keys and leaf.ndim >= 4:
                # (S, sides, combs, Lmax): shard combs over model.
                return NamedSharding(mesh, P("data", None, "model", None))
            if "lps" in keys and leaf.ndim >= 3:
                return NamedSharding(mesh, P("data", None, "model"))
            if ("spec_hist" in keys and leaf.ndim >= 5
                    and leaf.shape[3] % mesh.shape["model"] == 0):
                # ConvReverb frequency-domain delay line
                # (S, C, 2, P-1, hop+1): shard the IR-partition axis over
                # 'model'.  With the streaming k==1 conv path
                # (ops/fftops.py:partitioned_fft_conv) the per-partition
                # MAC stays local and the partition sum is one psum —
                # both the history memory and the MAC FLOPs scale 1/m.
                # device_put needs exact divisibility; build the effect
                # with config partition_multiple = mesh model size to
                # zero-pad P-1 up to it (models/convreverb.py), else the
                # history stays data-sharded only.
                return NamedSharding(mesh, P("data", None, None, "model", None))
            if leaf.ndim == 0:
                # Lockstep counters carry no stream axis — replicate.
                return NamedSharding(mesh, P())
            spec = ("data",) + (None,) * (leaf.ndim - 1)
            return NamedSharding(mesh, P(*spec))

        return jax.tree_util.tree_map_with_path(spec_for, state_batched)

    def init_state(self, configs=None):
        """Batched, sharded initial state for all streams."""
        # Lockstep ring rows stay unbatched/replicated (Chain.state_axes).
        batched = self.chain.batch_state(
            self.chain.init_state(configs), self.n_streams
        )
        shardings = self._state_shardings(batched)
        return jax.device_put(batched, shardings), shardings

    def input_sharding(self):
        return NamedSharding(self.mesh, P("data", None, None))

    def batch_targets(self, per_stream_maps):
        """Per-stream parameter targets: build each stream's targets pytree
        from its {effect_id: {param: value}} map, stack to a leading S
        axis, and shard it over 'data' alongside the streams — divergent
        live params across the mesh (the pool's per-slot targets,
        server/pool.py:137-142, lifted to multi-chip)."""
        if len(per_stream_maps) != self.n_streams:
            raise ValueError(
                f"{len(per_stream_maps)} target maps for {self.n_streams} streams"
            )
        per = [self.chain.targets(m) for m in per_stream_maps]
        stacked = jax.tree.map(lambda *ls: jnp.stack(ls), *per)
        shard = NamedSharding(self.mesh, P("data"))
        return jax.device_put(stacked, jax.tree.map(lambda _: shard, stacked))

    # -- compiled step ---------------------------------------------------
    def step_fn(self, per_stream_targets: bool = False):
        """Jitted (state, targets, x:(S, ci, N)) ->
        (state, y:(S, co, N), peak) with GSPMD partitioning.  With
        ``per_stream_targets`` the targets pytree carries a leading
        stream axis (see batch_targets)."""
        key = bool(per_stream_targets)
        if self._step.get(key) is None:
            chain = self.chain

            def one_stream(state, targets, x):
                return chain.process_block(state, targets, x)

            state_axes = chain.state_axes()
            t_ax = 0 if key else None

            def step(state, targets, x):
                state, y = jax.vmap(
                    one_stream, in_axes=(state_axes, t_ax, 0),
                    out_axes=(state_axes, 0),
                )(state, targets, x)
                # Global clip meter: reduction over every stream on every
                # device — XLA lowers this to an all-reduce.
                peak = jnp.max(jnp.abs(y))
                return state, y, peak

            self._step[key] = jax.jit(step, donate_argnums=(0,))
        return self._step[key]

    def run_block(self, state, targets, x, per_stream_targets: bool = False):
        """x: (S, ci, N) host array."""
        # device_put straight from host memory: jnp.asarray first would
        # stage the WHOLE batch on device 0 and then reshard — double
        # transfer plus a device-0 HBM spike proportional to S.  An
        # already-device-resident array resharding is a pure d2d move.
        src = x if isinstance(x, jax.Array) else np.asarray(x, np.float32)
        x = jax.device_put(src, self.input_sharding())
        return self.step_fn(per_stream_targets)(state, targets, x)
