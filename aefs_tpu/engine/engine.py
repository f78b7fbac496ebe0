"""AudioEngine: session runtime (functional analogue of reference
engine.py:24-190).

Owns the current streaming chain (fs=48000, blocksize=256), the host-side
parameter-target map, the optional live mic stream, and whole-file
processing.  Differences from the reference, by design:

- The chain is a pure function + state pytree; "rebuild" swaps both
  atomically (engine.py:65's single-assignment swap becomes replacing the
  (chain, state, targets) triple under a lock).
- ``update_param`` only rewrites the host-side target map — the smoothed
  glide happens inside the jitted step (no locks on the audio path,
  engine.py:131-145 / core.py:64-77).
- File mode scans the chain over 4096-sample superblocks on-device in one
  dispatch (engine.py:101-102's whole-file-single-block quirk is
  deliberately replaced by blockwise semantics; SURVEY.md §7).
"""

from __future__ import annotations

import asyncio
import json
import queue
import threading

import numpy as np

from aefs_tpu.core.config import (
    SAMPLE_RATE,
    BLOCKSIZE,
    CHANNELS_IN,
    CHANNELS_OUT,
    FILE_SUPERBLOCK,
)
from aefs_tpu.core.chain import build_chain
from aefs_tpu.engine.wavio import decode_wav, encode_wav_int16

try:  # optional, absent on headless servers (engine.py:12-15)
    import sounddevice as sd
except (ImportError, OSError):
    sd = None


from aefs_tpu.core.fileopts import file_static_overrides as _file_static_overrides


def process_offline(chain_config, audio, fs, superblock=FILE_SUPERBLOCK,
                    extra_static=None):
    """Whole-file processing through a fresh chain (the file-mode core,
    engine.py:86-102): (frames, ch) float in -> (mono (frames,1),
    clipped stereo (frames, 2)) out.  ``extra_static`` merges on top of
    the derived file statics (e.g. a session's uploaded convreverb IR)."""
    import numpy as np

    if audio.ndim > 1:
        mono = audio.mean(axis=1, keepdims=True)
    else:
        mono = audio.reshape(-1, 1)
    mono = mono.astype(np.float32)

    static = _file_static_overrides(chain_config)
    for eid, extra in (extra_static or {}).items():
        static[eid] = {**static.get(eid, {}), **extra}
    chain, state, targets_map = build_chain(
        chain_config,
        fs,
        superblock,
        channels_in=1,
        channels_out=2,
        static_overrides=static,
    )
    _, out = chain.process_array(state, chain.targets(targets_map), mono, fast=True)
    chain.release()  # one-shot chain: break the jit-cache cycle (gc is off)
    return mono, np.clip(out, -1.0, 1.0)


def render_batch(chain_config, audios, fs, superblock=FILE_SUPERBLOCK,
                 shard: bool = False):
    """Batched offline rendering: many files through the same chain
    topology in ONE device dispatch — the vmapped whole-file fast path
    with a fresh state per file (the file-mode contract, engine.py:86-99,
    per batch element).

    The reference renders files one at a time on the CPU (engine.py:
    67-129); on the device the batch axis is nearly free (one launch per
    kernel serves every file), so bulk jobs should ship B files per
    dispatch.  ``shard=True`` additionally
    distributes the batch over every visible device (GSPMD data
    parallelism, same axis the pool server shards).

    audios: list of (frames_i,) or (frames_i, ch) arrays, one sample
    rate.  Returns a list of (frames_i, 2) float32 clipped outputs.
    """
    import jax
    import jax.numpy as jnp

    monos = []
    for a in audios:
        a = np.asarray(a, np.float32)
        monos.append(a.mean(axis=1) if a.ndim > 1 else a)
    n_real = len(monos)
    if shard:
        # Any file count shards: pad the batch with silent entries up to
        # a multiple of the device count (their outputs are dropped).
        n_dev = len(jax.devices())
        for _ in range((-n_real) % n_dev):
            monos.append(np.zeros((superblock,), np.float32))
    b = len(monos)
    length = max(m.shape[0] for m in monos)
    lp = -(-length // superblock) * superblock
    x = np.zeros((b, 1, lp), np.float32)
    for i, m in enumerate(monos):
        x[i, 0, : m.shape[0]] = m

    chain, one_state, targets_map = build_chain(
        chain_config, fs, superblock, channels_in=1, channels_out=2,
        static_overrides=_file_static_overrides(chain_config),
    )
    targets = chain.targets(targets_map)
    # The canonical batcher (NOT a bare broadcast_to tree-map): lockstep
    # ring-row counters stay unbatched, so any effect whose process_file
    # falls back to the blockwise step (delay without file statics) keeps
    # batch-uniform slice starts — per-batch starts are the documented
    # ~12x DUS cliff (CLAUDE.md).
    state = chain.batch_state(one_state, b)
    state_axes = chain.state_axes()
    xd = jnp.asarray(x)

    def render(st, tg, xx):
        return jax.vmap(
            chain.process_whole, in_axes=(state_axes, None, 0),
            out_axes=(state_axes, 0),
        )(st, tg, xx)[1]

    if shard and len(jax.devices()) > 1:
        # Data parallel: each device renders its slice of the batch
        # (shard_map, so the comb kernel runs on local files only);
        # lockstep scalars (state axis None) replicate.
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

        mesh = Mesh(np.asarray(jax.devices()), axis_names=("data",))
        specs = jax.tree.map(
            lambda ax: P() if ax is None else P("data"), state_axes,
            is_leaf=lambda ax: ax is None,
        )
        state = jax.device_put(
            state, jax.tree.map(lambda sp: NamedSharding(mesh, sp), specs)
        )
        xd = jax.device_put(xd, NamedSharding(mesh, P("data")))
        # check_vma off: the comb kernel's pallas_call declares plain
        # output shapes, with no per-axis variance for the checker.
        render = jax.shard_map(render, mesh=mesh,
                               in_specs=(specs, P(), P("data")),
                               out_specs=P("data"), check_vma=False)

    y = jax.jit(render)(state, targets, xd)
    chain.release()  # one-shot chain: break the jit-cache cycle (gc is off)
    out = np.clip(np.asarray(y), -1.0, 1.0)  # (B, 2, Lp)
    return [
        out[i, :, : m.shape[0]].T.copy()
        for i, m in enumerate(monos[:n_real])
    ]


class AudioEngine:
    def __init__(self, data_queues=None):
        from aefs_tpu.utils.platform import enable_compile_cache

        enable_compile_cache()
        self.data_queues = data_queues or {
            "input": queue.Queue(maxsize=200),
            "output": queue.Queue(maxsize=200),
        }
        self.current_sample_rate = SAMPLE_RATE
        self.is_running = False
        self.is_processing_file = False
        self.status_count = 0
        self.stream = None
        self.chain = None  # set by the build_chain([]) below
        self.last_chain_config = []
        self.last_file_contents = None
        # User-selected (input, output) PortAudio device indices; None
        # means OS default.  Applied at the next stream start (reference
        # wishlist todo:2; pick_devices/list_devices in engine/devices.py).
        self.devices = (None, None)
        # Live file stream (start_file_stream): lossless processed-block
        # queue for client playback + its source thread.
        self.playback_queue = None
        self._file_thread = None
        self._file_stream_stop = None
        self._lock = threading.Lock()
        # Serializes device-op ENQUEUE between the audio path (whose step
        # donates the packed state buffers) and state readers
        # (save_session): on one device stream, ops execute in enqueue
        # order, so a reader that enqueues its slices under this lock can
        # never observe buffers a later-enqueued step has donated.
        # Enqueue is asynchronous (microseconds), so the audio path only
        # ever waits for another enqueue, never for device compute.
        self._dispatch_lock = threading.Lock()
        self._param_lock = threading.Lock()  # serializes update_param writers
        # Serializes plot-tap producers: the SPSC rings assume ONE
        # producer, but the mic callback and the file-stream thread may
        # both call process_stream_block concurrently (documented hot-path
        # concurrency) — without this, two producers can tear a ring slot
        # and desynchronize the input/output pair forever.
        self._tap_lock = threading.Lock()
        self._targets_map = {}
        self._pending = None  # depth-1 pipeline: (chain, y, in-flight block)
        # Uploaded convreverb IRs: {effect_id: ((ch, n) float32, ir_fs)}.
        # Ride session checkpoints; stale ids are pruned when the chain no
        # longer contains them.
        self.custom_irs = {}
        # Learned spectral noise profiles: {effect_id: (bins,) float32}
        # (learn_noise).  Same lifetime/pruning rules as custom_irs.
        self.noise_profiles = {}
        # Live noise capture in flight: {"need": blocks, "blocks": [...],
        # "done": Event} — _tap_plots appends input blocks while set.
        self._noise_capture = None
        from aefs_tpu.utils.metrics import BlockTimer

        self.metrics = BlockTimer(self.current_sample_rate, BLOCKSIZE)
        self.build_chain([])

    # -- chain lifecycle (engine.py:38-65) ------------------------------
    def _warm_runner(self, chain, state, targets):
        """Pack state/targets for dispatch (core/packing.py: one buffer per
        dtype instead of ~50 leaf buffers — per-argument marshaling
        dominates block dispatch) and compile + run two dummy blocks off
        the audio path (core.py:131-136).  Returns (runner, packed fresh
        state, packed targets)."""
        import jax
        import jax.numpy as jnp

        runner = chain.packed_step()
        sgroups = runner.pack_state(state)
        tgroups = runner.pack_targets(targets)
        dummy = jnp.zeros((CHANNELS_IN, BLOCKSIZE), jnp.float32)
        warm = sgroups
        for _ in range(2):
            warm, yw = runner(warm, tgroups, dummy)
        # Wait on the audio output: an empty chain has no state buffers.
        jax.block_until_ready(yw)
        # The dummy run is discarded (and the step donated its input):
        # re-pack the caller's state.
        return runner, runner.pack_state(state), tgroups

    def _ir_overrides(self, effects_config, fs):
        """Static-override map carrying uploaded IRs and learned noise
        profiles into a chain build (IRs resampled to the build rate if
        the WAV's rate differs); prunes entries whose effect left the
        chain."""
        from aefs_tpu.engine.checkpoint import (
            ir_static_overrides, profile_static_overrides,
        )

        ids = {c.get("effect_id") for c in effects_config}
        self.custom_irs = {k: v for k, v in self.custom_irs.items() if k in ids}
        self.noise_profiles = {
            k: v for k, v in self.noise_profiles.items() if k in ids
        }
        out = ir_static_overrides(self.custom_irs, effects_config, fs)
        for eid, extra in profile_static_overrides(
            self.noise_profiles, effects_config
        ).items():
            out.setdefault(eid, {}).update(extra)
        return out

    def set_ir(self, effect_id: str, contents: str) -> float:
        """Install a user-uploaded IR WAV (base64 data URL, the same
        encoding as process_file) on a convreverb in the current chain and
        rebuild so it takes effect.  Returns the IR length in seconds.
        Reference analogue: the file-upload path (app.py:668-689) applied
        to the effect's topology instead of the program input."""
        from aefs_tpu import native

        kinds = {
            c.get("effect_id"): c.get("type") for c in self.last_chain_config
        }
        if kinds.get(effect_id) != "convreverb":
            raise ValueError(
                f"effect ID '{effect_id}' is not a convreverb in the "
                "current chain"
            )
        _, content_string = contents.split(",")
        audio, fs_ir = decode_wav(native.b64decode(content_string))
        ir = audio.T if audio.ndim > 1 else audio[None, :]
        self.custom_irs[effect_id] = (np.asarray(ir, np.float32), int(fs_ir))
        self.build_chain(self.last_chain_config)
        return ir.shape[-1] / float(fs_ir)

    def learn_noise(self, effect_id: str, contents: str = None,
                    seconds: float = 2.0) -> float:
        """Learn a per-bin noise profile for a spectral filter in the
        current chain and rebuild so the gate thresholds per bin
        (models/spectral.py module docstring).  Two sources:

        - ``contents``: a noise-only WAV (base64 data URL, same encoding
          as process_file / set_ir) — e.g. a recorded room-tone file;
        - live capture (``contents is None``): the next ``seconds`` of
          streaming INPUT audio (mic or file stream) — "be quiet and
          press learn".  Requires an active stream; blocks the calling
          (executor) thread until the capture completes.

        Returns the measured mean noise floor in dBFS.  No reference
        counterpart — the reference gates every bin against one global
        threshold (spectral.py:68)."""
        from aefs_tpu import native
        from aefs_tpu.models.spectral import measure_noise_profile

        kinds = {
            c.get("effect_id"): c.get("type") for c in self.last_chain_config
        }
        if kinds.get(effect_id) != "spectral":
            raise ValueError(
                f"effect ID '{effect_id}' is not a spectral filter in the "
                "current chain"
            )
        if contents is not None:
            _, content_string = contents.split(",")
            audio, fs_wav = decode_wav(native.b64decode(content_string))
            mono = audio.mean(axis=1) if audio.ndim > 1 else audio
            if int(fs_wav) != int(self.current_sample_rate):
                # Profile bins are indexed against the ENGINE rate (hop is
                # pinned to BLOCKSIZE at current_sample_rate): an off-rate
                # WAV analyzed raw would map every per-bin threshold to the
                # wrong frequency.  Resample like set_ir does for IRs.
                from aefs_tpu.engine.wavio import resample_bandlimited

                n_out = max(
                    8,
                    int(round(len(mono) * self.current_sample_rate / fs_wav)),
                )
                mono = resample_bandlimited(mono, n_out)
        else:
            need = max(1, int(round(float(seconds) * self.current_sample_rate
                                    / BLOCKSIZE)))
            cap = {"need": need, "blocks": [], "done": threading.Event()}
            with self._lock:
                # One live capture at a time: a second concurrent call
                # overwriting the slot would steal this call's blocks and
                # its ``finally`` would clear OUR capture mid-flight.
                if self._noise_capture is not None:
                    raise ValueError(
                        "a noise capture is already in progress"
                    )
                self._noise_capture = cap
            try:
                # The stream may start (or stop) while we wait; bound the
                # wait by the capture length plus a grace period.
                if not cap["done"].wait(timeout=float(seconds) + 10.0):
                    raise ValueError(
                        "no streaming audio to learn from — start the mic "
                        "or a file stream, or upload a noise WAV"
                    )
            finally:
                with self._lock:
                    if self._noise_capture is cap:
                        self._noise_capture = None
            mono = np.concatenate(cap["blocks"])
        profile = measure_noise_profile(mono, hop=BLOCKSIZE)
        self.noise_profiles[effect_id] = profile
        self.build_chain(self.last_chain_config)
        floor = max(float(profile.mean()), 1e-10)
        # Mean |rfft| of a Hann frame scales with n_fft/4; normalize to a
        # rough dBFS figure for the UI status line.
        return 20.0 * float(np.log10(floor / (2 * BLOCKSIZE / 4)))

    def build_chain(self, effects_config):
        chain, state, targets_map = build_chain(
            effects_config,
            self.current_sample_rate,
            BLOCKSIZE,
            channels_in=CHANNELS_IN,
            channels_out=CHANNELS_OUT,
            static_overrides=self._ir_overrides(
                effects_config, self.current_sample_rate
            ),
        )
        targets = chain.targets(targets_map)
        runner, sgroups, tgroups = self._warm_runner(chain, state, targets)
        with self._lock:
            old = self.chain
            self.chain = chain
            # Swapped together with the chain so readers holding _lock
            # always see a (chain, config) pair that belongs together —
            # update_param's guarded config sync below depends on this
            # (a failed build also leaves BOTH pointing at the old,
            # still-running chain instead of a config that never built).
            self.last_chain_config = effects_config
            self._runner = runner
            self.chain_state = sgroups  # packed groups (runner.unpack_state)
            self._targets_map = targets_map
            self._targets = tgroups
            self._pending = None  # an in-flight block belongs to the old chain
        if old is not None and old is not chain:
            # gc is disabled in the serving process: break the superseded
            # chain's jit-cache cycle or it (and its compiled executables)
            # leaks on every rebuild (Chain.release).  A racing holder of
            # ``old`` stays correct — its cache re-jits on next use.
            old.release()

    def update_param(self, effect_id: str, param_name: str, value: float):
        """Route a live parameter change (engine.py:131-145): rewrite the
        target; the audio path glides toward it one clamped step per block.

        ``_param_lock`` serializes concurrent WRITERS for the whole
        copy-pack-swap: two unserialized writers would each pack a full
        map copied before the other's swap, and the loser's parameter
        would silently revert (lost update).  Control-plane-only — the
        audio path never takes this lock."""
        with self._param_lock:
            self._update_param_locked(effect_id, param_name, value)

    def _sync_config_param_held(self, effect_id, param_name, value):
        """Write a validated live param into last_chain_config — caller
        HOLDS self._lock.  Parallel-branch params arrive here in their
        lifted b<branch>_<index>_<name> form on the CONTAINER's effect_id
        (models/parallel_chain.py:53-61), which initial_params re-merges
        on rebuild — so a top-level id match covers branches too."""
        for cfg in self.last_chain_config:
            if cfg.get("effect_id") == effect_id:
                cfg.setdefault("params", {})[param_name] = value
                return

    def _update_param_locked(self, effect_id, param_name, value):
        with self._lock:
            chain = self.chain
            targets_map = {k: dict(v) for k, v in self._targets_map.items()}
        models = dict(chain.effects)
        if effect_id not in models:
            print(f"Error: effect ID '{effect_id}' not found")
            return
        if param_name not in models[effect_id].PARAMS:
            print(
                f"Warning: parameter '{param_name}' in effect "
                f"'{effect_id}' could not be updated"
            )
            return
        targets_map.setdefault(effect_id, {})[param_name] = float(value)
        # Building + packing the targets creates device buffers (host->
        # device RPCs on remote backends) — do it OUTSIDE the lock the
        # audio callback takes every block, then swap atomically.  Pack
        # with the runner cached on the chain we captured, NOT whatever
        # self._runner currently holds: a concurrent build_chain may have
        # swapped in a different topology whose packer would reject (or
        # silently misread) this chain's targets pytree.
        tgroups = chain.packed_step().pack_targets(chain.targets(targets_map))
        with self._lock:
            if self.chain is chain:
                self._targets_map = targets_map
                self._targets = tgroups
                # Keep the CONFIG in sync too, under the SAME guard: file
                # mode builds a fresh chain from last_chain_config
                # (targets AND baked statics like the delay's file lag),
                # so a live update that only touched the streaming targets
                # would silently revert when the user (re)processes a file
                # — the reference's file path always sees current params
                # (core.py:123-129 reads the live SmoothParams).  Guarded:
                # build_chain swaps (chain, last_chain_config) atomically,
                # so an update racing a rebuild either lands on the chain
                # it validated against or is dropped whole — never written
                # into the NEW topology's config after losing the targets
                # swap (a config⇄targets split), and never onto the
                # orphaned old list (a lost update on the next file
                # render).
                # Clamp through the ParamSpec before persisting: the
                # streaming targets are clamped on pack, so an out-of-range
                # literal written raw here could diverge from what the live
                # path actually applies if a future build-from-config path
                # ever skipped clamping (ADVICE r4).
                self._sync_config_param_held(
                    effect_id, param_name,
                    float(models[effect_id].PARAMS[param_name].clamp(
                        float(value))),
                )

    # -- session checkpoint/resume (engine/checkpoint.py) ----------------
    def save_session(self, path: str) -> str:
        """Checkpoint the live session (chain config, parameter targets,
        full audio-state pytree) to a directory; returns the path."""
        from aefs_tpu.engine.checkpoint import save_session

        # Snapshot AND enqueue the unpack under the dispatch lock: the
        # audio step donates the packed state buffers, so the unpack's
        # slices must be enqueued before any later step donates them.
        with self._dispatch_lock:
            with self._lock:
                chain, runner, sgroups, tmap = (
                    self.chain, self._runner, self.chain_state,
                    self._targets_map,
                )
                irs = dict(self.custom_irs)
                profiles = dict(self.noise_profiles)
                fs = self.current_sample_rate
            state = runner.unpack_state(sgroups)
        # Config from the SNAPSHOTTED chain, not last_chain_config: a
        # concurrent build_chain updates the latter before its (seconds-
        # long) compile finishes, and a checkpoint pairing the new config
        # with this chain's state would be unloadable (leaf mismatch —
        # caught by the randomized concurrency hammer).  Uploaded IRs
        # ride along: the state's spec_hist leaves are shaped by them,
        # so a resume (even in-process) must rebuild with the same IR.
        save_session(path, chain.source_config, tmap, state, custom_irs=irs,
                     noise_profiles=profiles, fs=fs)
        return path

    def resume_session(self, path: str):
        """Rebuild the chain from a checkpoint and graft the saved audio
        state onto it — ring buffers, filter taps and phasors continue
        bit-exact.  Returns the restored chain config (for UI sync)."""
        from aefs_tpu.engine.checkpoint import load_session, remap_profiles

        (chain_config, targets_map, rebuild_state, irs,
         profiles, ck_meta) = load_session(path)
        # Profile bins are fs-dependent; a checkpoint saved at another
        # rate must re-bin them onto this engine's analysis grid (the
        # state leaves themselves are fs-shaped and fail the rebuild
        # shape check on mismatch, but profiles are shape-neutral and
        # would silently gate the wrong frequencies).
        profiles = remap_profiles(profiles, ck_meta.get("fs"),
                                  self.current_sample_rate)
        # Restore the session's uploaded IRs BEFORE rebuilding: the saved
        # state's spec_hist leaves are shaped by the custom IR's length,
        # so a rebuild on the synthetic IR could never accept them.
        # Noise profiles likewise (behavioral, not shape-bearing).  For
        # every effect id the checkpoint's config names, the checkpoint is
        # the SOLE source of truth: an IR/profile learned in-process for
        # that id but absent from the checkpoint must NOT survive the
        # resume, or the restored chain would gate/convolve with data the
        # saved session never had (breaking bit-exact resume).
        ids = {c.get("effect_id") for c in chain_config}
        self.custom_irs = {
            k: v for k, v in self.custom_irs.items() if k not in ids
        }
        self.noise_profiles = {
            k: v for k, v in self.noise_profiles.items() if k not in ids
        }
        self.custom_irs.update(irs)
        self.noise_profiles.update(profiles)
        chain, state, _ = build_chain(
            chain_config,
            self.current_sample_rate,
            BLOCKSIZE,
            channels_in=CHANNELS_IN,
            channels_out=CHANNELS_OUT,
            static_overrides=self._ir_overrides(
                chain_config, self.current_sample_rate
            ),
        )
        targets = chain.targets(targets_map)
        state = rebuild_state(chain.init_state())
        runner, sgroups, tgroups = self._warm_runner(chain, state, targets)
        with self._lock:
            old = self.chain
            self.chain = chain
            self.last_chain_config = chain_config  # atomic with the chain
            self._runner = runner
            self.chain_state = sgroups
            self._targets_map = targets_map
            self._targets = tgroups
            self._pending = None
        if old is not None and old is not chain:
            old.release()  # same leak rationale as build_chain
        return chain_config

    # -- block streaming ------------------------------------------------
    def process_stream_block(self, in_block: np.ndarray) -> np.ndarray:
        """One hot-path block: (N, ci) float32 in -> (N, co) float32 out.

        Feeds the plot queues exactly like the reference's PlotDataTap
        chain heads/tails (core.py:89-106): input tap sees the fanned
        block, output tap the processed one; both drop on full."""
        import jax.numpy as jnp

        with self.metrics.block():
            x = jnp.asarray(in_block.T)
            with self._dispatch_lock:  # enqueue only — returns immediately
                # Read the state INSIDE the dispatch lock: two concurrent
                # callers (e.g. mic callback + file-stream thread) must
                # never dispatch the same packed groups — the step donates
                # them, and the second dispatch would read deleted buffers.
                with self._lock:
                    chain, runner = self.chain, self._runner
                    state, targets = self.chain_state, self._targets
                state, y = runner(state, targets, x)
                # Publish the post-step state BEFORE releasing the dispatch
                # lock: the step just donated the previous packed groups, so
                # a save_session that wins the lock next must see the new
                # groups, never the donated ones.  (Chain may have been
                # swapped mid-block; matching the reference's benign race,
                # the old block's state is dropped.)
                with self._lock:
                    if self.chain is chain:
                        self.chain_state = state
            out = np.asarray(y).T
        self._tap_plots(in_block, out)
        return out

    def _tap_plots(self, in_block, out):
        """Feed the plot queues as a PAIR: drop both blocks or neither.
        Independent drop-on-full could desynchronize the two rings by one
        block FOREVER (the sender drains between the two puts exactly as
        the rings are full: the input put then lands while the output put
        drops) — and the server's pair-drain assumes equal depths.  The
        full() check is conservative-exact only from a SINGLE producer,
        and the rings themselves are SPSC — but the mic callback and the
        file-stream thread may overlap on the hot path, so ``_tap_lock``
        serializes producers here (drains stay lock-free on the consumer
        side)."""
        cap = self._noise_capture
        if cap is not None and not cap["done"].is_set():
            # learn_noise live capture: collect mono INPUT blocks host-side
            # (a list append + small mean — no device work, no locks).
            cap["blocks"].append(
                np.asarray(in_block, np.float32).mean(axis=1))
            if len(cap["blocks"]) >= cap["need"]:
                cap["done"].set()
        fanned = (np.repeat(in_block, 2, axis=1)
                  if in_block.shape[1] == 1 else in_block)
        qin, qout = self.data_queues["input"], self.data_queues["output"]
        with self._tap_lock:
            try:
                if not (qin.full() or qout.full()):
                    qin.put_nowait(fanned.copy())
                    qout.put_nowait(out.copy())
            except queue.Full:  # ragged test blocks (BlockQueue shape guard)
                pass

    def process_stream_block_pipelined(self, in_block: np.ndarray) -> np.ndarray:
        """Depth-1 pipelined hot path: dispatch block k, return block k-1's
        processed audio (one block of added latency, 5.33 ms @ 48 kHz).

        The synchronous path pays a full dispatch+readback round trip per
        block; here the device computes block k while the host reads back
        block k-1, so the per-block wall time approaches max(transfer,
        compute) instead of their sum — the device-serving analogue of the
        reference's primed output buffers (engine.py:172-173), which
        likewise ship one block late to decouple capture from playback.
        """
        import jax.numpy as jnp

        with self.metrics.block():
            x = jnp.asarray(in_block.T)
            with self._dispatch_lock:  # enqueue only — returns immediately
                # Same read-inside-dispatch + publish-before-release
                # contract as the synchronous path: concurrent callers must
                # not double-donate, and save_session must never find
                # chain_state pointing at groups this step just donated.
                with self._lock:
                    chain, runner = self.chain, self._runner
                    state, targets = self.chain_state, self._targets
                state, y = runner(state, targets, x)
                with self._lock:
                    pending, self._pending = self._pending, (chain, y)
                    if self.chain is chain:
                        self.chain_state = state
            if pending is not None and pending[0] is chain:
                out = np.asarray(pending[1]).T
            else:  # pipeline priming / chain swap: one silent block
                out = np.zeros((in_block.shape[0], CHANNELS_OUT), np.float32)
        self._tap_plots(in_block, out)
        return out

    # -- mic stream (engine.py:147-190) ---------------------------------
    def start_mic_stream(self):
        if self.is_running:
            print("Warning: stream is already running")
            return
        if sd is None:
            print("Server Mode: Microphone hardware not available. Stream ignored.")
            return

        import os

        step = (
            self.process_stream_block
            if os.environ.get("AEFS_STREAM_PIPELINE", "1") == "0"
            else self.process_stream_block_pipelined
        )

        def callback(indata, outdata, frames, t, status):
            if status:
                self.status_count += 1
            outdata[:] = step(np.asarray(indata, np.float32))

        try:
            kwargs = {}
            if self.devices != (None, None):
                kwargs["device"] = self.devices
            self.stream = sd.Stream(
                samplerate=self.current_sample_rate,
                blocksize=BLOCKSIZE,
                dtype="float32",
                latency="low",
                channels=(CHANNELS_IN, CHANNELS_OUT),
                callback=callback,
                prime_output_buffers_using_stream_callback=True,
                **kwargs,
            )
            self.stream.start()
            self.is_running = True
            actual = int(self.stream.samplerate)
            if actual != self.current_sample_rate:
                # Sample-rate renegotiation (engine.py:177-181): the chain,
                # and the deadline the metrics judge xruns against, both
                # depend on the rate.
                from aefs_tpu.utils.metrics import BlockTimer

                self.current_sample_rate = actual
                self.metrics = BlockTimer(actual, BLOCKSIZE)
                print(f"Rebuilding effects chain for {actual} Hz...")
                self.build_chain(self.last_chain_config)
        except Exception as e:
            print(f"Error on stream start: {e}")

    # -- live file stream (reference wishlist todo:4, preferred design:
    #    "MEJOR hacer streaming con el file para que el backend aplique
    #    los efectos en vivo") -------------------------------------------
    def start_file_stream(self, contents: str = None, realtime: bool = True):
        """Stream a WAV through the LIVE hot path: the file replaces the
        microphone as the block source, so parameter changes are applied
        in real time while it plays — the reference wishlist's preferred
        design for re-applying effects (todo:4), which its offline
        process_file path could not do.

        Processed blocks go to ``self.playback_queue`` (lossless, unlike
        the drop-on-full plot queues) as ``(seq, (N, 2) float32)`` pairs,
        terminated by ``None``; the serving layer ships them to the client
        for Web Audio playback.  ``realtime=True`` paces dispatch at the
        block cadence so knob turns land where the listener hears them;
        ``False`` runs flat-out (tests, faster-than-realtime export).
        Returns True iff a stream actually started (False: already
        running / no upload) — the serving layer must not attach a
        playback pump otherwise.
        """
        if self.is_running:
            print("Warning: stream is already running")
            return False
        contents = contents or self.last_file_contents
        if not contents:
            print("Warning: no file uploaded yet; nothing to stream")
            return False
        self.last_file_contents = contents

        from aefs_tpu import native

        _, content_string = contents.split(",")
        audio, fs = decode_wav(native.b64decode(content_string))
        if audio.ndim > 1:  # same downmix as file mode (process_offline)
            mono = audio.mean(axis=1, keepdims=True).astype(np.float32)
        else:
            mono = audio.reshape(-1, 1).astype(np.float32)

        if fs != self.current_sample_rate:
            # Sample-rate renegotiation, exactly like the mic path: the
            # chain and the xrun deadline both depend on the rate.
            from aefs_tpu.utils.metrics import BlockTimer

            self.current_sample_rate = int(fs)
            self.metrics = BlockTimer(int(fs), BLOCKSIZE)
            print(f"Rebuilding effects chain for {fs} Hz...")
            self.build_chain(self.last_chain_config)

        n = mono.shape[0]
        pad = (-n) % BLOCKSIZE
        if pad:
            mono = np.concatenate([mono, np.zeros((pad, 1), np.float32)])
        # The thread writes to ITS OWN queue (captured, not self.*): two
        # racing starts would otherwise cross-post into whichever queue
        # the attribute last pointed at.
        pq = self.playback_queue = queue.Queue()
        stop = threading.Event()
        period = BLOCKSIZE / float(fs)

        def run():
            import time

            try:
                next_t = time.monotonic()
                for seq in range(mono.shape[0] // BLOCKSIZE):
                    if stop.is_set():
                        break
                    blk = mono[seq * BLOCKSIZE:(seq + 1) * BLOCKSIZE]
                    out = self.process_stream_block(blk)
                    if seq == mono.shape[0] // BLOCKSIZE - 1 and pad:
                        out = out[: BLOCKSIZE - pad]  # trim tail padding
                    pq.put((seq, out))
                    if realtime:
                        next_t += period
                        delay = next_t - time.monotonic()
                        if delay > 0:
                            time.sleep(delay)
                        else:  # fell behind: don't burst
                            next_t = time.monotonic()
            except Exception as e:  # chain swap races re-raise here only
                print(f"Error in file stream: {e}")
            finally:
                pq.put(None)
                # Natural end only: when stop_stream initiated the stop,
                # IT owns the flag — a stale thread unblocking minutes
                # after a timed-out join (wedged dispatch) must not
                # clobber a mic/file stream the user started since.
                if not stop.is_set():
                    self.is_running = False

        # Start BEFORE publishing: a concurrent stop_stream that sees the
        # thread joins it, and joining a not-yet-started thread raises.
        # The thread and ITS stop event are published together under the
        # lock, so a stop never sets one stream's event while joining
        # another's thread.  A stop landing before the publish sees the
        # previous pair (None / a finished thread) and the start wins.
        t = threading.Thread(target=run, daemon=True)
        self.is_running = True
        t.start()
        with self._lock:
            self._file_thread, self._file_stream_stop = t, stop
        return True

    def set_devices(self, in_index, out_index):
        """Select the (input, output) device pair for the NEXT stream
        start; a running MIC stream is restarted so the change applies.
        A live FILE stream is left alone — device indices only bind at
        mic-stream open, and restarting here would silently replace the
        user's file playback with a microphone source."""
        self.devices = (
            int(in_index) if in_index is not None else None,
            int(out_index) if out_index is not None else None,
        )
        if self.is_running and self.stream is not None:
            self.stop_stream()
            self.start_mic_stream()

    def stop_stream(self):
        if self.stream:
            self.stream.stop()
            self.stream.close()
            self.stream = None
            self.is_running = False
        with self._lock:
            t, stop = self._file_thread, self._file_stream_stop
            self._file_thread = None
        if t is not None:
            stop.set()
            if t is not threading.current_thread():
                t.join(timeout=30)
            # The stopping side owns the flag (the thread skips it once
            # the stop event is set — see start_file_stream's finally).
            self.is_running = False
        with self._lock:
            self._pending = None

    def close(self):
        """End-of-session teardown: stop the stream and break the live
        chain's jit-cache cycle so the engine frees by refcounting alone —
        the server disables gc, and without this every client
        connect/disconnect leaked the session's final chain and its
        compiled executables (Chain.release rationale)."""
        self.stop_stream()
        with self._lock:
            chain, self.chain, self._runner = self.chain, None, None
        if chain is not None:
            chain.release()

    # -- file mode (engine.py:67-129) -----------------------------------
    def process_file_array(self, audio: np.ndarray, fs: int):
        """(frames, ch) float32 -> (frames, 2) float32 through a fresh
        chain built from the last config at the file's sample rate."""
        return process_offline(
            self.last_chain_config, audio, fs,
            extra_static=self._ir_overrides(self.last_chain_config, fs),
        )

    async def process_wav_file(self, contents: str, websocket):
        if self.is_processing_file:
            print("Warning. A file is already being process. Ignoring new request")
            return
        self.is_processing_file = True
        # Kept for the reprocess_file command (reference wishlist todo:5:
        # "re-apply effects to the file" without re-uploading).
        self.last_file_contents = contents
        try:
            print("Info: Processing WAV")
            from aefs_tpu import native

            _, content_string = contents.split(",")
            decoded = native.b64decode(content_string)
            audio, fs = decode_wav(decoded)

            loop = asyncio.get_running_loop()
            mono, processed = await loop.run_in_executor(
                None, self.process_file_array, audio, fs
            )

            def serialize():
                import os

                wav_bytes = encode_wav_int16(processed, fs)
                b64 = native.b64encode(wav_bytes).decode("ascii")
                head_dict = {
                    "type": "file_processed",
                    "original_b64": contents,
                    "processed_b64": f"data:audio/wav;base64,{b64}",
                    "sample_rate": int(fs),
                }
                if os.environ.get("AEFS_SERVER_ANALYSIS", "1") == "1":
                    # Windowed spectrum/chroma for playback scrubbing
                    # (reference 02_custom.js:282-355 recomputes per frame
                    # browser-side; we ship on-device STFT windows instead).
                    try:
                        from aefs_tpu.utils.analysis import PlotAnalyzer

                        head_dict["analysis"] = PlotAnalyzer(fs).analyze_file(
                            mono[:, 0], processed.mean(axis=1)
                        )
                    except Exception as e:
                        print(f"Warning: file analysis unavailable: {e}")
                head = json.dumps(head_dict)
                return (
                    head[:-1]
                    + ',"original_samples":' + native.json_f32_array(mono.flatten())
                    + ',"processed_samples":' + native.json_f32_array(processed.mean(axis=1))
                    + "}"
                )

            await websocket.send(await loop.run_in_executor(None, serialize))
        except Exception as e:
            print(f"Error processing WAV file: {e}")
        finally:
            print("Success: Finished processing WAV file")
            self.is_processing_file = False
