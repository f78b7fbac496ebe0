"""Functional effect protocol.

The reference models an effect as a mutable object with
``prepare(sr, ci, co, blocksize)`` / ``process_into(x, out)``
(core.py:81-86).  Functional form: an ``EffectModel`` instance holds only
*static* topology (buffer lengths, lags, window tables — everything that
shapes the compiled program), while all mutable audio state lives in an
explicit pytree threaded through ``process``:

    state = model.init_state()
    state, y = model.process(state, params, x)      # x, y: (2, N) float32

``params`` is a dict of traced scalars — the *smoothed current* values,
advanced once per block by the chain (see core/params.py).  The same model
object is reusable across jit traces; a new blocksize or sample rate is a
new trace, mirroring the reference's re-``prepare`` (core.py:123-129).
"""

from __future__ import annotations

from aefs_tpu.core.params import ParamSpec, init_params


class EffectModel:
    kind: str = ""
    PARAMS: dict[str, ParamSpec] = {}
    # Top-level state keys that are pure per-block counters: they advance
    # identically in every stream whenever all streams step together
    # (serving pools dispatch every slot every block), independent of
    # params or audio.  Batched steppers map them to vmap axis None
    # (Chain.state_axes) so index ops on them stay batch-uniform — a
    # per-stream ring-row index lowers to a per-stream sequential loop
    # (CLAUDE.md; ops/ringbuf.py:rowring_write).
    LOCKSTEP_STATE: tuple = ()

    def __init__(self, fs: int, blocksize: int, channels: int = 2, **config):
        self.fs = int(fs)
        self.blocksize = int(blocksize)
        self.channels = int(channels)
        self.config = dict(config)

    # -- static helpers -------------------------------------------------
    @classmethod
    def split_config(cls, config: dict):
        """Split a chain-config params dict into (live targets, static)."""
        live = {k: v for k, v in config.items() if k in cls.PARAMS}
        static = {k: v for k, v in config.items() if k not in cls.PARAMS}
        return live, static

    def initial_params(self, config: dict) -> dict:
        return init_params(self.PARAMS, config)

    def map_state(self, f_batched, f_lockstep, st, *rest):
        """Map leaves of a state pytree (plus parallel trees in ``rest``):
        ``f_lockstep`` on LOCKSTEP_STATE keys, ``f_batched`` elsewhere.
        Containers (parallel/multiband) override to RECURSE into their
        nested models, so e.g. a delay's ring-row counter stays lockstep
        one nesting level down too."""
        import jax

        return {
            k: jax.tree.map(
                f_lockstep if k in self.LOCKSTEP_STATE else f_batched,
                v, *(r[k] for r in rest),
            )
            for k, v in st.items()
        }

    def state_axes_tree(self, batch_axis: int = 0):
        """Per-leaf vmap axis tree matching ``init_state``'s structure:
        ``batch_axis`` everywhere except LOCKSTEP_STATE leaves (None).
        None is a valid vmap axis-spec leaf; do NOT jax.tree.map over the
        result (None reads as an empty subtree there)."""
        return self.map_state(
            lambda _: batch_axis, lambda _: None, self.init_state())

    # -- to implement ---------------------------------------------------
    def init_state(self):
        """Return the effect's state pytree (all-zero history)."""
        return {}

    def process(self, state, p, x):
        """Pure block transform: (state, params, (C, N)) -> (state, (C, N))."""
        raise NotImplementedError

    def process_file(self, state, p, x):
        """Whole-signal transform for the file-mode fast path: one call over
        the entire (padded) signal with constant params and fresh state.

        The default delegates to ``process`` — valid for every effect whose
        block algorithm is N-agnostic (gate/filter/spectral/waveshaper/
        convreverb/octaver).  Effects whose blockwise solver cost scales
        with N/lag (delay fixed point, reverb comb bank) override this with
        a closed-form whole-file algorithm."""
        return self.process(state, p, x)
