"""Dispatch-argument packing: one device buffer per dtype, not per leaf.

Every jitted dispatch marshals each argument buffer individually through
the runtime: a chain state pytree has ~50 leaves, and a per-buffer
dispatch cost is paid for each of them.  The reference never meets this
problem — its state is host-side NumPy mutated in place (core.py:109-160)
— but a device serving runtime lives and dies by dispatch overhead.

``Packer`` flattens a pytree into one 1-D buffer per dtype (the delay's
row pointer is int32; everything else is float32).  ``PackedRunner``
wraps a chain-shaped function ``fn(state, targets, x) -> (state, y)`` so
the compiled program's arguments are (state_groups, target_groups, x):
unpack -> fn -> repack all happen inside the jit, where XLA sees only
cheap slices/reshapes/concats, and the packed state buffer is donated so
steady-state streaming does not reallocate.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


class Packer:
    """Flatten/unflatten a fixed-structure pytree to one 1-D array per
    dtype.  The structure (treedef, shapes, dtypes) is captured from an
    example at construction and must match every subsequent call."""

    def __init__(self, example):
        leaves, self.treedef = jax.tree.flatten(example)
        self.metas = []  # (dtype, shape, size, group_index, offset)
        self.dtypes = []
        offsets = {}
        for leaf in leaves:
            dt = jnp.asarray(leaf).dtype
            shape = tuple(np.shape(leaf))
            size = int(np.prod(shape, dtype=np.int64)) if shape else 1
            if dt not in offsets:
                offsets[dt] = 0
                self.dtypes.append(dt)
            gi = self.dtypes.index(dt)
            self.metas.append((dt, shape, size, gi, offsets[dt]))
            offsets[dt] += size
        self.group_sizes = tuple(offsets[dt] for dt in self.dtypes)

    @property
    def n_leaves(self):
        return len(self.metas)

    def pack(self, pytree):
        """pytree -> tuple of 1-D arrays, one per dtype (a device op —
        do it once per session / rebuild, not per block)."""
        leaves = self.treedef.flatten_up_to(pytree)
        parts = [[] for _ in self.dtypes]
        for leaf, (dt, shape, size, gi, _) in zip(leaves, self.metas):
            parts[gi].append(jnp.ravel(jnp.asarray(leaf, dt)))
        return tuple(
            p[0] if len(p) == 1 else jnp.concatenate(p) for p in parts
        )

    def unpack(self, groups):
        """tuple of 1-D arrays -> pytree (inside jit: static slices)."""
        leaves = []
        for dt, shape, size, gi, off in self.metas:
            flat = jax.lax.slice(groups[gi], (off,), (off + size,))
            leaves.append(flat.reshape(shape))
        return self.treedef.unflatten(leaves)


class HybridPacker:
    """Size-thresholded packing: leaves BIGGER than ``big_bytes`` pass
    through as their own buffers (repacking them would copy megabytes per
    step); smaller leaves pack into one 1-D buffer per dtype.  The
    flagship's batched serving state is 8 big rings + 29 sub-32 KB
    scalars/taps: hybrid packing cuts the dispatch from ~39 argument
    buffers to ~12."""

    def __init__(self, example, big_bytes=131072):
        leaves, self.treedef = jax.tree.flatten(example)
        # Per-leaf routing: ('big', big_index) or ('small', dtype_group,
        # offset, size); group order = bigs first, then one per dtype.
        self.routes = []
        self.n_big = 0
        self.small_dtypes = []
        offsets = {}
        for leaf in leaves:
            arr = jnp.asarray(leaf)
            shape = tuple(np.shape(leaf))
            size = int(np.prod(shape, dtype=np.int64)) if shape else 1
            if size * arr.dtype.itemsize > big_bytes:
                self.routes.append(("big", self.n_big, shape, arr.dtype))
                self.n_big += 1
            else:
                dt = arr.dtype
                if dt not in offsets:
                    offsets[dt] = 0
                    self.small_dtypes.append(dt)
                gi = self.small_dtypes.index(dt)
                self.routes.append(("small", gi, shape, dt, offsets[dt], size))
                offsets[dt] += size
        self.group_sizes = tuple(offsets[dt] for dt in self.small_dtypes)

    @property
    def n_groups(self):
        return self.n_big + len(self.small_dtypes)

    def pack(self, pytree):
        leaves = self.treedef.flatten_up_to(pytree)
        bigs = [None] * self.n_big
        smalls = [[] for _ in self.small_dtypes]
        for leaf, route in zip(leaves, self.routes):
            if route[0] == "big":
                bigs[route[1]] = jnp.asarray(leaf, route[3])
            else:
                _, gi, _s, dt, _o, _n = route
                smalls[gi].append(jnp.ravel(jnp.asarray(leaf, dt)))
        return tuple(bigs) + tuple(
            p[0] if len(p) == 1 else jnp.concatenate(p) for p in smalls
        )

    def unpack(self, groups):
        leaves = []
        for route in self.routes:
            if route[0] == "big":
                leaves.append(groups[route[1]])
            else:
                _, gi, shape, _dt, off, size = route
                flat = jax.lax.slice(
                    groups[self.n_big + gi], (off,), (off + size,)
                )
                leaves.append(flat.reshape(shape))
        return self.treedef.unflatten(leaves)


class PackedRunner:
    """A jitted ``fn(state, targets, x) -> (state, y)`` whose compiled
    signature is (state_groups, target_groups, x) with the state groups
    donated.  ``ex_state`` / ``ex_targets`` fix the pytree structure (use
    batched examples for vmapped serving)."""

    def __init__(self, fn, ex_state, ex_targets, donate=True):
        self.state_packer = Packer(ex_state)
        self.target_packer = Packer(ex_targets)

        # The closure must capture the PACKERS, never ``self``: a
        # self-referential closure (self -> self.fn -> packed -> cell ->
        # self) is cyclic garbage that the serving processes — which run
        # with gc.disable() (backend.py:123 parity) — would never free,
        # leaking the runner, its compiled executable, and the whole chain
        # behind ``fn`` on every rebuild (Chain.release rationale).
        state_packer, target_packer = self.state_packer, self.target_packer

        def packed(sgroups, tgroups, x):
            state = state_packer.unpack(sgroups)
            targets = target_packer.unpack(tgroups)
            new_state, y = fn(state, targets, x)
            return state_packer.pack(new_state), y

        self.fn = jax.jit(packed, donate_argnums=(0,) if donate else ())

    def pack_state(self, state):
        return self.state_packer.pack(state)

    def unpack_state(self, sgroups):
        return self.state_packer.unpack(sgroups)

    def pack_targets(self, targets):
        return self.target_packer.pack(targets)

    def __call__(self, sgroups, tgroups, x):
        return self.fn(sgroups, tgroups, x)
