"""Every float32 dot on an effect path carries HIGHEST precision.

On the GPU a float32 product with no precision may run in TF32 (10
mantissa bits), which puts the one-hot and banded tap operators' error
near -60 dBFS; the CPU tests cannot see that, so this test reads the
lowered programs instead (ops/precision.py)."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bench
from aefs_tpu.core.chain import build_chain
from aefs_tpu.core.fileopts import file_static_overrides

FS = 48000

CHAINS = {
    "flagship": bench.CONFIGS["5_five_effect"],
    "x_new_effects": bench.CONFIGS["x_new_effects"],
    "chorus": [{"effect_id": "c", "type": "chorus",
                "params": {"rate_hz": 0.8, "depth_ms": 3.0, "base_ms": 12.0,
                           "mix": 0.5, "spread": 0.25}}],
    "flanger": [{"effect_id": "f", "type": "flanger",
                 "params": {"rate_hz": 0.3, "depth_ms": 2.0, "base_ms": 2.5,
                            "feedback": 0.6, "mix": 0.5, "spread": 0.25}}],
}


def dot_precisions(text):
    """The precision attribute of every dot_general in StableHLO text."""
    lines = [l for l in text.splitlines() if "stablehlo.dot_general" in l]
    return [(re.search(r"precision = \[([A-Z, ]+)\]", l) or [None, "DEFAULT"])[1]
            for l in lines]


def lowered(cfgs, mode):
    if mode == "file":
        n, blocksize = 4 * 4096, 4096
        chain, state, tmap = build_chain(cfgs, FS, blocksize, channels_in=1,
                                         static_overrides=file_static_overrides(cfgs))
        fn = chain.process_whole
    else:
        n = blocksize = 256
        chain, state, tmap = build_chain(cfgs, FS, blocksize, channels_in=1)
        fn = chain.process_block
    x = jnp.zeros((1, n), jnp.float32)
    return jax.jit(fn).lower(state, chain.targets(tmap), x).as_text()


@pytest.mark.parametrize("mode", ["file", "stream"])
@pytest.mark.parametrize("name", sorted(CHAINS))
def test_every_dot_is_highest(name, mode):
    precs = dot_precisions(lowered(CHAINS[name], mode))
    assert all(p == "HIGHEST, HIGHEST" for p in precs), precs


@pytest.mark.parametrize("name,mode", [("flagship", "file"), ("flanger", "stream"),
                                       ("flanger", "file"), ("chorus", "file")])
def test_guard_is_not_vacuous(name, mode):
    """These lowerings do contain dots (comb propagator, flanger tap
    operators, the chorus's chunked taps), so the guard reads real ones."""
    assert dot_precisions(lowered(CHAINS[name], mode))


def test_guard_sees_a_default_dot():
    """The reader itself: a dot without precision reads as DEFAULT."""
    a = jnp.ones((4, 4), jnp.float32)
    text = jax.jit(lambda a: a @ a).lower(a).as_text()
    assert dot_precisions(text) == ["DEFAULT, DEFAULT"]
