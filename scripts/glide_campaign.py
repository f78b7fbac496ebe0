"""Extended parameter-glide fuzz campaign.

Sweeps the glide fuzzer's generator (tests/test_fuzz_glides.py) over an
arbitrary seed range: random A -> B retargets across each effect's full
ParamSpec range while streaming, asserting finiteness, exact landing on
clamp(B), and the bitwise A -> A no-op.

    python scripts/glide_campaign.py 6 100

CPU-only (virtual mesh); never touches a GPU.
"""

import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path[:0] = [
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"),
]

import numpy as np  # noqa: E402


def main(argv):
    import test_fuzz_glides as G
    from aefs_tpu.core.chain import build_chain
    from aefs_tpu.models import EFFECT_REGISTRY
    from helpers import bursts

    lo, hi = int(argv[1]), int(argv[2])
    fails = []
    for seed in range(lo, hi):
        rng = np.random.default_rng(2000 + seed)
        etype = G.GLIDE_TYPES[seed % len(G.GLIDE_TYPES)]
        cls = EFFECT_REGISTRY[etype]
        a = G.draw_params(cls, rng)
        b = G.draw_params(cls, rng, near=a)
        static = {"ir_seconds": 0.4} if etype == "convreverb" else {}
        try:
            cfg = [{"effect_id": "e", "type": etype, "params": {**static, **a}}]
            chain, state, _ = build_chain(
                cfg, G.FS, G.N, channels_in=1,
                static_overrides={"e": static} if static else None,
            )
            x = bursts(G.BLOCKS * G.N, amp=0.3, seed=seed)
            state, out = chain.process_array(state, chain.targets({"e": b}), x)
            chain.release()
            finite = bool(np.all(np.isfinite(out)))
            landed = all(
                abs(float(state["params"][0][n]) - s.clamp(b[n]))
                <= 1e-5 * max(1.0, abs(s.clamp(b[n])))
                for n, s in cls.PARAMS.items()
            )
            bad = not (finite and landed)
            if bad:
                fails.append(seed)
            print(
                f"{'FAIL' if bad else 'ok'} seed={seed} {etype} "
                f"finite={finite} landed={landed}",
                flush=True,
            )
        except Exception as e:  # noqa: BLE001 — a crash IS a finding
            fails.append(seed)
            print(f"ERROR seed={seed} {etype}: {type(e).__name__}: {e}", flush=True)
    print(f"GLIDE CAMPAIGN DONE seeds=[{lo},{hi}) failures={len(fails)}: {fails}")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
