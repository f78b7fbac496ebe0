"""Extended differential-fuzz campaign over random chain topologies.

The CI fuzzer (tests/test_fuzz_topologies.py) pins 8 seeds; this script
sweeps an arbitrary seed range with the same generator and contracts —
use it for deep sweeps between releases:

    python scripts/fuzz_campaign.py 8 200            # seeds [8, 200)
    python scripts/fuzz_campaign.py 8 200 --parallel  # every 4th seed
                                                       # wraps sub-chains

Runs on the virtual CPU mesh (never touches a GPU).  Prints one
line per seed and a final summary; exit code 1 if any seed fails.

Findings to date: seed 25 exposed the float32 log-doubling instability
in the biquad file solver's AR(2) impulse (NaN at legal high-Q draws,
fixed by the closed form — ops/scan.py:ar2_impulse); the first CI run
caught a scrambled TwoSum in the octaver phasor carry.
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
    import test_fuzz_topologies as F
    from helpers import bursts

    lo, hi = int(argv[1]), int(argv[2])
    fails = []
    for seed in range(lo, hi):
        rng = np.random.default_rng(1000 + seed)
        cfgs, tol = F.random_chain(rng, allow_parallel=(seed % 4 == 3))
        label = " -> ".join(c["type"] for c in cfgs)
        x = bursts(F.N, amp=0.3, seed=seed)
        try:
            bw = F.run(cfgs, x, fast=False, blocksize=4096)
            ft = F.run(cfgs, x, fast=True, blocksize=4096)
            st = F.run(cfgs, x, fast=False, blocksize=256)
            finite = all(
                np.all(np.isfinite(a)) for a in (bw, ft, st)
            )
            g1 = F.relative_gap(bw, ft)
            g2 = F.relative_gap(bw, st)
            bad = (not finite) or (
                tol is not None and (g1 > tol or g2 > tol)
            )
            if bad:
                fails.append(seed)
            tstr = "None" if tol is None else f"{tol:.0f}"
            print(
                f"{'FAIL' if bad else 'ok'} seed={seed} tol={tstr} {label} "
                f"fast={g1:.1f} stream={g2:.1f} finite={finite}",
                flush=True,
            )
        except Exception as e:  # noqa: BLE001 — a crash IS a finding
            fails.append(seed)
            print(f"ERROR seed={seed} {label}: {type(e).__name__}: {e}", flush=True)
    print(f"CAMPAIGN DONE seeds=[{lo},{hi}) failures={len(fails)}: {fails}")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
