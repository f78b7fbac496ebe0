"""Randomized hetero-pool migration-parity campaign.

The CI test (tests/test_pool_hetero.py::test_migration_parity_fuzz_pinned)
pins 2 seeds; this script sweeps an arbitrary seed range with the same
trial (tests/test_pool_hetero.py:migration_fuzz_seed): a session migrates
through random chain topologies inside one MultiPool while a neighbor
stays put, and both must stay BITWISE identical to dedicated
single-topology pools after every migration — use it for deep sweeps
between releases:

    python scripts/pool_migration_fuzz.py 500 560

Runs on the virtual CPU mesh (never touches a GPU).  Prints one
line per seed and a final summary; exit code 1 if any seed fails.
"""

import os
import sys
import time

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path[:0] = [
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"),
]


def main(argv):
    import test_pool_hetero as H

    lo, hi = int(argv[1]), int(argv[2])
    fails = []
    for seed in range(lo, hi):
        t0 = time.time()
        try:
            H.migration_fuzz_seed(seed)
            print(f"ok seed={seed} ({time.time() - t0:.1f}s)", flush=True)
        except Exception as e:
            fails.append(seed)
            print(f"FAIL seed={seed}: {type(e).__name__}: "
                  f"{str(e)[:400]}", flush=True)
    print(f"MIGRATION CAMPAIGN DONE seeds=[{lo},{hi}) "
          f"failures={len(fails)}: {fails}", flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
