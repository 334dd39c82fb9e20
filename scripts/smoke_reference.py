"""CPU figures for chip_smoke.py's ATE gates.

Runs chip_smoke.py's system phases on the CPU and prints each phase's ATE,
to be written into ``chip_smoke.CPU_ATE_CM`` with the commit it came from.

Usage: python scripts/smoke_reference.py [loop|arc|stereo|distributed ...]

``distributed`` runs chip_smoke.py's four-card system phase on four virtual
CPU devices.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=4"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    import chip_smoke

    phases = sys.argv[1:] or ["loop", "arc", "stereo"]
    for name in phases:
        if name == "loop":
            out = chip_smoke.run_loop_circuit()
            print(f"loop_online {out['ate_online']!r}")
            print(f"loop_corrected {out['ate_corrected']!r}")
        elif name == "arc":
            print(f"arc {chip_smoke.run_pipelined_arc()['ate']!r}")
        elif name == "stereo":
            print(f"stereo {chip_smoke.run_stereo()['ate']!r}")
        elif name == "distributed":
            out = chip_smoke.run_distributed_system()
            print(f"distributed {out['ate']!r}")
        else:
            sys.exit(f"unknown phase {name!r}")


if __name__ == "__main__":
    main()
