"""``python -m repro_torch.analysis`` — the contract gate.

Collects every governed module's CONTRACTS, builds the five canonical
programs on the card (``--device cpu`` for the plain versions), runs the
selected passes, prints the verdict table, and exits nonzero on any FAIL.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.analysis import driver
from repro_torch.analysis.contracts import KINDS, summarize
from repro_torch.analysis.programs import PROGRAM_NAMES


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="contract-driven checks of the BRIDGE port's programs")
    ap.add_argument("--programs", nargs="+", choices=PROGRAM_NAMES,
                    metavar="PROG",
                    help=f"canonical programs to build (default: all of "
                         f"{', '.join(PROGRAM_NAMES)})")
    ap.add_argument("--passes", nargs="+", choices=KINDS, metavar="PASS",
                    help=f"passes to run (default: all of {', '.join(KINDS)})")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="suppress progress lines (verdict table only)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    log = None if args.quiet else lambda msg: print(f"  .. {msg}", flush=True)
    results = driver.run_all(program_names=args.programs, kinds=args.passes,
                             device=args.device, log=log)
    print(summarize(results))
    return 1 if any(not r.ok for r in results) else 0


if __name__ == "__main__":
    sys.exit(main())
