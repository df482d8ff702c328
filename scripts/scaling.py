#!/usr/bin/env python3
"""Scaling analysis over sweep results — the reference's scaling.py
(speedup vs the 1-device config per grid) reading the JSON emitted by
scripts/sweep.py instead of fixed line offsets of Slurm .out files.

Usage: python scripts/scaling.py sweep_results.json
"""

import json
import sys
from collections import defaultdict


def print_scalings(results):
    by_grid = defaultdict(dict)
    for r in results:
        if "error" in r:
            continue
        key = (r["grid"], r.get("backend", "?"), r.get("mode", "hardware"))
        # Per-step time: --append-merged files can hold rows measured
        # at different --iters for different device counts.
        by_grid[key][r["devices"]] = r["seconds"] / max(r.get("iters", 1), 1)
    for (grid, backend, mode), times in sorted(by_grid.items()):
        if 1 not in times:
            continue
        base = times[1]
        tag = backend + ("" if mode == "hardware" else f", {mode}")
        print(f"{grid} [{tag}]:")
        for nd in sorted(times):
            print(f"  ({nd}, {base / times[nd]:.3f})")


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    path = argv[0] if argv else "sweep_results.json"
    with open(path) as f:
        print_scalings(json.load(f))
    return 0


if __name__ == "__main__":
    sys.exit(main())
