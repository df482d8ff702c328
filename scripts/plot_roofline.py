#!/usr/bin/env python3
"""Roofline plot from sweep results — the analogue of the reference's
Intel Advisor roofline HTMLs (roofline/) and plots.ipynb analysis:
measured single-device GPU rows against the device's published
memory-bandwidth and float32 roofs (lbm_tpu.profiling.DEVICE_PEAKS,
looked up by each row's ``device_kind``).

Usage: python scripts/plot_roofline.py [sweep_results.json] [-o roofline.png]
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from lbm_tpu.profiling import (  # noqa: E402
    BYTES_PER_CELL_F32_MASK,
    FLOPS_PER_CELL,
    device_peaks,
)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("sweep", nargs="?", default="sweep_results.json")
    p.add_argument("-o", "--output", default="roofline.png")
    args = p.parse_args(argv)

    with open(args.sweep) as f:
        rows = json.load(f)
    # Only single-device GPU rows are hardware measurements of one card.
    results = [
        r for r in rows
        if "error" not in r and r.get("devices", 1) == 1
        and r.get("backend") == "gpu"
    ]
    if not results:
        print("no single-device GPU rows to plot", file=sys.stderr)
        return 1
    kinds = {r["device_kind"] for r in results}
    if len(kinds) != 1:
        print(f"rows from several devices {sorted(kinds)}; plot one",
              file=sys.stderr)
        return 1
    (kind,) = kinds
    peaks = device_peaks(kind)
    ai = FLOPS_PER_CELL / BYTES_PER_CELL_F32_MASK  # flops per byte

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    fig, ax = plt.subplots(figsize=(8, 6))
    xs = np.logspace(-2, 3, 256)
    roof = np.minimum(xs * peaks["hbm_gbps"], peaks["tflops_f32"] * 1e3)
    ax.plot(xs, roof, "k-", lw=2, label=f"{kind} roofline (f32)")
    ax.axvline(ai, color="grey", ls=":", lw=1)
    for idx, r in enumerate(results):
        gflops = r["glups"] * FLOPS_PER_CELL  # GFLOP/s
        ax.plot([ai], [gflops], "o", ms=7)
        # Stagger label rows: points at one intensity otherwise overprint.
        ax.annotate(
            f"{r['grid']} ({r['glups']:.1f} GLUPS)", (ai, gflops),
            textcoords="offset points", xytext=(8, -4 - 9 * (idx % 4)),
            fontsize=8,
        )
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("arithmetic intensity (FLOP/byte)")
    ax.set_ylabel("GFLOP/s")
    ax.set_title("lbm_tpu XLA step vs roofline")
    ax.legend(loc="upper left", fontsize=8)
    ax.grid(True, which="both", alpha=0.25)
    fig.savefig(args.output, dpi=150, bbox_inches="tight")
    print(f"wrote {args.output} ({len(results)} points, "
          f"{len(rows) - len(results)} rows skipped)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
