"""Full-scene float64 validation artifact: run a complete scene in
float64 (the golden data's own precision — the reference association is
always used in f64, ops/reference.py) and record the max %diff against
the reference's golden files (``--reference-dir``: its check/ data),
substantiating the README's ~1e-10% claim end-to-end rather than from a
short prefix (tests/test_float64.py).

Writes docs/artifacts/float64_full_scene.json. CPU-only (x64).
Usage: python scripts/float64_full_scene.py --reference-dir DIR
           [--scene 128x128]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
SCENES = REPO / "scenes"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scene", default="128x128")
    ap.add_argument("-o", "--output",
                    default="docs/artifacts/float64_full_scene.json")
    ap.add_argument("--reference-dir", type=Path, required=True,
                    help="checkout of the reference solver (check/ data)")
    args = ap.parse_args(argv)
    check = args.reference_dir / "check"

    # CPU before jax initialises; f64 compute needs x64.
    from lbm_tpu.parallel.decomp import provision_virtual_cpu

    provision_virtual_cpu(1)
    import jax

    jax.config.update("jax_enable_x64", True)
    import numpy as np

    from lbm_tpu.io import _diff, final_state_fields
    from lbm_tpu.obstacles import load_obstacles
    from lbm_tpu.params import load_params
    from lbm_tpu.runner import run_simulation

    scene = args.scene
    params = load_params(SCENES / f"input_{scene}.params",
                         dtype=np.float64)
    obstacles = load_obstacles(
        SCENES / f"obstacles_{scene}.dat", params.nx, params.ny
    )
    t0 = time.time()
    res = run_simulation(params, obstacles, kernel="reference")
    wall = time.time() - t0

    ref_av = np.loadtxt(check / f"{scene}.av_vels.dat", usecols=[1])
    av_diff = _diff(ref_av, res.av_vels, tolerance=1.0)

    out = {
        "scene": scene,
        "iters": params.max_iters,
        "dtype": "float64",
        "association": "reference (term-by-term; f64 never reassociates)",
        "wall_seconds": round(wall, 1),
        "reynolds": res.reynolds,
        "max_av_vels_pct": abs(float(av_diff.max_diff_pcnt)),
    }
    ref_fs = check / f"{scene}.final_state.dat"
    if ref_fs.exists():
        # The reference checker compares PRESSURE, column 5
        # (check/check.py:61) — never zero, unlike |u|.
        ref_p = np.loadtxt(ref_fs, usecols=[5])
        _, _, _, sim_p = final_state_fields(params, res.cells, obstacles)
        fs_diff = _diff(ref_p, np.asarray(sim_p).ravel(), tolerance=1.0)
        out["max_final_state_pct"] = abs(float(fs_diff.max_diff_pcnt))
    out["ok"] = all(
        v < 1e-6 for k, v in out.items() if k.endswith("_pct")
    )

    path = REPO / args.output
    os.makedirs(path.parent, exist_ok=True)
    path.write_text(json.dumps(out, indent=2) + "\n")
    print(json.dumps(out, indent=2))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
