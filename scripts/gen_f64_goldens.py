#!/usr/bin/env python3
"""Generate repo-owned float64 golden final_state data for the scenes
whose reference golden final_state.dat files are not distributed
(256x256 and 1024x1024); the acceptance fingerprint needs the
reference's own check/<scene>.av_vels.dat files (``--reference-dir``).

The float64 CPU path reproduces the surviving golden data to ~1e-10%
(docs/artifacts/float64_full_scene.json — same original-code semantics,
just without f32 rounding), so its final_state is golden-grade for the
1%-tolerance gate. Each scene is generated by a full f64 run of the jnp
reference kernel and ACCEPTED ONLY IF its trajectory matches the
reference's own (surviving) golden av_vels to <= 1e-6 max %diff — three
orders tighter than any f32 drift — which fingerprints the entire
20k/80k-step history leading to the stored field.

Stored per scene (goldens/{scene}.final_state.f64.npz):
  pressure  -- final_state column 5, the column the reference's checker
               gates (check/check.py:61,99), row-major cell order
  u         -- |u| column 4 (for cross-checks), same order
  av_vels   -- the f64 trajectory (provenance; NOT a gate input — the
               reference's own av_vels goldens remain the av gate)
  + nx/ny/iters/reynolds/max_av_vels_pct metadata.

scripts/validate_scenes.py and chip_smoke.py gate against these with
the two-file gate (check/check.py:57-99). Scene inputs: scenes/.

CPU-only (x64). Usage:
  python scripts/gen_f64_goldens.py --reference-dir DIR
      [--scenes 256x256 1024x1024]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
SCENES = REPO / "scenes"

# Acceptance gate on the trajectory fingerprint vs the reference's own
# golden av_vels: f64 agreement is ~1e-10% (float64_full_scene.json);
# 1e-6 leaves margin while staying 6 orders under the checker's 1%.
ACCEPT_AV_PCT = 1e-6


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scenes", nargs="+", default=["256x256", "1024x1024"])
    ap.add_argument("--out-dir", default="goldens")
    ap.add_argument("--reference-dir", type=Path, required=True,
                    help="checkout of the reference solver (its check/ "
                         "golden av_vels are the acceptance fingerprint)")
    args = ap.parse_args(argv)
    check = args.reference_dir / "check"

    # CPU before jax initialises; f64 needs x64.
    from lbm_tpu.parallel.decomp import provision_virtual_cpu

    provision_virtual_cpu(1)
    import jax

    jax.config.update("jax_enable_x64", True)
    import numpy as np

    from lbm_tpu.io import _diff, final_state_fields
    from lbm_tpu.obstacles import load_obstacles
    from lbm_tpu.params import load_params
    from lbm_tpu.runner import run_simulation

    out_dir = REPO / args.out_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    rc = 0
    for scene in args.scenes:
        params = load_params(SCENES / f"input_{scene}.params",
                             dtype=np.float64)
        obstacles = load_obstacles(
            SCENES / f"obstacles_{scene}.dat", params.nx, params.ny
        )
        t0 = time.time()
        res = run_simulation(params, obstacles, kernel="reference")
        wall = time.time() - t0

        ref_av = np.loadtxt(check / f"{scene}.av_vels.dat", usecols=[1])
        av_pct = abs(float(_diff(ref_av, res.av_vels,
                                 tolerance=1.0).max_diff_pcnt))
        meta = {
            "scene": scene,
            "iters": params.max_iters,
            "reynolds": res.reynolds,
            "max_av_vels_pct_vs_reference_golden": av_pct,
            "wall_seconds": round(wall, 1),
        }
        if av_pct > ACCEPT_AV_PCT:
            print(json.dumps({**meta, "ok": False,
                              "error": f"trajectory fingerprint "
                                       f"{av_pct:g}% > {ACCEPT_AV_PCT:g}%; "
                                       "refusing to write a golden"}),
                  flush=True)
            rc = 1
            continue

        _, _, u, pressure = final_state_fields(params, res.cells, obstacles)
        path = out_dir / f"{scene}.final_state.f64.npz"
        np.savez_compressed(
            path,
            pressure=np.asarray(pressure, dtype=np.float64).ravel(),
            u=np.asarray(u, dtype=np.float64).ravel(),
            av_vels=np.asarray(res.av_vels, dtype=np.float64),
            nx=np.int64(params.nx),
            ny=np.int64(params.ny),
            iters=np.int64(params.max_iters),
            reynolds=np.float64(res.reynolds),
            max_av_vels_pct_vs_reference_golden=np.float64(av_pct),
            note=np.str_(
                "repo-owned f64 golden: full-scene float64 run of the jnp "
                "reference kernel (ops/reference.py), accepted against the "
                "reference's surviving golden av_vels at <=1e-6 max %diff; "
                "generated by scripts/gen_f64_goldens.py"
            ),
        )
        meta.update({"ok": True, "path": str(path.relative_to(REPO)),
                     "bytes": path.stat().st_size})
        print(json.dumps(meta), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
