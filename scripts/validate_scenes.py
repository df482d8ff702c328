#!/usr/bin/env python3
"""Full-scene golden validation: run each golden-bearing scene
(scenes/, goldens/) end-to-end through the CLI and gate both files with
the reference checker's formula (check/check.py:57-99, tolerance 1%)
against the repo-owned float64 goldens (goldens/*.f64.npz: av_vels, and
final_state pressure — column 5, the column check.py compares).

Every scene runs under BOTH f32 associations: the default (the
reference's term-by-term association) and the paired equilibrium
(LBM_PAIRED_EQ=1). ``ok`` additionally requires the default's max diff
<= DRIFT_BUDGET_PCT (0.3%), so reassociating optimisations cannot stack
silently toward the 1% cliff. A row passes only with both diffs
measured. Timing is the bench's job, not this gate's.

Usage: python scripts/validate_scenes.py [--scenes 256x256 1024x1024]
           [-o validate_scenes.json]
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
SCENES = REPO / "scenes"
GOLDENS = REPO / "goldens"

GOLDEN_SCENES = ["256x256", "1024x1024"]
TOLERANCE = 1.0  # check.py's default max %diff gate
DRIFT_BUDGET_PCT = 0.3
# The two f32 associations: the shipping default and the paired form.
ASSOCIATIONS = {
    "default": {},
    "paired": {"LBM_PAIRED_EQ": "1"},
}


def run_scene(scene: str, workdir: Path, env_overrides: dict) -> dict:
    from lbm_tpu.io import compare_golden_npz

    av = workdir / f"{scene}.av_vels.dat"
    fs = workdir / f"{scene}.final_state.dat"
    cmd = [
        sys.executable, "-m", "lbm_tpu",
        str(SCENES / f"input_{scene}.params"),
        str(SCENES / f"obstacles_{scene}.dat"),
        "--av-vels-file", str(av), "--final-state-file", str(fs),
    ]
    res = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO,
                         env={**os.environ, **env_overrides})
    if res.returncode != 0:
        return {"scene": scene, "pass": False, "error": res.stderr[-1000:]}
    cmp = compare_golden_npz(av, fs, GOLDENS / f"{scene}.final_state.f64.npz",
                             tolerance=TOLERANCE)
    return {
        "scene": scene,
        "max_av_vels_pct": abs(cmp.av_vels.max_diff_pcnt),
        "max_final_state_pct": abs(cmp.final_state.max_diff_pcnt),
        "pass": cmp.passed,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scenes", nargs="+", default=GOLDEN_SCENES)
    p.add_argument("-o", "--output", default="validate_scenes.json")
    args = p.parse_args(argv)

    rows = []
    with tempfile.TemporaryDirectory() as td:
        for scene in args.scenes:
            for assoc, env_over in ASSOCIATIONS.items():
                r = run_scene(scene, Path(td), env_over)
                r["association"] = assoc
                if assoc == "default" and r["pass"]:
                    worst = max(r["max_av_vels_pct"],
                                r["max_final_state_pct"])
                    r["within_drift_budget"] = worst <= DRIFT_BUDGET_PCT
                    r["pass"] = r["within_drift_budget"]
                print(json.dumps(r), flush=True)
                rows.append(r)
    results = {
        "tolerance_pct": TOLERANCE,
        "drift_budget_pct": DRIFT_BUDGET_PCT,
        "scenes": rows,
        "ok": all(r["pass"] for r in rows),
    }
    out = Path(args.output)
    out.write_text(json.dumps(results, indent=2) + "\n")
    print(f"{'PASS' if results['ok'] else 'FAIL'} -> {out}")
    return 0 if results["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
