#!/usr/bin/env python3
"""Full-length drift gate for scenes without golden data.

The reference ships golden outputs for only some of its scenes, and
validated its large grids (2048x1024 .. 16384x1024) only by eyeballing
Reynolds numbers. This harness gives any scene an acceptance gate: run
the FULL scene end-to-end through the CLI twice on the same device —
float32 (the production precision) and ``--precision float64`` (the
golden data's own precision) — and require the two av_vels trajectories
and final pressure fields (final_state column 5, the column check.py
compares) to agree by check.py's max-%-diff formula (check/check.py:83-99)
within the 0.3% drift budget, far under check.py's 1% tolerance.

Usage: python scripts/full_scenes.py [--scenes 128x128 128x256]
           [--scene-dir scenes] [--gate-pct 0.3] [-o full_scenes.json]
"""

import argparse
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

# The repo's scenes without golden data (scripts/validate_scenes.py
# gates the others against goldens/).
SCENES = ["128x128", "128x256"]
GATE_PCT = 0.3


def _run_cli(scene: str, scene_dir: Path, precision: str, workdir: Path,
             timeout: float) -> dict:
    """One end-to-end CLI run; returns parsed stdout + output paths, or
    an ``error`` row (a timeout is returned, not raised)."""
    av = workdir / f"{scene}.{precision}.av_vels.dat"
    fs = workdir / f"{scene}.{precision}.final_state.dat"
    cmd = [
        sys.executable, "-m", "lbm_tpu",
        str(scene_dir / f"input_{scene}.params"),
        str(scene_dir / f"obstacles_{scene}.dat"),
        "--precision", precision,
        "--av-vels-file", str(av),
        "--final-state-file", str(fs),
    ]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO,
                             timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"error": f"CLI leg timed out after {timeout:.0f}s"}
    if res.returncode != 0:
        return {"error": res.stderr[-1000:]}
    m_rey = re.search(r"Reynolds number:\s+(\S+)", res.stdout)
    m_cmp = re.search(r"Compute time:\s+(\S+)", res.stdout)
    if m_rey is None or m_cmp is None:
        return {"error": f"unexpected CLI stdout: {res.stdout[-500:]!r}"}
    return {
        "reynolds": float(m_rey.group(1)),
        "compute_seconds": float(m_cmp.group(1)),
        "wall_seconds": round(time.perf_counter() - t0, 2),
        "av_vels_file": av,
        "final_state_file": fs,
    }


def run_scene(scene: str, scene_dir: Path, workdir: Path, gate_pct: float,
              timeout: float) -> dict:
    from lbm_tpu.io import _diff, load_av_vels, load_final_state

    out = {"scene": scene, "gate_pct": gate_pct}
    legs = {}
    for precision in ("float32", "float64"):
        leg = _run_cli(scene, scene_dir, precision, workdir, timeout)
        if "error" in leg:
            out.update({"pass": False, "precision": precision,
                        "error": leg["error"]})
            return out
        legs[precision] = leg
        out[precision] = {k: leg[k] for k in
                          ("reynolds", "compute_seconds", "wall_seconds")}
    ref, sim = legs["float64"], legs["float32"]
    ref_av = load_av_vels(ref["av_vels_file"])
    sim_av = load_av_vels(sim["av_vels_file"])
    ref_p = load_final_state(ref["final_state_file"])[:, 2]
    sim_p = load_final_state(sim["final_state_file"])[:, 2]
    assert ref_av.size == sim_av.size, "step-count mismatch between legs"
    assert ref_p.size == sim_p.size, "cell-count mismatch between legs"
    av_pct = abs(float(_diff(ref_av, sim_av, gate_pct).max_diff_pcnt))
    p_pct = abs(float(_diff(ref_p, sim_p, gate_pct).max_diff_pcnt))
    out["max_av_vels_pct"] = av_pct
    out["max_final_state_pct"] = p_pct
    out["pass"] = bool(np.isfinite([av_pct, p_pct]).all()
                       and av_pct <= gate_pct and p_pct <= gate_pct)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scenes", nargs="+", default=SCENES)
    p.add_argument("--scene-dir", default=str(REPO / "scenes"),
                   help="directory holding input_*.params / "
                        "obstacles_*.dat")
    p.add_argument("--gate-pct", type=float, default=GATE_PCT)
    p.add_argument("--timeout", type=float, default=3600.0,
                   help="per-leg subprocess timeout")
    p.add_argument("-o", "--output", default="full_scenes.json")
    p.add_argument(
        "--append", action="store_true",
        help="merge into the existing output: re-run scenes replace "
             "their rows, other scenes' rows are kept",
    )
    args = p.parse_args(argv)

    rows = []
    with tempfile.TemporaryDirectory() as td:
        for scene in args.scenes:
            r = run_scene(scene, Path(args.scene_dir).resolve(), Path(td),
                          args.gate_pct, args.timeout)
            print(json.dumps(r), flush=True)
            rows.append(r)
    out = Path(args.output)
    if args.append and out.exists():
        redone = {r["scene"] for r in rows}
        prev = json.loads(out.read_text()).get("scenes", [])
        rows = [r for r in prev if r["scene"] not in redone] + rows
    results = {"gate_pct": args.gate_pct, "scenes": rows,
               "ok": all(r.get("pass") for r in rows)}
    out.write_text(json.dumps(results, indent=2) + "\n")
    print(f"{'PASS' if results['ok'] else 'FAIL'} -> {out}")
    return 0 if results["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
