#!/usr/bin/env python3
"""Benchmark sweep — the analogue of the reference's Slurm rank/thread
sweeps (js_procs/js_1..112, js_threads/js_1..28): runs the standard grids
across device counts with the XLA step and records JSON rows.

Every row names the device it ran on (platform, device_kind); rows not
measured on a GPU are marked ``functional-not-hardware`` (virtual CPU
devices prove the sharded program, not its speed).

Usage:
    python scripts/sweep.py [--grids 128x128 1024x1024 ...]
        [--devices 1 2 4] [--iters N] [--repeats R] [-o sweep_results.json]
        [--platform cpu] (forces a virtual CPU platform sized to
        max(--devices), like tests/conftest.py)
"""

import argparse
import itertools
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402


GRID_SCENES = {
    # nx, ny, iters, accel — from the reference's input_*.params files.
    "128x128": (128, 128, 40000, 0.005),
    "128x256": (128, 256, 40000, 0.005),
    "256x256": (256, 256, 80000, 0.005),
    "1024x1024": (1024, 1024, 20000, 0.01),
    "2048x1024": (2048, 1024, 20000, 0.01),
    "4096x1024": (4096, 1024, 20000, 0.01),
    "8192x1024": (8192, 1024, 20000, 0.01),
    "16384x1024": (16384, 1024, 20000, 0.01),
    # The reference's hybrid-report stress grid (report_mpi/report.tex:859);
    # no shipped .params file, parameters follow the >=1024-wide scenes.
    "131072x128": (131072, 128, 20000, 0.01),
}


def run_config(grid, n_devices, iters, repeats):
    import jax
    import jax.numpy as jnp
    from lbm_tpu.obstacles import generate_obstacles, num_non_obstacles_r
    from lbm_tpu.params import Params
    from lbm_tpu.state import initial_state

    nx, ny, default_iters, accel = GRID_SCENES[grid]
    iters = iters or min(default_iters, 2000)
    params = Params(nx=nx, ny=ny, max_iters=iters, reynolds_dim=10,
                    density=np.float32(0.1), accel=np.float32(accel),
                    omega=np.float32(1.85))
    obstacles = generate_obstacles(nx, ny)
    inv = num_non_obstacles_r(obstacles)
    obs_dev = jnp.asarray(obstacles)

    if n_devices > 1:
        from lbm_tpu.parallel.decomp import make_mesh
        from lbm_tpu.parallel.halo import make_sharded_simulate, shard_inputs

        mesh = make_mesh(n_devices)
        simulate = make_sharded_simulate(params, mesh)

        def fresh():
            return shard_inputs(mesh, initial_state(params), obs_dev)
    else:
        from lbm_tpu.runner import make_simulate

        simulate = make_simulate(params)

        def fresh():
            return initial_state(params), obs_dev

    cells0, obs_in = fresh()
    compiled = simulate.lower(cells0, obs_in, inv).compile()
    _, a = compiled(cells0, obs_in, inv)
    np.asarray(a)  # untimed first execution

    best = float("inf")
    for _ in range(repeats):
        cells0, obs_in = fresh()
        jax.block_until_ready(cells0)
        t0 = time.perf_counter()
        _, a = compiled(cells0, obs_in, inv)
        np.asarray(a)
        best = min(best, time.perf_counter() - t0)
    dev = jax.devices()[0]
    row = {
        "grid": grid, "devices": n_devices, "iters": iters,
        "seconds": best, "glups": nx * ny * iters / best / 1e9,
        "backend": dev.platform, "device_kind": dev.device_kind,
    }
    if dev.platform != "gpu":
        row["mode"] = "functional-not-hardware"
    return row


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--grids", nargs="+",
                   default=["128x128", "256x256", "1024x1024"])
    p.add_argument("--devices", nargs="+", type=int, default=[1])
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("-o", "--output", default="sweep_results.json")
    p.add_argument("--platform", default=None, choices=["cpu"],
                   help="force a virtual CPU platform sized to "
                        "max(--devices)")
    args = p.parse_args(argv)

    if args.platform == "cpu":
        from lbm_tpu.parallel.decomp import provision_virtual_cpu

        provision_virtual_cpu(max(args.devices))

    out = Path(args.output)
    results = []
    for grid, nd in itertools.product(args.grids, args.devices):
        try:
            r = run_config(grid, nd, args.iters, args.repeats)
        except Exception as exc:  # record failures, keep sweeping
            r = {"grid": grid, "devices": nd,
                 "error": f"{type(exc).__name__}: {exc}"}
        print(json.dumps(r), flush=True)
        results.append(r)
        out.write_text(json.dumps(results, indent=2) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
