"""GPU benchmark: the XLA step's steady rate (GLUPS, giga lattice-updates
per second) on three grids, in one process on one card.

- 1024x1024 x 10000, vs the reference's best cluster result (6.2 GLUPS:
  1024^2 x 20000 iters / 3.38 s on 112 Broadwell cores,
  report_mpi/report.tex:109-112, BASELINE.md);
- 131072x128 x 2000, vs the reference's 4-node hybrid (445.66 s / 20000
  iters = 0.753 GLUPS, report_mpi/report.tex:859);
- 16384x1024 x 2000, the weak-scaling north-star shape, vs the same
  6.2 GLUPS.

One JSON line per grid, each naming the device it ran on (platform,
device_kind, device count) and the card's name and power limit.
Compilation is timed apart from the run and reported as set-up; the first
execution is a warm-up; the best of the timed repeats is reported.
Without a GPU the script exits 1 and prints no rate.

Usage: python bench.py
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

BASELINE_GLUPS = 6.2  # reference's 112-core MPI best at 1024^2
BASELINE_GLUPS_WIDE = 0.753  # 131072x128: 4-node hybrid, 445.66 s / 20000

GRIDS = [
    ("GLUPS_1024x1024", 1024, 1024, 10000, BASELINE_GLUPS),
    ("GLUPS_131072x128", 131072, 128, 2000, BASELINE_GLUPS_WIDE),
    ("GLUPS_16384x1024", 16384, 1024, 2000, BASELINE_GLUPS),
]


def scene(nx: int, ny: int, iters: int, dtype=np.float32):
    """The reference's >=1024-wide scene parameters (accel 0.01) with
    boundary walls, at any size."""
    from lbm_tpu.obstacles import generate_obstacles
    from lbm_tpu.params import Params

    params = Params(nx=nx, ny=ny, max_iters=iters, reynolds_dim=10,
                    density=0.1, accel=0.01, omega=1.85, dtype=dtype)
    return params, generate_obstacles(nx, ny)


def measure(params, obstacles, repeats: int = 2) -> dict:
    """Compile the whole-run program, run it once untimed, then time
    ``repeats`` runs (each fenced by fetching av_vels to the host) and
    keep the best. Returns the rates and the program's memory figures."""
    import jax
    import jax.numpy as jnp

    from lbm_tpu.obstacles import num_non_obstacles_r
    from lbm_tpu.runner import make_simulate
    from lbm_tpu.state import initial_state

    inv = num_non_obstacles_r(obstacles, dtype=params.dtype)
    obs = jnp.asarray(obstacles)
    cells0 = initial_state(params)
    t0 = time.perf_counter()
    compiled = make_simulate(params).lower(cells0, obs, inv).compile()
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(repeats + 1):
        cells0 = initial_state(params)
        jax.block_until_ready(cells0)
        t0 = time.perf_counter()
        _, av = compiled(cells0, obs, inv)
        av = np.asarray(av)
        times.append(time.perf_counter() - t0)
    if not np.isfinite(av).all():
        raise RuntimeError(f"{params.nx}x{params.ny}: trajectory diverged")
    best = min(times[1:])
    stats = jax.devices()[0].memory_stats() or {}
    return {
        "compile_s": compile_s,
        "best_s": best,
        "glups": params.nx * params.ny * params.max_iters / best / 1e9,
        "memory_analysis": str(compiled.memory_analysis()),
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
    }


def main(argv=None) -> int:
    from lbm_tpu import jax_cache
    from lbm_tpu.device import (
        NoGPUError, device_fields, parse_card, query_card, require_gpu,
    )

    jax_cache.enable()
    try:
        devices = require_gpu()
    except NoGPUError as exc:
        print(f"bench.py: {exc}", file=sys.stderr)
        return 1
    card, power_limit = parse_card(query_card())
    fields = {**device_fields(devices), "card": card,
              "power_limit": power_limit}
    for metric, nx, ny, iters, base in GRIDS:
        params, obstacles = scene(nx, ny, iters)
        m = measure(params, obstacles)
        print(json.dumps({
            "metric": metric,
            "value": m["glups"],
            "unit": "GLUPS",
            "vs_baseline": m["glups"] / base,
            "compile_s": m["compile_s"],
            "best_s": m["best_s"],
            "iters": iters,
            **fields,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
