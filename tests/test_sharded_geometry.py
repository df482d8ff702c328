"""The sharded XLA step (the path multi-card runs take) against the
unsharded one over 1-8 virtual devices: divisor and non-divisor heights,
walled and wall-less masks, with the forced row ny-2 placed on a shard
seam (the first row of the last shard, whose south halo crosses
devices)."""

import numpy as np
import pytest

from lbm_tpu.obstacles import generate_obstacles
from lbm_tpu.params import Params
from lbm_tpu.parallel.decomp import make_mesh
from lbm_tpu.parallel.halo import plan_padding_mode
from lbm_tpu.runner import run_simulation


def _cases():
    cases = []
    for n in range(1, 9):
        # Two (padded) rows per shard: row ny-2 is the last shard's row 0.
        heights = [("divisor", 2 * n if n > 1 else 6)]
        if n > 1:
            heights.append(("nondivisor", 2 * n - 1))
        for div, ny in heights:
            for walls in ("walls", "wall-less"):
                cases.append(pytest.param(
                    n, ny, walls == "walls", id=f"{n}dev-{div}-{walls}"))
    return cases


def _mask(nx, ny, walls, seed):
    rng = np.random.default_rng(seed)
    scattered = rng.random((ny, nx)) < 0.1
    mask = generate_obstacles(nx, ny) | scattered if walls else scattered
    mask[ny - 2, 3] = False  # the forced row keeps fluid
    return mask


@pytest.mark.parametrize("n_dev,ny,walls", _cases())
def test_sharded_matches_unsharded(n_dev, ny, walls):
    p = Params(nx=16, ny=ny, max_iters=12, reynolds_dim=10,
               density=0.1, accel=0.005, omega=1.85)
    mask = _mask(p.nx, ny, walls, seed=10 * n_dev + ny)
    mesh = make_mesh(n_dev)
    mode, pad = plan_padding_mode(p, mask, mesh)
    assert mode == ("none" if ny % n_dev == 0
                    else "wall" if walls else "wrap")
    base = run_simulation(p, mask)
    got = run_simulation(p, mask, mesh=mesh)
    assert got.cells.shape == base.cells.shape
    np.testing.assert_allclose(base.cells, got.cells, rtol=2e-5, atol=5e-8)
    np.testing.assert_allclose(base.av_vels, got.av_vels, rtol=1e-4)
