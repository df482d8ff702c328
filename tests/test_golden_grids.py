"""Golden trajectory-prefix tests for every repo-owned scene.

av_vels[t] depends only on steps <= t, so short runs validate the whole
per-step pipeline (streaming orientation, acceleration row, observable
normalisation) for each scene geometry: square, tall (nx != ny), and the
large accel=0.01 grid. 256x256 and 1024x1024 gate against their float64
goldens (goldens/); 128x128 and 128x256 have none in the repo and gate
against the plain-numpy float64 oracle (tests/numpy_lbm.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest

import numpy_lbm
from lbm_tpu.obstacles import load_obstacles, num_non_obstacles_r
from lbm_tpu.params import load_params
from lbm_tpu.runner import make_simulate
from lbm_tpu.state import initial_state

from conftest import SCENES, golden

GRIDS = [
    ("128x128", 200),
    ("128x256", 200),
    ("256x256", 100),
    ("1024x1024", 30),
]


@pytest.mark.parametrize("grid,n", GRIDS)
def test_golden_prefix(grid, n):
    params = load_params(SCENES / f"input_{grid}.params")
    obstacles = load_obstacles(
        SCENES / f"obstacles_{grid}.dat", params.nx, params.ny
    )
    sim = make_simulate(params, kernel="reference", n_iters=n)
    cells0 = initial_state(params)
    _, av = sim(cells0, jnp.asarray(obstacles), num_non_obstacles_r(obstacles))
    sim_av = np.asarray(av)
    if grid in ("256x256", "1024x1024"):
        ref = golden(grid)["av_vels"][:n]
    else:
        _, ref = numpy_lbm.simulate(
            numpy_lbm.initial_state(params.nx, params.ny,
                                    float(params.density)),
            obstacles, float(params.density), float(params.accel),
            float(params.omega), n,
        )
    pct = 100.0 * np.abs((ref - sim_av) / ref)
    assert pct.max() < 0.1, (
        f"{grid}: max %diff {pct.max():.2e} at step {pct.argmax()}"
    )
