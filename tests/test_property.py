"""Property-based equivalence: random scenes through every execution
path must agree (global step, halo step, sharded, chunked). The
reference could only test golden scenes; random obstacle fields and
parameters exercise guard edges the goldens never hit."""

import numpy as np
import jax.numpy as jnp
import pytest

from lbm_tpu.obstacles import num_non_obstacles_r
from lbm_tpu.params import Params
from lbm_tpu.parallel.decomp import make_mesh
from lbm_tpu.runner import make_simulate, run_simulation
from lbm_tpu.state import initial_state


def random_scene(seed, ny=32, nx=64, density_frac=0.1):
    rng = np.random.default_rng(seed)
    # Random iteration counts (including odd/prime ones) exercise the
    # chunked runners' full chunks plus a shorter tail.
    params = Params(
        nx=nx, ny=ny, max_iters=int(rng.integers(9, 16)),
        reynolds_dim=int(rng.integers(1, 100)),
        density=float(rng.uniform(0.05, 0.5)),
        accel=float(rng.uniform(0.001, 0.02)),
        omega=float(rng.uniform(0.5, 1.95)),
    )
    obstacles = rng.random((ny, nx)) < density_frac
    # The forced row must keep at least one fluid cell for the scene to
    # be meaningful (and the normaliser finite).
    obstacles[ny - 2, nx // 2] = False
    return params, obstacles


@pytest.mark.parametrize(
    "seed",
    [pytest.param(0, marks=pytest.mark.slow), 1,
     pytest.param(2, marks=pytest.mark.slow),
     pytest.param(3, marks=pytest.mark.slow)],
)
def test_random_scene_all_paths_agree(seed):
    params, obstacles = random_scene(seed)
    inv = num_non_obstacles_r(obstacles)
    obs = jnp.asarray(obstacles)

    base_c, base_a = make_simulate(params, kernel="reference", n_iters=params.max_iters)(
        initial_state(params), obs, inv
    )
    base_c, base_a = np.asarray(base_c), np.asarray(base_a)
    assert np.isfinite(base_c).all() and np.isfinite(base_a).all()

    chunked = run_simulation(params, obstacles, chunk_iters=4)
    np.testing.assert_array_equal(base_c, chunked.cells)
    np.testing.assert_allclose(base_a, chunked.av_vels, rtol=1e-6)

    shard = run_simulation(params, obstacles, kernel="reference",
                           mesh=make_mesh(4))
    np.testing.assert_array_equal(base_c, shard.cells[..., :, :])
    np.testing.assert_allclose(base_a, shard.av_vels[:params.max_iters], rtol=2e-5)


@pytest.mark.parametrize("seed", [7, 8])
def test_random_wide_scene_sharded(seed):
    """Wide random scenes (nx = 8 ny) row-sharded over 8 devices: two
    rows per shard, so every row's halo crosses a device seam."""
    params, obstacles = random_scene(seed, ny=16, nx=128)
    base = run_simulation(params, obstacles)
    shard = run_simulation(params, obstacles, mesh=make_mesh(8))
    np.testing.assert_array_equal(base.cells, shard.cells)
    np.testing.assert_allclose(base.av_vels, shard.av_vels, rtol=2e-5)


def test_mass_conserved_with_forcing():
    """accelerate_flow adds w1+2*w2 east and removes the same west — net
    mass change is exactly zero, so total density is conserved across
    full steps including the forcing (d2q9-bgk.c:127-128)."""
    from lbm_tpu.observables import total_density

    params, obstacles = random_scene(42)
    inv = num_non_obstacles_r(obstacles)
    obs = jnp.asarray(obstacles)
    c0 = initial_state(params)
    before = float(total_density(c0))
    cells, _ = make_simulate(params, kernel="reference", n_iters=params.max_iters)(c0, obs, inv)
    after = float(total_density(cells))
    # Conservation is exact in real arithmetic; f32 rounding drifts a few
    # 1e-6 relative per step on a far-from-equilibrium random state (the
    # reference's f32 build drifts identically).
    assert np.isclose(before, after, rtol=1e-4)
