"""The XLA step against the independent plain-numpy timestep
(tests/numpy_lbm.py) at awkward geometries: odd, non-square, wide and
tall lattices, scattered obstacles, obstacles on the forced row."""

import numpy as np
import jax.numpy as jnp
import pytest

import numpy_lbm
from lbm_tpu.obstacles import generate_obstacles, num_non_obstacles_r
from lbm_tpu.ops.reference import fused_step
from lbm_tpu.params import Params
from lbm_tpu.runner import make_simulate
from lbm_tpu.state import D2Q9, initial_state


def _mask(kind, nx, ny, seed):
    rng = np.random.default_rng(seed)
    if kind == "walls":
        mask = generate_obstacles(nx, ny)
    elif kind == "scattered":
        mask = rng.random((ny, nx)) < 0.1
    elif kind == "walls+scattered":
        mask = generate_obstacles(nx, ny) | (rng.random((ny, nx)) < 0.1)
    else:  # "forced-row": obstacles scattered on row ny-2 itself
        mask = generate_obstacles(nx, ny)
        mask[ny - 2] |= rng.random(nx) < 0.3
    mask[ny - 2, nx // 2] = False
    return mask


# (nx, ny, mask kind): odd sizes, non-square both ways, wide and tall.
GEOMETRIES = [
    (13, 17, "walls"),
    (17, 13, "scattered"),
    (64, 16, "walls+scattered"),
    (16, 64, "forced-row"),
    (128, 8, "walls"),
    (8, 128, "scattered"),
    (33, 31, "forced-row"),
    (5, 7, "walls+scattered"),
]


def test_numpy_speeds_match_lattice_constants():
    np.testing.assert_array_equal(numpy_lbm.CX, D2Q9.CX)
    np.testing.assert_array_equal(numpy_lbm.CY, D2Q9.CY)
    np.testing.assert_array_equal(numpy_lbm.OPP, D2Q9.OPP)
    np.testing.assert_allclose(numpy_lbm.W, D2Q9.W)


@pytest.mark.parametrize("paired", ["1", "0"])
@pytest.mark.parametrize("nx,ny,kind", GEOMETRIES)
def test_one_step_matches_numpy(nx, ny, kind, paired, monkeypatch):
    """One step from a random state, both f32 associations."""
    monkeypatch.setenv("LBM_PAIRED_EQ", paired)
    rng = np.random.default_rng(nx * 100 + ny)
    cells = rng.uniform(0.01, 0.2, (9, ny, nx)).astype(np.float32)
    mask = _mask(kind, nx, ny, seed=ny)
    density, accel, omega = 0.1, 0.005, 1.85
    p = Params(nx=nx, ny=ny, max_iters=1, reynolds_dim=10,
               density=density, accel=accel, omega=omega)
    got, tot = fused_step(jnp.asarray(cells), jnp.asarray(mask),
                          p.accel_w1, p.accel_w2, p.omega)
    want = numpy_lbm.accelerate(cells, mask, float(p.density),
                                float(p.accel))
    want, want_tot = numpy_lbm.collide_stream(want, mask, float(p.omega))
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-5, atol=2e-7)
    np.testing.assert_allclose(float(tot), want_tot, rtol=2e-5)


@pytest.mark.parametrize("nx,ny,kind", GEOMETRIES[:4])
def test_trajectory_matches_numpy(nx, ny, kind):
    """20 whole-program steps from the equilibrium start: av_vels and the
    final state track the float64 numpy oracle."""
    iters = 20
    p = Params(nx=nx, ny=ny, max_iters=iters, reynolds_dim=10,
               density=0.1, accel=0.005, omega=1.85)
    mask = _mask(kind, nx, ny, seed=nx)
    cells, av = make_simulate(p)(
        initial_state(p), jnp.asarray(mask), num_non_obstacles_r(mask)
    )
    want_cells, want_av = numpy_lbm.simulate(
        numpy_lbm.initial_state(nx, ny, float(p.density)), mask,
        float(p.density), float(p.accel), float(p.omega), iters,
    )
    np.testing.assert_allclose(np.asarray(av), want_av, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(cells), want_cells, rtol=1e-4,
                               atol=1e-7)
