"""Physics tests for the jnp fused step: conservation, bounce-back,
acceleration guard, and golden-trajectory prefix agreement."""

import numpy as np
import jax.numpy as jnp
import pytest

from lbm_tpu.obstacles import num_non_obstacles_r
from lbm_tpu.ops.reference import accelerate_flow, collide_stream, fused_step
from lbm_tpu.params import Params
from lbm_tpu.state import initial_state
from lbm_tpu.runner import make_simulate, run_simulation

from conftest import golden


def small_params(**kw):
    defaults = dict(nx=16, ny=16, max_iters=10, reynolds_dim=10,
                    density=0.1, accel=0.005, omega=1.85)
    defaults.update(kw)
    return Params(**defaults)


def test_density_conservation():
    """Total density is conserved by collide-stream (d2q9-bgk.c:127-128)."""
    p = small_params()
    rng = np.random.default_rng(0)
    cells = jnp.asarray(
        rng.uniform(0.01, 0.2, size=(9, p.ny, p.nx)).astype(np.float32)
    )
    obstacles = jnp.zeros((p.ny, p.nx), dtype=bool)
    before = float(jnp.sum(cells, dtype=jnp.float64 if cells.dtype == jnp.float64 else jnp.float32))
    new, _ = collide_stream(cells, obstacles, p.omega)
    after = float(jnp.sum(new))
    assert np.isclose(before, after, rtol=1e-5)


def test_bounceback_reverses_at_obstacles():
    """At an obstacle cell, each outgoing speed equals the streamed-in
    opposite speed (d2q9-bgk.c:325-333)."""
    p = small_params()
    rng = np.random.default_rng(1)
    cells = jnp.asarray(
        rng.uniform(0.01, 0.2, size=(9, p.ny, p.nx)).astype(np.float32)
    )
    obstacles = np.zeros((p.ny, p.nx), dtype=bool)
    obstacles[5, 7] = True
    new, _ = collide_stream(cells, jnp.asarray(obstacles), p.omega)
    # Streamed value for speed k at (jj, ii) comes from (jj-cy, ii-cx).
    from lbm_tpu.state import D2Q9

    for k in range(9):
        src_j = (5 - D2Q9.CY[int(D2Q9.OPP[k])]) % p.ny
        src_i = (7 - D2Q9.CX[int(D2Q9.OPP[k])]) % p.nx
        expected = cells[int(D2Q9.OPP[k]), src_j, src_i]
        assert new[k, 5, 7] == expected


def test_streaming_periodic_wrap():
    """A pulse streams by one lattice vector per step with periodic wrap."""
    p = small_params(omega=0.0)  # omega=0: no relaxation, pure streaming
    cells = np.zeros((9, p.ny, p.nx), dtype=np.float32)
    # Put mass only in speed 1 (east) at the right edge; avoid rho=0
    # elsewhere by adding a uniform background in speed 0.
    cells[0] = 0.1
    cells[1, 3, p.nx - 1] = 0.5
    obstacles = jnp.zeros((p.ny, p.nx), dtype=bool)
    new, _ = collide_stream(jnp.asarray(cells), obstacles, np.float32(0.0))
    # speed 1 mass moved east with wraparound to x=0
    assert np.isclose(float(new[1, 3, 0]), 0.5)
    assert float(new[1, 3, p.nx - 1]) == 0.0


def test_accelerate_flow_guard():
    """Forcing applies only where west speeds stay positive and cell is
    fluid (d2q9-bgk.c:250-253)."""
    p = small_params()
    cells = np.asarray(initial_state(p)).copy()
    row = p.ny - 2
    # Make one column's speed 3 too small for the guard.
    cells[3, row, 4] = 1e-6
    obstacles = np.zeros((p.ny, p.nx), dtype=bool)
    obstacles[row, 9] = True
    out = np.asarray(
        accelerate_flow(jnp.asarray(cells), jnp.asarray(obstacles),
                        p.accel_w1, p.accel_w2)
    )
    w1, w2 = p.accel_w1, p.accel_w2
    # Normal column 2: accelerated.
    assert np.isclose(out[1, row, 2], cells[1, row, 2] + w1)
    assert np.isclose(out[3, row, 2], cells[3, row, 2] - w1)
    assert np.isclose(out[5, row, 2], cells[5, row, 2] + w2)
    assert np.isclose(out[6, row, 2], cells[6, row, 2] - w2)
    # Guarded column 4 and obstacle column 9: unchanged.
    np.testing.assert_array_equal(out[:, row, 4], cells[:, row, 4])
    np.testing.assert_array_equal(out[:, row, 9], cells[:, row, 9])
    # Other rows untouched.
    np.testing.assert_array_equal(out[:, row + 1, :], cells[:, row + 1, :])
    np.testing.assert_array_equal(out[:, row - 1, :], cells[:, row - 1, :])


@pytest.mark.parametrize("paired", ["0", "1"])
@pytest.mark.parametrize("scene,n", [("256x256", 200), ("1024x1024", 100)])
def test_golden_prefix_both_associations(scene, n, paired, monkeypatch):
    """The first av_vels of a scene match its float64 golden trajectory
    under both f32 associations: the reference's term-by-term one (the
    default) and the paired equilibrium (LBM_PAIRED_EQ=1).

    av_vels[tt] depends only on steps 0..tt, so a prefix run checks the
    full per-step pipeline against goldens/<scene>.final_state.f64.npz.
    f32 tracks it to ~2e-2 % over this horizon (the reference
    association measured 1.5e-2 % at 256x256 and 2.1e-2 % at 1024x1024
    on the CPU) — far inside check.py's 1 % gate.
    """
    from lbm_tpu.obstacles import load_obstacles
    from lbm_tpu.params import load_params

    from conftest import SCENES

    monkeypatch.setenv("LBM_PAIRED_EQ", paired)
    params = load_params(SCENES / f"input_{scene}.params")
    obstacles = load_obstacles(SCENES / f"obstacles_{scene}.dat",
                               params.nx, params.ny)
    sim = make_simulate(params, kernel="reference", n_iters=n)
    _, av = sim(initial_state(params), jnp.asarray(obstacles),
                num_non_obstacles_r(obstacles))
    ref = golden(scene)["av_vels"][:n]
    pct = 100.0 * np.abs((ref - np.asarray(av)) / ref)
    assert pct.max() < 0.05, f"max %diff {pct.max():.2e} at {pct.argmax()}"


def test_run_simulation_result_types(params_128, obstacles_128):
    res = run_simulation(params_128, obstacles_128, kernel="reference", n_iters=5)
    assert res.cells.shape == (9, 128, 128)
    assert res.cells.dtype == np.float32
    assert res.av_vels.shape == (5,)
    assert np.isfinite(res.reynolds)
    assert set(res.timings) == {"init", "compute", "collate", "total"}


def test_float64_params_without_x64_raises():
    """Library calls with float64 params in a non-x64 process would
    silently compute f32 and relabel it — refuse instead (ADVICE r1)."""
    import jax
    import pytest as _pytest

    from lbm_tpu.runner import make_simulate

    assert not jax.config.jax_enable_x64  # test processes never enable it
    p = small_params(dtype=np.float64)
    with _pytest.raises(ValueError, match="x64"):
        make_simulate(p, kernel="reference")


@pytest.mark.parametrize("kernel", ["auto", "reference"])
def test_kernel_names_resolve_to_the_xla_step(kernel):
    """'auto' and 'reference' both name the XLA step, and both build the
    same program: identical trajectories."""
    from lbm_tpu.runner import resolve_kernel

    p = small_params()
    assert resolve_kernel(kernel, p) == "reference"
    obstacles = np.zeros((p.ny, p.nx), dtype=bool)
    obstacles[0] = obstacles[-1] = True
    a = run_simulation(p, obstacles, kernel=kernel)
    b = run_simulation(p, obstacles, kernel="auto")
    np.testing.assert_array_equal(a.cells, b.cells)


@pytest.mark.parametrize("kernel", ["pallas", "resident", ""])
def test_removed_kernels_are_refused(kernel):
    """The Pallas kernels are gone: any other name is a clear error from
    every builder, and the CLI's argument parser refuses it."""
    from lbm_tpu.cli import build_parser
    from lbm_tpu.runner import make_chunk, resolve_kernel

    p = small_params()
    for build in (lambda: resolve_kernel(kernel, p),
                  lambda: make_simulate(p, kernel=kernel),
                  lambda: make_chunk(p, kernel, 4)):
        with pytest.raises(ValueError, match="only kernel"):
            build()
    with pytest.raises(SystemExit):
        build_parser().parse_args(["a.params", "b.dat", "--kernel", kernel])
