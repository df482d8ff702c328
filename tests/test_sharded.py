"""Sharded-vs-unsharded equivalence on a virtual 8-device CPU mesh — the
answer to "test the decomposition without a cluster" (SURVEY.md §4)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lbm_tpu.obstacles import generate_obstacles
from lbm_tpu.ops.reference import (
    accelerate_flow,
    accelerate_flow_dynamic,
    collide_stream,
    collide_stream_halo,
)
from lbm_tpu.params import Params
from lbm_tpu.parallel.decomp import RowDecomposition, largest_divisor_leq, make_mesh
from lbm_tpu.runner import run_simulation


def small_params(**kw):
    defaults = dict(nx=32, ny=32, max_iters=20, reynolds_dim=10,
                    density=0.1, accel=0.005, omega=1.85)
    defaults.update(kw)
    return Params(**defaults)


def test_virtual_devices_present():
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"


def test_decomposition_facts():
    d = RowDecomposition(ny=128, n_shards=8)
    assert d.local_ny == 16
    assert d.owner_of_row(126) == 7
    assert d.local_index(126) == 14
    assert d.accel_row == 126
    with pytest.raises(ValueError, match="not divisible"):
        RowDecomposition(ny=10, n_shards=4)
    assert largest_divisor_leq(128, 6) == 4
    assert largest_divisor_leq(100, 8) == 5


def test_halo_kernel_matches_global():
    """collide_stream_halo with wrapped halo rows == global collide_stream."""
    p = small_params()
    rng = np.random.default_rng(7)
    cells = jnp.asarray(rng.uniform(0.01, 0.2, (9, p.ny, p.nx)).astype(np.float32))
    obstacles = jnp.asarray(generate_obstacles(p.nx, p.ny))
    ref_new, ref_tot = collide_stream(cells, obstacles, p.omega)
    new, tot = collide_stream_halo(
        cells, cells[:, -1:, :], cells[:, :1, :], obstacles, p.omega
    )
    np.testing.assert_array_equal(np.asarray(ref_new), np.asarray(new))
    assert np.isclose(float(ref_tot), float(tot), rtol=1e-6)


def test_halo_kernel_block_equivalence():
    """Stacking two half-blocks stepped with true halo rows reproduces the
    global step (the decomposition invariant behind the MPI design)."""
    p = small_params()
    rng = np.random.default_rng(8)
    cells = jnp.asarray(rng.uniform(0.01, 0.2, (9, p.ny, p.nx)).astype(np.float32))
    obstacles = jnp.asarray(generate_obstacles(p.nx, p.ny))
    h = p.ny // 2
    ref_new, _ = collide_stream(cells, obstacles, p.omega)
    lo, _ = collide_stream_halo(
        cells[:, :h], cells[:, -1:], cells[:, h : h + 1], obstacles[:h], p.omega
    )
    hi, _ = collide_stream_halo(
        cells[:, h:], cells[:, h - 1 : h], cells[:, :1], obstacles[h:], p.omega
    )
    np.testing.assert_array_equal(np.asarray(ref_new[:, :h]), np.asarray(lo))
    np.testing.assert_array_equal(np.asarray(ref_new[:, h:]), np.asarray(hi))


def test_accelerate_dynamic_matches_static():
    p = small_params()
    rng = np.random.default_rng(9)
    cells = jnp.asarray(rng.uniform(0.01, 0.2, (9, p.ny, p.nx)).astype(np.float32))
    obstacles = jnp.asarray(generate_obstacles(p.nx, p.ny))
    want = accelerate_flow(cells, obstacles, p.accel_w1, p.accel_w2)
    got = accelerate_flow_dynamic(
        cells, obstacles, p.accel_w1, p.accel_w2,
        jnp.int32(p.ny - 2), jnp.bool_(True),
    )
    np.testing.assert_array_equal(np.asarray(want), np.asarray(got))
    # Inactive: unchanged.
    same = accelerate_flow_dynamic(
        cells, obstacles, p.accel_w1, p.accel_w2,
        jnp.int32(5), jnp.bool_(False),
    )
    np.testing.assert_array_equal(np.asarray(cells), np.asarray(same))


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_trajectory_matches_unsharded(n_dev):
    """Full sharded simulation == unsharded, cells bit-exact, av_vels to
    reduction-order tolerance."""
    p = small_params(ny=64, nx=32, max_iters=30)
    obstacles = generate_obstacles(p.nx, p.ny)
    res_1 = run_simulation(p, obstacles, kernel="reference")
    mesh = make_mesh(n_dev)
    res_n = run_simulation(p, obstacles, kernel="reference", mesh=mesh)
    np.testing.assert_array_equal(res_1.cells, res_n.cells)
    np.testing.assert_allclose(res_1.av_vels, res_n.av_vels, rtol=2e-5)
    assert np.isclose(res_1.reynolds, res_n.reynolds, rtol=1e-5)


@pytest.mark.parametrize("kernel", ["reference", "auto"])
def test_sharded_accel_row_on_shard_boundary(kernel):
    """ny-2 is the bottom row of the top shard for ny=64/8-dev (local idx
    6 of 8)… exercise a config where the accelerated row is the shard's
    BOTTOM edge so the neighbour's halo must carry the accelerated
    values: ny=16 over 8 devices -> local_ny=2, row 14 = top shard's
    row 0. Both kernel names run the XLA step."""
    p = small_params(ny=16, nx=32, max_iters=25)
    obstacles = generate_obstacles(p.nx, p.ny)
    res_1 = run_simulation(p, obstacles, kernel="reference")
    res_8 = run_simulation(p, obstacles, kernel=kernel, mesh=make_mesh(8))
    np.testing.assert_array_equal(res_1.cells, res_8.cells)
    np.testing.assert_allclose(res_1.av_vels, res_8.av_vels, rtol=1e-4)


def test_sharded_f64_without_x64_raises():
    """The x64 guard must cover the sharded builders too, not just the
    single-device runner (review finding r2)."""
    import pytest as _pytest

    from lbm_tpu.parallel.halo import make_sharded_chunk, make_sharded_simulate

    p = small_params(ny=16, dtype=np.float64)
    mesh = make_mesh(2)
    with _pytest.raises(ValueError, match="x64"):
        make_sharded_simulate(p, mesh, kernel="reference")
    with _pytest.raises(ValueError, match="x64"):
        make_sharded_chunk(p, mesh, kernel="reference", chunk_iters=4)
    with _pytest.raises(ValueError, match="x64"):
        run_simulation(p, generate_obstacles(p.nx, p.ny),
                       kernel="reference", mesh=mesh)


class TestNonDivisorPadding:
    """Non-divisor device counts run via wall-shielded obstacle-row
    padding (halo.plan_row_padding / pad_scene, VERDICT r2 missing #1 —
    the reference's allocate_rows balanced any ny over any rank count,
    d2q9-bgk.c:483-492)."""

    def test_plan_and_exactness(self):
        from lbm_tpu.parallel.halo import pad_scene, plan_row_padding

        p = small_params(ny=46, nx=64, max_iters=12)
        obstacles = generate_obstacles(p.nx, p.ny)
        mesh = make_mesh(3)
        pad = plan_row_padding(p, obstacles, mesh)
        assert pad == 2
        pp, po = pad_scene(p, obstacles, pad)
        assert pp.ny == 48 and po.shape == (48, 64)
        assert po[:2].all(), "pad rows must be obstacles"
        # Divisible cases need no padding.
        assert plan_row_padding(
            small_params(ny=48, nx=64), generate_obstacles(64, 48),
            mesh) == 0

        base = run_simulation(p, obstacles, kernel="reference")
        got = run_simulation(p, obstacles, kernel="reference", mesh=mesh)
        assert got.cells.shape == base.cells.shape
        np.testing.assert_allclose(
            base.cells, got.cells, rtol=2e-5, atol=5e-8
        )
        np.testing.assert_allclose(base.av_vels, got.av_vels, rtol=1e-4)
        assert np.isclose(base.reynolds, got.reynolds, rtol=1e-4)

    def test_refuses_without_walls(self):
        """plan_row_padding (the WALL planner) refuses wall-less masks;
        the policy owner plan_padding_mode routes that case to wrap
        padding instead (TestResolveMesh)."""
        from lbm_tpu.parallel.halo import plan_padding_mode, plan_row_padding

        p = small_params(ny=46, nx=64)
        no_walls = np.zeros((p.ny, p.nx), dtype=bool)
        with pytest.raises(ValueError, match="wall rows"):
            plan_row_padding(p, no_walls, make_mesh(3))
        assert plan_padding_mode(p, no_walls, make_mesh(3)) == ("wrap", 2)
        walls = generate_obstacles(p.nx, p.ny)
        assert plan_padding_mode(p, walls, make_mesh(3)) == ("wall", 2)
        assert plan_padding_mode(
            small_params(ny=48, nx=64), no_walls[:1].repeat(48, 0),
            make_mesh(3)) == ("none", 0)

class TestResolveMesh:
    """halo.resolve_mesh — the CLI's device policy as a tested library
    contract: clamp to visible devices, keep non-divisor counts via
    wall-shielded padding (wall-bounded masks) or periodic wrap padding
    (wall-less masks), demote to the largest divisor of ny only when
    wrap padding cannot fit."""

    def test_walls_nondivisor_keeps_all_devices(self):
        from lbm_tpu.parallel.halo import resolve_mesh

        p = small_params(ny=46, nx=64)
        walls = generate_obstacles(p.nx, p.ny)
        mesh, notes = resolve_mesh(p, walls, 3)
        assert mesh is not None and mesh.shape["y"] == 3
        assert notes == []

    def test_wall_less_nondivisor_keeps_all_devices(self):
        """Wall-less non-divisor scenes run on ALL requested devices via
        wrap padding (the reference's allocate_rows balanced any
        (ny, size) pair)."""
        from lbm_tpu.parallel.halo import resolve_mesh

        p = small_params(ny=46, nx=64)
        no_walls = np.zeros((p.ny, p.nx), dtype=bool)
        mesh, notes = resolve_mesh(p, no_walls, 3)
        assert mesh is not None and mesh.shape["y"] == 3
        assert notes == []

    def test_wall_less_prime_ny_keeps_all_devices(self):
        """Even prime ny shards on every device: ny=47 over 4 pads one
        wrap row to 48."""
        from lbm_tpu.parallel.halo import resolve_mesh

        p = small_params(ny=47, nx=64)
        no_walls = np.zeros((p.ny, p.nx), dtype=bool)
        mesh, notes = resolve_mesh(p, no_walls, 4)
        assert mesh is not None and mesh.shape["y"] == 4
        assert notes == []

    def test_wall_less_tiny_ny_demotes_to_divisor(self):
        """ny barely above the device count leaves no headroom for the
        pad inside shard 0 (pad > local_ny-1): divisor fallback."""
        from lbm_tpu.parallel.halo import resolve_mesh

        p = small_params(ny=9, nx=64)
        no_walls = np.zeros((p.ny, p.nx), dtype=bool)
        mesh, notes = resolve_mesh(p, no_walls, 8)
        assert mesh is not None and mesh.shape["y"] == 3
        assert any("divisor fallback" in n for n in notes)

    def test_clamps_to_visible_devices(self):
        from lbm_tpu.parallel.halo import resolve_mesh

        p = small_params(ny=64, nx=64)
        walls = generate_obstacles(p.nx, p.ny)
        mesh, notes = resolve_mesh(p, walls, 64)
        assert mesh is not None and mesh.shape["y"] == 8
        assert any("8 devices" in n and "visible" in n for n in notes)

    def test_wrap_trajectory_bit_exact(self):
        """Wall-less non-divisor sharding is BIT-EXACT, not approximate:
        the wrap discipline (halo._ReferenceShardImpl) refreshes the one
        pad row a real row pulls from with the true global last row each
        step, so every real cell sees exactly the unpadded periodic
        lattice. Scattered (non-wall) obstacles exercise bounce-back
        across the wrap seam."""
        rng = np.random.default_rng(5)
        p = small_params(ny=46, nx=64, max_iters=12)
        no_walls = rng.random((p.ny, p.nx)) < 0.08
        no_walls[p.ny - 2, 7] = False  # keep fluid on the forced row
        base = run_simulation(p, no_walls, kernel="reference")
        got = run_simulation(p, no_walls, kernel="reference",
                             mesh=make_mesh(3))
        assert got.cells.shape == base.cells.shape
        np.testing.assert_array_equal(base.cells, got.cells)
        np.testing.assert_allclose(base.av_vels, got.av_vels, rtol=2e-5)
        assert np.isclose(base.reynolds, got.reynolds, rtol=1e-5)

    def test_wrap_pad_fills_shard0(self):
        """Boundary case pad == local_ny-1 (ny=36 over 8: pad 4, local 5;
        shard 0 has ONE real row, which is simultaneously its top row,
        its wrap bottom-send, and the row the refreshed pad row feeds)."""
        p = small_params(ny=36, nx=32, max_iters=10)
        no_walls = np.zeros((p.ny, p.nx), dtype=bool)
        base = run_simulation(p, no_walls, kernel="reference")
        got = run_simulation(p, no_walls, kernel="reference",
                             mesh=make_mesh(8))
        np.testing.assert_array_equal(base.cells, got.cells)
        np.testing.assert_allclose(base.av_vels, got.av_vels, rtol=2e-5)

    def test_wrap_chunked_and_debug_paths(self, capsys):
        """The wrap discipline reaches the chunked runner
        (make_sharded_chunk) and the --debug per-step path too — same
        bit-exact contract."""
        p = small_params(ny=46, nx=32, max_iters=9)
        no_walls = np.zeros((p.ny, p.nx), dtype=bool)
        base = run_simulation(p, no_walls, kernel="reference")
        chunked = run_simulation(p, no_walls, kernel="reference",
                                 mesh=make_mesh(3), chunk_iters=4)
        np.testing.assert_array_equal(base.cells, chunked.cells)
        dbg = run_simulation(p, no_walls, kernel="reference",
                             mesh=make_mesh(3), debug=True)
        capsys.readouterr()  # the reference block is not under test here
        np.testing.assert_array_equal(base.cells, dbg.cells)
        np.testing.assert_allclose(base.av_vels, dbg.av_vels, rtol=2e-5)
