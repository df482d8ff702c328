"""Writer byte-format and golden-comparator tests."""

import numpy as np
import pytest

from lbm_tpu import io as lio
from lbm_tpu.params import Params
from lbm_tpu.state import initial_state_np

from conftest import GOLDENS, golden


def test_av_vels_format(tmp_path):
    path = tmp_path / "av_vels.dat"
    lio.write_av_vels(path, np.array([1.094269153342e-05, 2.5e-4], dtype=np.float32))
    lines = path.read_text().splitlines()
    # The value round-trips through f32 storage then prints promoted to
    # double, exactly like the reference's float av_vels (d2q9-bgk.c:747).
    assert lines[0] == "0:\t%.12E" % np.float32(1.094269153342e-05)
    assert lines[1].startswith("1:\t2.5")
    # C printf %.12E: 12 fractional digits, 2+-digit exponent.
    mantissa, exp = lines[1].split("\t")[1].split("E")
    assert len(mantissa.split(".")[1]) == 12
    assert len(exp) == 3  # sign + 2 digits


def test_final_state_format_obstacle_row(tmp_path):
    """Obstacle cells: u=0, pressure=density/3 — and the line layout
    matches the golden file's byte format (d2q9-bgk.c:739)."""
    p = Params(nx=4, ny=2, max_iters=1, reynolds_dim=1,
               density=0.1, accel=0.005, omega=1.85)
    cells = initial_state_np(p)
    obstacles = np.zeros((2, 4), dtype=bool)
    obstacles[0, :] = True
    path = tmp_path / "final_state.dat"
    lio.write_final_state(path, p, cells, obstacles)
    lines = path.read_text().splitlines()
    assert len(lines) == 8
    # f32 density*1/3 promoted to double, like the reference's float print.
    press = np.float32(0.1) * (np.float32(1.0) / np.float32(3.0))
    expected = "0 0 0.000000000000E+00 0.000000000000E+00 0.000000000000E+00 %.12E 1" % press
    assert lines[0] == expected
    # Fluid row: equilibrium at rest -> u = 0, pressure = rho/3.
    cols = lines[4].split()
    assert cols[0] == "0" and cols[1] == "1" and cols[6] == "0"
    assert float(cols[4]) == 0.0
    assert np.isclose(float(cols[5]), 0.1 / 3, rtol=1e-5)


def test_fields_match_observables():
    p = Params(nx=8, ny=4, max_iters=1, reynolds_dim=1,
               density=0.1, accel=0.005, omega=1.85)
    rng = np.random.default_rng(3)
    cells = rng.uniform(0.01, 0.2, size=(9, 4, 8)).astype(np.float32)
    obstacles = np.zeros((4, 8), dtype=bool)
    u_x, u_y, u, pressure = lio.final_state_fields(p, cells, obstacles)
    rho = cells.sum(axis=0)
    np.testing.assert_allclose(pressure, rho / 3, rtol=1e-5)
    np.testing.assert_allclose(u, np.hypot(u_x, u_y), rtol=1e-5)


def _golden_dat_files(tmp_path, scene, scale=1.0):
    """Write a golden's av_vels and pressure as the reference's .dat
    files (other final_state columns zero), pressure scaled by
    ``scale``."""
    g = golden(scene)
    nx, ny = (int(v) for v in scene.split("x"))
    av = tmp_path / "av.dat"
    fs = tmp_path / "fs.dat"
    av.write_text("".join(f"{t}:\t{v:.12E}\n"
                          for t, v in enumerate(g["av_vels"])))
    jj, ii = np.divmod(np.arange(nx * ny), nx)
    fs.write_text("".join(
        f"{i} {j} 0 0 0 {p * scale:.12E} 0\n"
        for i, j, p in zip(ii, jj, g["pressure"])))
    return av, fs


def test_compare_golden_self(tmp_path):
    """The comparator passes when ref == sim (identity check)."""
    av, fs = _golden_dat_files(tmp_path, "256x256")
    res = lio.compare_golden(av, fs, av, fs)
    assert res.passed
    assert res.av_vels.total == 0.0
    assert res.final_state.total == 0.0


@pytest.mark.parametrize("scale,passed", [(1.0, True), (1.002, True),
                                          (1.02, False)])
def test_compare_golden_npz(tmp_path, scale, passed):
    """compare_golden_npz applies check.py's formula to the .dat files
    against the float64 golden arrays: 0.2% off passes the 1% gate, 2%
    off fails it, and the max %diff it reports is the offset."""
    av, fs = _golden_dat_files(tmp_path, "256x256", scale=scale)
    res = lio.compare_golden_npz(
        av, fs, GOLDENS / "256x256.final_state.f64.npz")
    assert res.passed is passed
    assert abs(res.av_vels.max_diff_pcnt) < 1e-9
    want = 100 * (1 - scale) / scale
    assert abs(res.final_state.max_diff_pcnt - want) < 1e-6


def test_compare_golden_detects_mismatch(tmp_path):
    av = tmp_path / "a.dat"
    fs = tmp_path / "f.dat"
    av.write_text("0:\t1.000000000000E-02\n")
    fs.write_text("0 0 0.0E+00 0.0E+00 0.0E+00 1.000000000000E-02 0\n")
    av2 = tmp_path / "a2.dat"
    fs2 = tmp_path / "f2.dat"
    av2.write_text("0:\t1.100000000000E-02\n")  # 10% off
    fs2.write_text("0 0 0.0E+00 0.0E+00 0.0E+00 1.000000000000E-02 0\n")
    res = lio.compare_golden(av2, fs2, av, fs)
    assert not res.passed
    assert abs(res.av_vels.max_diff_pcnt) > 5.0

    # Mismatched coordinates must raise.
    fs3 = tmp_path / "f3.dat"
    fs3.write_text("1 0 0.0E+00 0.0E+00 0.0E+00 1.000000000000E-02 0\n")
    with pytest.raises(ValueError, match="coordinates"):
        lio.compare_golden(av, fs3, av, fs)


def test_filediff_failed_applies_tolerance():
    """FileDiff.failed must gate on the tolerance, not just finiteness
    (a 50%-off file is failed even though its %diff is finite)."""
    from lbm_tpu.io import compare_golden_arrays

    av_ref = np.array([1.0, 2.0])
    fs = np.array([[0.0, 0.0, 1.0], [1.0, 0.0, 2.0]])
    res = compare_golden_arrays(av_ref * 1.5, fs, av_ref, fs)
    assert res.av_vels.failed and not res.final_state.failed
    assert not res.passed
    ok = compare_golden_arrays(av_ref * 1.005, fs, av_ref, fs)
    assert not ok.av_vels.failed and ok.passed
    loose = compare_golden_arrays(av_ref * 1.5, fs, av_ref, fs, tolerance=60.0)
    assert not loose.av_vels.failed and loose.passed
