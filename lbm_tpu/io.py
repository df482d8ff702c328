"""Result I/O: ``final_state.dat`` / ``av_vels.dat`` writers in the
reference's exact byte formats (d2q9-bgk.c:698-752) and a golden-output
comparator with check/check.py's semantics (check/check.py:57-151).

The writers prefer the native C extension (:mod:`lbm_tpu._native`) when it
is built — formatting 1M–16M ``%.12E`` lines in pure Python is the
collate-phase bottleneck at large grids — and fall back to NumPy/Python.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from lbm_tpu.params import Params

try:  # optional fast path, built by `make native`
    from lbm_tpu import _native  # type: ignore
except ImportError:  # pragma: no cover - exercised when ext not built
    _native = None

FINAL_STATE_FILE = "final_state.dat"
AV_VELS_FILE = "av_vels.dat"


def final_state_fields(
    params: Params, cells: np.ndarray, obstacles: np.ndarray
):
    """Per-cell (u_x, u_y, |u|, pressure) as written by write_values
    (d2q9-bgk.c:710-739): obstacle cells get u=0 and pressure=density/3;
    fluid cells get u from the distributions and pressure=rho/3.
    """
    cells = np.asarray(cells)
    if cells.dtype not in (np.float32, np.float64):
        cells = cells.astype(np.float32)
    d = cells.dtype.type
    c_sq = d(1.0) / d(3.0)
    obstacles = np.asarray(obstacles, dtype=bool)
    rho = (
        cells[0] + cells[1] + cells[2] + cells[3] + cells[4]
        + cells[5] + cells[6] + cells[7] + cells[8]
    )
    # Obstacle cells may carry zero density in hand-built states; the
    # quotients there are masked to zero below, so silence the 0/0.
    with np.errstate(invalid="ignore", divide="ignore"):
        u_x = (cells[1] + cells[5] + cells[8]
               - (cells[3] + cells[6] + cells[7])) / rho
        u_y = (cells[2] + cells[5] + cells[6]
               - (cells[4] + cells[7] + cells[8])) / rho
    u = np.sqrt(u_x * u_x + u_y * u_y, dtype=cells.dtype)
    pressure = rho * c_sq
    zero = d(0.0)
    u_x = np.where(obstacles, zero, u_x)
    u_y = np.where(obstacles, zero, u_y)
    u = np.where(obstacles, zero, u)
    pressure = np.where(obstacles, d(params.density) * c_sq, pressure)
    return u_x, u_y, u, pressure


def write_final_state(
    path: str | Path,
    params: Params,
    cells: np.ndarray,
    obstacles: np.ndarray,
) -> None:
    """Write ``final_state.dat``: ``ii jj u_x u_y |u| pressure obstacle``
    with %.12E floats, row-major over (jj, ii) (d2q9-bgk.c:710-741).
    """
    u_x, u_y, u, pressure = final_state_fields(params, cells, obstacles)
    obs_int = np.asarray(obstacles, dtype=np.int32)
    if _native is not None and u.dtype == np.float32:
        _native.write_final_state(
            str(path),
            np.ascontiguousarray(u_x),
            np.ascontiguousarray(u_y),
            np.ascontiguousarray(u),
            np.ascontiguousarray(pressure),
            np.ascontiguousarray(obs_int),
        )
        return
    ny, nx = u.shape
    with open(path, "w") as fh:
        lines = []
        for jj in range(ny):
            row_ux, row_uy, row_u, row_p, row_o = (
                u_x[jj], u_y[jj], u[jj], pressure[jj], obs_int[jj]
            )
            for ii in range(nx):
                lines.append(
                    "%d %d %.12E %.12E %.12E %.12E %d\n"
                    % (ii, jj, row_ux[ii], row_uy[ii], row_u[ii], row_p[ii], row_o[ii])
                )
            if len(lines) >= 65536:
                fh.write("".join(lines))
                lines = []
        fh.write("".join(lines))


def write_av_vels(path: str | Path, av_vels: np.ndarray) -> None:
    """Write ``av_vels.dat``: one ``tt:\\t%.12E`` line per step
    (d2q9-bgk.c:744-749)."""
    av_vels = np.asarray(av_vels)
    if av_vels.dtype not in (np.float32, np.float64):
        av_vels = av_vels.astype(np.float32)
    if _native is not None and av_vels.dtype == np.float32:
        _native.write_av_vels(str(path), np.ascontiguousarray(av_vels))
        return
    with open(path, "w") as fh:
        fh.write(
            "".join(
                "%d:\t%.12E\n" % (tt, v) for tt, v in enumerate(av_vels)
            )
        )


# ---------------------------------------------------------------------------
# Golden-output comparison (check/check.py semantics)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FileDiff:
    """Diff summary for one file, matching check.py's get_diff_values
    (check/check.py:83-99). ``tolerance`` is the max-%-diff gate the file
    is judged against (check.py's --tolerance, default 1%)."""

    total: float
    max_diff: float
    max_diff_pcnt: float
    max_diff_index: int
    sim_val: float
    ref_val: float
    tolerance: float = 1.0

    @property
    def failed(self) -> bool:
        return (
            not np.isfinite(self.max_diff_pcnt)
            or abs(self.max_diff_pcnt) > self.tolerance
        )


@dataclasses.dataclass
class GoldenResult:
    av_vels: FileDiff
    final_state: FileDiff

    @property
    def tolerance(self) -> float:
        # Derived, not stored: both diffs always share one gate, and a
        # separately stored copy could drift from the one that judged.
        return self.av_vels.tolerance

    @property
    def passed(self) -> bool:
        return not (self.av_vels.failed or self.final_state.failed)


def load_av_vels(path: str | Path) -> np.ndarray:
    """Column 1 of av_vels.dat (check/check.py:60)."""
    return np.atleast_1d(np.loadtxt(path, usecols=[1]))


def load_final_state(path: str | Path) -> np.ndarray:
    """Columns 0,1,5 of final_state.dat — coords + pressure
    (check/check.py:61). Note the checker compares *pressure*, column 5."""
    return np.loadtxt(path, usecols=[0, 1, 5], ndmin=2)


def _diff(ref: np.ndarray, sim: np.ndarray, tolerance: float = 1.0) -> FileDiff:
    diff = ref - sim
    with np.errstate(divide="ignore", invalid="ignore"):
        diff_pcnt = 100.0 * (diff / (ref - diff))
    idx = int(np.argmax(np.abs(diff_pcnt)))
    return FileDiff(
        total=float(np.sum(np.abs(diff))),
        max_diff=float(diff[idx]),
        max_diff_pcnt=float(diff_pcnt[idx]),
        max_diff_index=idx,
        sim_val=float(sim[idx]),
        ref_val=float(ref[idx]),
        tolerance=tolerance,
    )


def compare_golden_arrays(
    av_sim: np.ndarray,
    fs_sim: np.ndarray,
    av_ref: np.ndarray,
    fs_ref: np.ndarray,
    tolerance: float = 1.0,
) -> GoldenResult:
    """Array-level form of :func:`compare_golden` (inputs as loaded by
    load_av_vels / load_final_state)."""
    if np.any(fs_ref[:, 0:2] != fs_sim[:, 0:2]):
        raise ValueError("Final state files coordinates were not the same")
    if av_ref.size != av_sim.size:
        raise ValueError("Different number of steps in av_vels files")
    return GoldenResult(
        av_vels=_diff(av_ref, av_sim, tolerance),
        final_state=_diff(fs_ref[:, 2], fs_sim[:, 2], tolerance),
    )


def compare_golden_npz(
    av_vels_file: str | Path,
    final_state_file: str | Path,
    golden_npz: str | Path,
    tolerance: float = 1.0,
) -> GoldenResult:
    """check.py's comparison against a repo-owned float64 golden
    (``goldens/*.f64.npz``): av_vels against its ``av_vels``, and
    final_state pressure (column 5, the column check.py compares)
    against its row-major ``pressure`` field."""
    with np.load(golden_npz) as z:
        ref_av, ref_p = z["av_vels"], z["pressure"]
    av_sim = load_av_vels(av_vels_file)
    fs_sim = load_final_state(final_state_file)
    if av_sim.size != ref_av.size:
        raise ValueError("Different number of steps in av_vels files")
    if fs_sim.shape[0] != ref_p.size:
        raise ValueError("Different number of cells in final_state files")
    return GoldenResult(
        av_vels=_diff(ref_av, av_sim, tolerance),
        final_state=_diff(ref_p, fs_sim[:, 2], tolerance),
    )


def compare_golden(
    av_vels_file: str | Path,
    final_state_file: str | Path,
    ref_av_vels_file: str | Path,
    ref_final_state_file: str | Path,
    tolerance: float = 1.0,
) -> GoldenResult:
    """Compare run outputs against golden references exactly as
    check/check.py does: coordinate order and step count must match, then
    max percentage diff of av_vels (col 1) and final_state pressure (col 5)
    must be ≤ tolerance (default 1%).
    """
    return compare_golden_arrays(
        load_av_vels(av_vels_file),
        load_final_state(final_state_file),
        load_av_vels(ref_av_vels_file),
        load_final_state(ref_final_state_file),
        tolerance=tolerance,
    )
