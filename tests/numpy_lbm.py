"""A plain-numpy D2Q9 BGK timestep, written from the reference C code
(d2q9-bgk.c:235-339) and independent of ``lbm_tpu.ops``: the test oracle
for the XLA step at arbitrary geometries, in float64.

Speeds (d2q9-bgk.c:7-13)::

    6 2 5
     \\|/
    3-0-1
     /|\\
    7 4 8
"""

import numpy as np

CX = np.array([0, 1, 0, -1, 0, 1, -1, -1, 1])
CY = np.array([0, 0, 1, 0, -1, 1, 1, -1, -1])
OPP = np.array([0, 3, 4, 1, 2, 7, 8, 5, 6])
W = np.array([4 / 9] + [1 / 9] * 4 + [1 / 36] * 4)


def accelerate(cells, obstacles, density, accel):
    """Forcing on row ny-2 where the west-going speeds stay positive."""
    cells = np.array(cells, dtype=np.float64)
    w1, w2 = density * accel / 9.0, density * accel / 36.0
    jj = cells.shape[1] - 2
    row = cells[:, jj, :]
    ok = (~obstacles[jj]) & (row[3] - w1 > 0) & (row[6] - w2 > 0) \
        & (row[7] - w2 > 0)
    for k, dw in ((1, w1), (5, w2), (8, w2), (3, -w1), (6, -w2), (7, -w2)):
        row[k] = np.where(ok, row[k] + dw, row[k])
    return cells


def collide_stream(cells, obstacles, omega):
    """Pull streaming, bounce-back at obstacles, BGK relaxation elsewhere.
    Returns ``(new_cells, tot_u)`` with tot_u the sum of |u| over fluid
    cells of the streamed (pre-collision) state."""
    tmp = np.stack([
        np.roll(cells[k], (CY[k], CX[k]), axis=(0, 1)) for k in range(9)
    ])
    rho = tmp.sum(axis=0)
    u_x = (tmp[1] + tmp[5] + tmp[8] - tmp[3] - tmp[6] - tmp[7]) / rho
    u_y = (tmp[2] + tmp[5] + tmp[6] - tmp[4] - tmp[7] - tmp[8]) / rho
    u_sq = u_x ** 2 + u_y ** 2
    new = np.empty_like(tmp)
    for k in range(9):
        cu = CX[k] * u_x + CY[k] * u_y
        feq = W[k] * rho * (1 + 3 * cu + 4.5 * cu ** 2 - 1.5 * u_sq)
        relaxed = tmp[k] + omega * (feq - tmp[k])
        new[k] = np.where(obstacles, tmp[OPP[k]], relaxed)
    tot_u = np.sqrt(u_sq)[~obstacles].sum()
    return new, tot_u


def simulate(cells, obstacles, density, accel, omega, iters):
    """``iters`` steps; returns ``(cells, av_vels)`` with av_vels the
    per-step mean |u| over fluid cells."""
    cells = np.array(cells, dtype=np.float64)
    n_fluid = int((~obstacles).sum())
    av = np.empty(iters)
    for t in range(iters):
        cells = accelerate(cells, obstacles, density, accel)
        cells, tot = collide_stream(cells, obstacles, omega)
        av[t] = tot / n_fluid
    return cells, av


def initial_state(nx, ny, density):
    return np.broadcast_to(
        (density * W)[:, None, None], (9, ny, nx)
    ).astype(np.float64)
