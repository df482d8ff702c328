"""The XLA step: the per-timestep ops in plain ``jax.numpy``/``lax``.

This is the solver's one kernel, left to XLA's fusion, and the semantic
reference for the sharded path: pull-streaming + bounce-back + BGK
collision + the per-step velocity reduction, fused in one pass exactly
like the reference's ``timestep`` (d2q9-bgk.c:268-339), preceded by
``accelerate_flow`` forcing on global row ny-2 (d2q9-bgk.c:235-266;
unambiguous serial form go/d2q9-bgk.go:127-143).

Two streaming variants share the BGK math:

- :func:`collide_stream` — global lattice, periodic in both axes
  (single-device path);
- :func:`collide_stream_halo` — local row block with explicit one-row
  south/north halos and periodic x (the per-shard kernel under
  ``shard_map``, mirroring the reference's +2-halo-row local grids,
  d2q9-bgk.c:546).

Float32 trajectories track the float64 golden data far inside check.py's
1 % tolerance; float64 reproduces it to ~1e-10 %.
"""

from __future__ import annotations

import os

import numpy as np
import jax.numpy as jnp
from jax import lax

from lbm_tpu.state import D2Q9


def _paired_eq_enabled() -> bool:
    """Opposite-speed paired equilibrium (feq± = even ± odd): ~20% fewer
    arithmetic ops per cell than the reference's per-speed expansion, at
    the cost of a different (but algebraically equal) f32 association.
    Off by default: on the H100 the step is bound by memory traffic, not
    arithmetic, and the paired association drifts further from float64
    (16384x1024 x 2000 steps: 0.39% max av_vels diff against 0.19% for
    the reference association, over the 0.3% drift budget —
    docs/PERF.md). LBM_PAIRED_EQ=1 opts in. Float64 always keeps the
    reference ordering (the ~1e-10% golden-match claim depends on it).
    Read at trace time, so sharded and unsharded runs agree."""
    return os.environ.get("LBM_PAIRED_EQ", "0") not in ("0", "", "false")


def _accel_delta(w1, w2) -> jnp.ndarray:
    """Per-speed forcing deltas: +w1/-w1 on axis speeds 1/3, +w2 on
    diagonals 5,8 and -w2 on 6,7 (d2q9-bgk.c:254-261)."""
    return jnp.asarray(
        np.array([0, w1, 0, -w1, 0, w2, -w2, -w2, w2], dtype=np.asarray(w1).dtype)
    )


def _accelerated_row(
    row: jnp.ndarray, obs_row: jnp.ndarray, w1: np.float32, w2: np.float32
) -> jnp.ndarray:
    """Apply the guarded forcing to one (9, nx) row (d2q9-bgk.c:247-262)."""
    zero = np.asarray(w1).dtype.type(0)
    ok = (
        (~obs_row)
        & (row[3] - w1 > zero)
        & (row[6] - w2 > zero)
        & (row[7] - w2 > zero)
    )
    return jnp.where(ok[None, :], row + _accel_delta(w1, w2)[:, None], row)


def accelerate_flow(
    cells: jnp.ndarray,
    obstacles: jnp.ndarray,
    w1: np.float32,
    w2: np.float32,
    row: int | None = None,
) -> jnp.ndarray:
    """Forcing on one statically-known lattice row (default ny-2).

    ``cells``: (9, ny, nx) f32. ``obstacles``: (ny, nx) bool.
    """
    if row is None:
        row = cells.shape[1] - 2
    new_row = _accelerated_row(cells[:, row, :], obstacles[row, :], w1, w2)
    return cells.at[:, row, :].set(new_row)


def accelerate_flow_dynamic(
    cells: jnp.ndarray,
    obstacles: jnp.ndarray,
    w1: np.float32,
    w2: np.float32,
    local_row: jnp.ndarray,
    active: jnp.ndarray,
) -> jnp.ndarray:
    """Forcing at a traced row index, applied only when ``active`` — the
    SPMD form used inside shard_map, where only the shard owning global
    row ny-2 applies it (the reference's rank_accelerate flag,
    d2q9-bgk.c:242-243,498). Touches a single row (O(nx) work).
    """
    h = cells.shape[1]
    idx = jnp.clip(local_row, 0, h - 1)
    row = lax.dynamic_slice(cells, (0, idx, 0), (9, 1, cells.shape[2]))[:, 0, :]
    obs_row = lax.dynamic_slice(obstacles, (idx, 0), (1, obstacles.shape[1]))[0]
    new_row = _accelerated_row(row, obs_row, w1, w2)
    new_row = jnp.where(active, new_row, row)
    return lax.dynamic_update_slice(cells, new_row[:, None, :], (0, idx, 0))


def _bgk_update_planes(
    s: list[jnp.ndarray] | jnp.ndarray,
    obstacles: jnp.ndarray,
    omega: np.float32,
) -> tuple[list, jnp.ndarray]:
    """BGK relaxation + bounce-back on post-streaming distributions ``s``
    (9 planes), matching d2q9-bgk.c:315-335 term by term in f32. Returns
    ``(new_planes, |u|)`` — the plane list plus the velocity magnitude so
    callers can reduce tot_u over whichever row subset they own (the
    fused kernel's boundary-recompute rows are excluded there).
    """
    # All expansion constants in the working dtype: float32 matches the
    # reference artifact; float64 matches the golden data's original code.
    d = np.dtype(s[0].dtype).type
    one, c_sq_r, two_c_sq_r, two_c_sq_sq_r = d(1), d(3), d(1.5), d(4.5)
    w_axis = d(1) / d(9)
    w_diag = d(1) / d(36)
    weights = [d(4) / d(9), w_axis, w_axis, w_axis, w_axis,
               w_diag, w_diag, w_diag, w_diag]

    # Density: reference sums speeds 0..8 left-to-right (d2q9-bgk.c:315).
    rho = s[0] + s[1] + s[2] + s[3] + s[4] + s[5] + s[6] + s[7] + s[8]
    u_x = (s[1] + s[5] + s[8] - (s[3] + s[6] + s[7])) / rho
    u_y = (s[2] + s[5] + s[6] - (s[4] + s[7] + s[8])) / rho
    u_sq = u_x * u_x + u_y * u_y

    paired = _paired_eq_enabled() and s[0].dtype == jnp.float32
    if paired:
        # Paired form: for opposite speeds (k, k̄) the equilibrium splits
        # into even/odd parts, feq_k = E + O and feq_k̄ = E - O with
        # E = w*rho*(1 + 4.5*uc² - 1.5*u²) and O = w*rho*3*uc — the
        # even half (5 of ~8 ops) is computed once per pair instead of
        # twice. Algebraically identical to d2q9-bgk.c:325-333, with a
        # different f32 association (drift stays far inside the 1%
        # golden tolerance; see docs/PERF.md).
        base = one - u_sq * two_c_sq_r
        wrho_a = w_axis * rho
        wrho_d = w_diag * rho
        odd_a = c_sq_r * wrho_a
        odd_d = c_sq_r * wrho_d

        def pair(wrho, oddw, uc):
            even = wrho * (base + (uc * uc) * two_c_sq_sq_r)
            odd = oddw * uc
            return even + odd, even - odd

        feq = [None] * D2Q9.Q
        feq[0] = weights[0] * rho * base
        feq[1], feq[3] = pair(wrho_a, odd_a, u_x)
        feq[2], feq[4] = pair(wrho_a, odd_a, u_y)
        feq[5], feq[7] = pair(wrho_d, odd_d, u_x + u_y)
        feq[6], feq[8] = pair(wrho_d, odd_d, u_y - u_x)
    else:
        feq = []
        for k in range(D2Q9.Q):
            cx = int(D2Q9.CX[k])
            cy = int(D2Q9.CY[k])
            w = weights[k]
            if cx == 0 and cy == 0:
                # Speed 0: feq = w0 * rho * (1 - u_sq * 1.5)  (d2q9-bgk.c:325)
                feq.append(w * rho * (one - u_sq * two_c_sq_r))
                continue
            # Projected velocity, preserving the reference's expression
            # shapes (e.g. speed 6 uses (-u_x + u_y), d2q9-bgk.c:331).
            if cx == 0:
                uc = u_y if cy > 0 else -u_y
            elif cy == 0:
                uc = u_x if cx > 0 else -u_x
            else:
                ux_t = u_x if cx > 0 else -u_x
                uy_t = u_y if cy > 0 else -u_y
                uc = ux_t + uy_t
            feq.append(
                w
                * rho
                * (
                    one
                    + uc * c_sq_r
                    + (uc * uc) * two_c_sq_sq_r
                    - u_sq * two_c_sq_r
                )
            )

    new_planes = []
    for k in range(D2Q9.Q):
        relaxed = s[k] + omega * (feq[k] - s[k])
        bounced = s[int(D2Q9.OPP[k])]
        new_planes.append(jnp.where(obstacles, bounced, relaxed))

    return new_planes, jnp.sqrt(u_sq)


def _bgk_update(
    s: list[jnp.ndarray] | jnp.ndarray,
    obstacles: jnp.ndarray,
    omega: np.float32,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """:func:`_bgk_update_planes` plus the tot_u reduction over every
    (fluid) cell of the planes — the d2q9-bgk.c:335 accumulation."""
    new_planes, umag = _bgk_update_planes(s, obstacles, omega)
    d = np.dtype(new_planes[0].dtype).type
    tot_u = jnp.sum(
        jnp.where(obstacles, d(0), umag), dtype=new_planes[0].dtype
    )
    return jnp.stack(new_planes), tot_u


def collide_stream(
    cells: jnp.ndarray,
    obstacles: jnp.ndarray,
    omega: np.float32,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """One fused streaming + bounce-back + BGK collision step plus the
    tot_u reduction on a fully periodic global lattice (d2q9-bgk.c:268-339).

    Pull streaming: output cell (jj, ii) for speed k gathers from
    (jj - cy[k], ii - cx[k]) with periodic wrap (d2q9-bgk.c:288-315), i.e.
    each plane rolled by its lattice velocity.

    Returns ``(new_cells, tot_u)`` where ``tot_u`` is the un-normalised sum
    of |u| over fluid cells (the caller scales by 1/num_fluid_cells, as the
    reference does post-reduce at d2q9-bgk.c:445-446).
    """
    s = [
        jnp.roll(cells[k], (int(D2Q9.CY[k]), int(D2Q9.CX[k])), (0, 1))
        for k in range(D2Q9.Q)
    ]
    return _bgk_update(s, obstacles, omega)


def collide_stream_halo(
    interior: jnp.ndarray,
    south: jnp.ndarray,
    north: jnp.ndarray,
    obstacles: jnp.ndarray,
    omega: np.float32,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Fused step on a local row block with explicit y-halos.

    ``interior``: (9, H, nx) local rows; ``south``/``north``: (9, 1, nx)
    halo rows below row 0 / above row H-1 (the reference's jj=0 and
    jj=num_rows+1 halo rows, d2q9-bgk.c:279-283); x stays periodic
    in-block. Returns the updated interior and the local tot_u partial.
    """
    h = interior.shape[1]
    ext = jnp.concatenate([south, interior, north], axis=1)  # rows 0..H+1
    s = []
    for k in range(D2Q9.Q):
        cy = int(D2Q9.CY[k])
        cx = int(D2Q9.CX[k])
        # Output row j pulls from local row j - cy = ext row j - cy + 1.
        window = lax.slice_in_dim(ext[k], 1 - cy, 1 - cy + h, axis=0)
        s.append(jnp.roll(window, cx, axis=1))
    return _bgk_update(s, obstacles, omega)


def fused_step(
    cells: jnp.ndarray,
    obstacles: jnp.ndarray,
    w1: np.float32,
    w2: np.float32,
    omega: np.float32,
    accel_row: int | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """accelerate_flow on the pre-step state, then the fused collide-stream
    pass — the loop body of d2q9-bgk.c:191-197 (acceleration acts on the
    post-swap state of the previous iteration).
    """
    cells = accelerate_flow(cells, obstacles, w1, w2, accel_row)
    return collide_stream(cells, obstacles, omega)
