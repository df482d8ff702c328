"""Sharded stepping: shard_map over a 1-D row mesh with ppermute halo
exchange — the replacement for the reference's per-step MPI_Sendrecv
halo exchange (d2q9-bgk.c:341-393) and end-of-run MPI_Reduce of av_vels
(d2q9-bgk.c:445). On GPUs the ppermutes lower to NCCL collectives.

Per step, inside one jitted shard_map'd fori_loop:

1. the shard owning global row ny-2 applies accelerate_flow to it
   (the reference's rank_accelerate flag, d2q9-bgk.c:242-243);
2. each shard sends its bottom interior row down and top interior row up
   via two ``ppermute``s over the periodic ring (the reference's
   send-down-receive-up / send-up-receive-down pair, d2q9-bgk.c:353-382)
   — because acceleration ran first, neighbours see the accelerated row
   in their halo, which is what the reference's buffer_up/down_accelerate
   flags laboriously reproduce (d2q9-bgk.c:244-245,499-500);
3. the halo-aware XLA step updates the local rows;
4. the local tot_u partial is recorded — summed across shards once with
   a single psum after the loop, like the reference's one MPI_Reduce at
   collate time.

Collation of the lattice itself is implicit: the result stays sharded and
``jax.device_get`` gathers it host-side once at the end (the reference's
collate, d2q9-bgk.c:395-447).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lbm_tpu.params import Params
from lbm_tpu.parallel.decomp import AXIS, RowDecomposition
from lbm_tpu.ops import reference as ref_ops

# Row decomposition: the lattice (9, ny, nx) and the mask (ny, nx) are
# split along y, the reference's decomposition.
CELLS_SPEC = P(None, AXIS, None)
OBSTACLES_SPEC = P(AXIS, None)


def _up_perm(n: int):
    """Send to the shard above (rank_up = rank+1 mod size, d2q9-bgk.c:501)."""
    return [(i, (i + 1) % n) for i in range(n)]


def _down_perm(n: int):
    """Send to the shard below (rank_down, d2q9-bgk.c:502)."""
    return [(i, (i - 1) % n) for i in range(n)]


def exchange_halos(interior: jnp.ndarray, n_shards: int,
                   wrap_pad: int = 0):
    """One-row halo exchange over the periodic ring.

    Returns ``(south, north)`` halo rows for this shard: south = the top
    interior row of the shard below, north = the bottom interior row of
    the shard above. Single-shard meshes reduce to periodic wrap.

    ``wrap_pad`` (wrap padding, :func:`plan_padding_mode`): wall-less
    non-divisor runs pad the BOTTOM of the lattice with ``wrap_pad``
    obstacle rows, so the first REAL row is shard 0's local row
    ``wrap_pad`` — and it, not the pad row, is what the last shard must
    see as its north halo for the periodic wrap to close over the REAL
    lattice (the reference's uneven ``allocate_rows`` needed no such step
    because its shards were uneven, d2q9-bgk.c:483-492).
    """
    top = interior[:, -1:, :]
    bottom = interior[:, :1, :]
    if wrap_pad:
        is_first = lax.axis_index(AXIS) == 0
        bottom = jnp.where(
            is_first, interior[:, wrap_pad:wrap_pad + 1, :], bottom
        )
    if n_shards == 1:
        return top, bottom
    # Our top row becomes the south halo of the shard above (send up);
    # our bottom row becomes the north halo of the shard below (send down).
    south = lax.ppermute(top, AXIS, _up_perm(n_shards))
    north = lax.ppermute(bottom, AXIS, _down_perm(n_shards))
    return south, north


@dataclasses.dataclass(frozen=True)
class _ReferenceShardImpl:
    """Per-shard XLA step: accelerate (owner shard only), exchange raw
    halo rows, run the halo-aware step.

    ``wrap_pad`` > 0 enables the wrap padding discipline
    (:func:`plan_padding_mode`): the pad sits at the bottom of the
    lattice inside shard 0, the wrap halo the last shard receives is
    redirected to the first REAL row (exchange_halos), and the one pad
    row a real row pulls from (local row wrap_pad-1) is refreshed each
    step with the received south halo — the true global last row. Pull
    streaming is one-row-local, so no other pad row is ever read by a
    real row and the real region stays BIT-EXACT vs the unpadded
    periodic lattice (tests/test_sharded.py asserts exact cell
    equality). This is the equal-shard answer to the reference's uneven
    ``allocate_rows`` on masks without boundary walls
    (d2q9-bgk.c:483-492)."""

    params: Params
    decomp: RowDecomposition
    wrap_pad: int = 0

    def step(self, cells, obstacles):
        p, d = self.params, self.decomp
        local_row = d.local_accel_row()
        active = (local_row >= 0) & (local_row < d.local_ny)
        cells = ref_ops.accelerate_flow_dynamic(
            cells, obstacles, p.accel_w1, p.accel_w2, local_row, active
        )
        south, north = exchange_halos(cells, d.n_shards, self.wrap_pad)
        if self.wrap_pad:
            # Close the periodic wrap over the REAL lattice: refresh the
            # pad row the first real row pulls from with the received
            # south halo (= the global last row). O(nx) — only the one
            # row is selected and written.
            w = self.wrap_pad
            is_first = lax.axis_index(AXIS) == 0
            row = jnp.where(is_first, south, cells[:, w - 1:w, :])
            cells = cells.at[:, w - 1:w, :].set(row)
        return ref_ops.collide_stream_halo(
            cells, south, north, obstacles, p.omega
        )


def _has_wall_rows(obstacles) -> bool:
    obs = np.asarray(obstacles, dtype=bool)
    return bool(obs[0, :].all() and obs[-1, :].all())


def plan_row_padding(params: Params, obstacles, mesh: Mesh) -> int:
    """Rows of all-obstacle padding that make the row plan divide the
    mesh evenly — the equal-shard answer to the reference's uneven
    ``allocate_rows`` (first ny%size ranks take one extra row,
    d2q9-bgk.c:483-492): ny=1024 on 6 devices pads to 1026 and uses all
    six instead of demoting to 4.

    Padding is EXACT, not approximate, when both y boundaries are full
    bounce-back wall rows (true of every shipped scene): a wall row's
    distributions that its fluid neighbour reads depend only on that
    neighbour, never on what lies beyond the wall, so rows behind the
    wall are causally disconnected from the interior; pad cells are
    obstacles, so av_vels and the fluid count are untouched, and the
    runner slices the pad back off before reporting. The pad goes BELOW
    row 0 so the forced row keeps its index relative to the top
    (ny-2, d2q9-bgk.c:240). Raises when padding would be needed but a
    boundary row has fluid cells (padding would change the physics).

    Returns 0 when ny already divides the mesh."""
    n = mesh.shape[AXIS]
    pad = -params.ny % n
    if pad and not _has_wall_rows(obstacles):
        raise ValueError(
            f"ny={params.ny} does not divide over {n} devices and the "
            "obstacle mask has no full wall rows at both y boundaries, so "
            "obstacle-row padding would change the physics; use a "
            "divisor device count"
        )
    return pad


def plan_padding_mode(params: Params, obstacles, mesh: Mesh):
    """The padding policy's single owner: ``('none'|'wall'|'wrap', pad)``.

    - ``'none'``: ny divides the mesh — no padding.
    - ``'wall'``: non-divisor ny with full bounce-back wall rows at both
      y boundaries — :func:`plan_row_padding`'s wall-shielded
      obstacle-row padding, causally inert.
    - ``'wrap'``: wall-less non-divisor ny — the same pad, with the
      periodic wrap re-routed around it each step
      (:class:`_ReferenceShardImpl`), bit-exact: equal shards pad below
      row 0 with obstacle rows, and the shard step closes the wrap over
      the REAL lattice (the reference's uneven ``allocate_rows``
      balancing, d2q9-bgk.c:483-492). Needs pad <= local_ny-1 so the
      whole pad region sits inside shard 0; raises otherwise (ny barely
      above the device count — resolve_mesh then takes the divisor
      fallback).
    """
    n = mesh.shape[AXIS]
    pad = -params.ny % n
    if not pad:
        return "none", 0
    if _has_wall_rows(obstacles):
        return "wall", pad
    if pad > (params.ny + pad) // n - 1:
        raise ValueError(
            f"ny={params.ny} over {n} devices leaves no room for the wrap "
            "pad inside shard 0; use a divisor device count"
        )
    return "wrap", pad


def resolve_mesh(params: Params, obstacles, n_devices: int):
    """Resolve a requested device count to a usable mesh (or ``None``
    for unsharded) — the CLI's device policy as a library contract:

    1. clamp to the visible device count;
    2. non-divisor counts keep all devices: wall-bounded masks via
       wall-shielded obstacle-row padding, wall-less masks via periodic
       wrap padding (:func:`plan_padding_mode` — together the
       equal-shard answer to the reference's uneven ``allocate_rows``,
       d2q9-bgk.c:483-492, for any (ny, size) pair with
       ceil(ny/size)-1 pad headroom);
    3. demote to the largest divisor of ny only when even wrap padding
       cannot fit (ny barely above the device count).

    Returns ``(mesh_or_None, notes)``; ``notes`` are human-readable
    demotion messages for the caller to surface (the CLI prints them to
    stderr). This is a feasibility probe only: run_simulation recomputes
    the identical plan from the same single owner (plan_padding_mode)."""
    from lbm_tpu.parallel.decomp import largest_divisor_leq, make_mesh

    notes = []
    devices = jax.devices()
    visible = len(devices)
    usable = min(n_devices, visible)
    if usable != n_devices:
        notes.append(f"note: using {usable} devices ({visible} visible)")
    if usable <= 1:
        return None, notes
    mesh = make_mesh(usable, devices=devices)
    try:
        plan_padding_mode(params, obstacles, mesh)
    except ValueError:
        fallback = largest_divisor_leq(params.ny, usable)
        notes.append(
            f"note: using {fallback} devices (ny={params.ny} over "
            f"{usable} leaves no headroom for wrap padding; "
            "divisor fallback)"
        )
        mesh = (
            make_mesh(fallback, devices=devices) if fallback > 1 else None
        )
    return mesh, notes


def pad_scene(params: Params, obstacles, pad: int):
    """Apply a padding plan: ``pad`` all-obstacle rows below row 0
    (indices shift up by ``pad``; the forced row stays at the new
    ny-2)."""
    obs = np.pad(
        np.asarray(obstacles, dtype=bool), ((pad, 0), (0, 0)),
        constant_values=True,
    )
    return dataclasses.replace(params, ny=params.ny + pad), obs


def _local_program(params: Params, mesh: Mesh, kernel: str, n_iters: int,
                   wrap_pad: int):
    """The per-shard stepping loop shared by the whole-run and chunked
    builders: ``(cells, obstacles, inv_fluid) -> (cells, av_partial)``
    with av_partial the shard's (n_iters,) tot_u share, already scaled
    by 1/num_fluid_cells."""
    from lbm_tpu.runner import resolve_kernel, step_loop

    resolve_kernel(kernel, params)
    decomp = RowDecomposition(ny=params.ny, n_shards=mesh.shape[AXIS])
    impl = _ReferenceShardImpl(params, decomp, wrap_pad=wrap_pad)

    def local(cells, obstacles, inv_fluid):
        # The partial trajectory differs per shard from step 0, so the
        # loop carry must be typed as shard-varying from the start.
        av_partial = lax.pcast(
            jnp.zeros((n_iters,), dtype=cells.dtype), AXIS, to="varying"
        )
        return step_loop(impl.step, n_iters, cells, obstacles, inv_fluid,
                         av_partial, 0)

    return local


def make_sharded_simulate(
    params: Params,
    mesh: Mesh,
    kernel: str = "auto",
    n_iters: int | None = None,
    wrap_pad: int = 0,
):
    """Jitted whole-simulation function over a row-sharded lattice:
    ``(cells0, obstacles, inv_fluid) -> (final_cells, av_vels)``.

    ``cells0`` (9, ny, nx) is sharded P(None, 'y', None) and
    ``obstacles`` P('y', None); place them with :func:`shard_inputs`, or
    the compiled call reshards the lattice inside the timed region.
    ``av_vels`` comes back replicated."""
    iters = params.max_iters if n_iters is None else n_iters
    local = _local_program(params, mesh, kernel, iters, wrap_pad)

    def local_sim(cells, obstacles, inv_fluid):
        cells, av_partial = local(cells, obstacles, inv_fluid)
        # One reduction for the whole trajectory, not one per step — the
        # reference's single end-of-run MPI_Reduce (d2q9-bgk.c:445).
        return cells, lax.psum(av_partial, AXIS)

    sharded = jax.shard_map(
        local_sim,
        mesh=mesh,
        in_specs=(CELLS_SPEC, OBSTACLES_SPEC, P()),
        out_specs=(CELLS_SPEC, P()),
    )
    return jax.jit(sharded, donate_argnums=(0,))


def make_sharded_chunk(
    params: Params,
    mesh: Mesh,
    kernel: str,
    chunk_iters: int,
    wrap_pad: int = 0,
):
    """Sharded analogue of runner.make_chunk:
    ``(cells, obstacles, inv, av, t0) -> (cells, av)`` running
    ``chunk_iters`` steps that fill av_vels[t0:t0+chunk_iters] (av passed
    replicated; the chunk's partials are psum'd once at the end)."""
    local = _local_program(params, mesh, kernel, chunk_iters, wrap_pad)

    def local_chunk(cells, obstacles, inv_fluid, av, t0):
        cells, av_partial = local(cells, obstacles, inv_fluid)
        av = lax.dynamic_update_slice(av, lax.psum(av_partial, AXIS), (t0,))
        return cells, av

    sharded = jax.shard_map(
        local_chunk,
        mesh=mesh,
        in_specs=(CELLS_SPEC, OBSTACLES_SPEC, P(), P(), P()),
        out_specs=(CELLS_SPEC, P()),
    )
    return jax.jit(sharded, donate_argnums=(0, 3))


def shard_inputs(mesh: Mesh, cells: jnp.ndarray, obstacles: jnp.ndarray):
    """Place the initial state and mask with the shardings the sharded
    builders expect, so the compiled call never reshards inside the
    timed region."""
    cells_s = jax.device_put(cells, NamedSharding(mesh, CELLS_SPEC))
    obs_s = jax.device_put(obstacles, NamedSharding(mesh, OBSTACLES_SPEC))
    return cells_s, obs_s
