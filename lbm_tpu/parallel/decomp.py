"""Row decomposition over a 1-D device mesh.

The reference balances ``ny`` rows over ranks with the first ``ny % size``
ranks taking one extra row (allocate_rows, d2q9-bgk.c:483-503). Here the
lattice is one array sharded over a mesh axis, so shards must be equal;
we require ``ny % n_shards == 0`` (halo.plan_padding_mode pads other
heights) and provide :func:`largest_divisor_leq` for callers that want the
best usable device count instead of an error.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
from jax.sharding import Mesh


AXIS = "y"  # the single mesh axis name, rows of the lattice


def virtual_cpu_env(env: dict, n_devices: int) -> dict:
    """Return ``env`` updated with the variables that force an n-device
    virtual CPU platform (shared by in-process provisioning below and
    subprocess launchers like __graft_entry__.dryrun_multichip)."""
    env = dict(env)
    env["JAX_PLATFORMS"] = "cpu"
    flags = [
        f
        for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f
    ]
    flags.append(f"--xla_force_host_platform_device_count={n_devices}")
    env["XLA_FLAGS"] = " ".join(flags)
    return env


def provision_virtual_cpu(n_devices: int) -> None:
    """Force an n-device virtual CPU platform — testing the
    decomposition without a cluster (SURVEY.md §4).

    Must run before the first backend use (device queries, tracing).
    Sets both the env vars and jax.config, so the platform choice holds
    even when jax was imported first.
    """
    import os

    os.environ.update(virtual_cpu_env(os.environ, n_devices))
    jax.config.update("jax_platforms", "cpu")


def make_mesh(n_devices: int, devices=None) -> Mesh:
    """A flat 1-D mesh over the first ``n_devices`` local devices (right
    for cards joined all to all, such as NVLink-connected GPUs)."""
    if devices is None:
        devices = jax.devices()
    if n_devices > len(devices):
        raise ValueError(
            f"requested {n_devices} devices but only {len(devices)} available"
        )
    return Mesh(np.array(devices[:n_devices]), (AXIS,))


def largest_divisor_leq(ny: int, n: int) -> int:
    """Largest d ≤ n with ny % d == 0 (graceful device-count fallback)."""
    for d in range(min(n, ny), 0, -1):
        if ny % d == 0:
            return d
    return 1


@dataclasses.dataclass(frozen=True)
class RowDecomposition:
    """Static decomposition facts for an ny-row lattice over n shards —
    the analogue of the reference's per-rank geometry
    (index_start/index_stop/num_rows, d2q9-bgk.c:493-500).
    """

    ny: int
    n_shards: int

    def __post_init__(self):
        if self.ny % self.n_shards != 0:
            raise ValueError(
                f"ny={self.ny} not divisible by {self.n_shards} shards; "
                f"use largest_divisor_leq(ny, n) to pick a usable count"
            )

    @property
    def local_ny(self) -> int:
        return self.ny // self.n_shards

    def owner_of_row(self, row: int) -> int:
        return row // self.local_ny

    def local_index(self, row: int) -> int:
        return row % self.local_ny

    @property
    def accel_row(self) -> int:
        """Global index of the forced row (ny-2, d2q9-bgk.c:240)."""
        return self.ny - 2

    def local_accel_row(self):
        """Shard-local index of the forced row as a traced value — the
        reference's rank_accelerate remapping (d2q9-bgk.c:498); may lie
        outside [0, local_ny) on non-owner shards. Must be called
        inside shard_map (reads axis_index)."""
        my = jax.lax.axis_index(AXIS)
        return np.int32(self.accel_row) - my * np.int32(self.local_ny)
