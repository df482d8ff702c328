"""lbm_tpu — a D2Q9 BGK lattice-Boltzmann framework on JAX/XLA.

A from-scratch JAX rebuild of the capabilities of the reference C/MPI
solver (georgeherbert/lattice-boltzmann):

- same scene API: ``.params`` files + obstacle ``.dat`` masks in,
  ``av_vels.dat`` / ``final_state.dat`` + Reynolds number out
  (reference: d2q9-bgk.c:505-654, 698-752);
- the per-timestep accelerate-flow -> fused pull-streaming / bounce-back /
  BGK-collision / average-velocity pipeline (reference: d2q9-bgk.c:235-339)
  runs as a jitted ``lax.fori_loop`` over one XLA-fused step with no host
  round-trips;
- the reference's MPI row decomposition + halo exchange
  (d2q9-bgk.c:341-393, 483-503) becomes a 1-D ``jax.sharding.Mesh`` with
  ``shard_map`` and one-row halo ``ppermute`` (NCCL over NVLink on GPUs).
"""

__version__ = "0.1.0"

# Lazy re-exports (PEP 562): the golden checker and the .dat writers
# (lbm_tpu.check / lbm_tpu.io) are numpy-only, like the reference's
# check/check.py — importing them must not drag in the jax solver
# stack (review finding: an eager `from lbm_tpu.runner import ...`
# here broke the checker in exactly the environments where the solver
# is the thing being debugged).
_EXPORTS = {
    "Params": "lbm_tpu.params",
    "load_params": "lbm_tpu.params",
    "load_obstacles": "lbm_tpu.obstacles",
    "initial_state": "lbm_tpu.state",
    "D2Q9": "lbm_tpu.state",
    "SimulationResult": "lbm_tpu.runner",
    "run_simulation": "lbm_tpu.runner",
}


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_EXPORTS))

__all__ = [
    "Params",
    "load_params",
    "load_obstacles",
    "initial_state",
    "D2Q9",
    "SimulationResult",
    "run_simulation",
    "__version__",
]
