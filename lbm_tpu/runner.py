"""Simulation driver: the reference's main loop (d2q9-bgk.c:191-203) as a
single jitted ``lax.fori_loop`` — accelerate → fused collide-stream →
per-step av_vels accumulation — entirely on device, with av_vels stored in a
preallocated ``(maxIters,)`` on-device buffer (the reference's host-side
``av_vels`` array, d2q9-bgk.c:646) and transferred once at the end (the
reference's collate, d2q9-bgk.c:395-447).

Extras beyond the reference:

- chunked execution with periodic checkpoint/resume (.npz of step index,
  lattice state and trajectory prefix) — the reference persisted nothing
  until the end (SURVEY §5);
- a debug mode printing the reference's ``-DDEBUG`` per-step block
  (``==timestep==`` / av velocity / tot density, d2q9-bgk.c:198-202).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from lbm_tpu.params import Params
from lbm_tpu.obstacles import num_non_obstacles_r
from lbm_tpu.state import D2Q9, initial_state, initial_state_np
from lbm_tpu.observables import calc_reynolds, total_density
from lbm_tpu.ops import reference as ref_ops


@dataclasses.dataclass
class SimulationResult:
    cells: np.ndarray  # (9, ny, nx) final global state, params.dtype
    av_vels: np.ndarray  # (maxIters,) params.dtype
    reynolds: float
    timings: dict  # init / compute / collate / total seconds
    # Graceful preemption (chunked checkpointing paths only): the number
    # of steps actually completed, and whether the run stopped early on
    # SIGTERM/SIGINT with its state flushed to the checkpoint file.
    # av_vels entries past completed_steps are zeros, not trajectory.
    completed_steps: int = -1  # -1 = the full iteration count
    preempted: bool = False


class _PreemptionGuard:
    """Graceful-preemption watch for the chunked loops: while active,
    SIGTERM/SIGINT set a flag instead of killing the process, so the
    loop can flush a checkpoint at the next chunk boundary and stop
    early with a resumable state — preemptible cloud machines are
    routinely reclaimed, and the reference simply lost the whole run (SURVEY §5: no
    checkpoint/recovery). A SECOND signal restores default handling
    (the first escalation path if the current chunk hangs). Armed only
    when periodic checkpointing gives the loop a boundary to stop at;
    inert outside the main thread, where ``signal.signal`` raises."""

    _SIGNALS = ("SIGTERM", "SIGINT")

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.requested = False
        self._saved = {}

    def _handle(self, signum, frame):
        self.requested = True
        self._restore()  # second signal: default (deadly) behaviour

    def _restore(self):
        import signal as _signal

        for num, prev in self._saved.items():
            _signal.signal(num, prev)
        self._saved = {}

    def __enter__(self):
        if not self.enabled:
            return self
        import signal as _signal
        import threading

        if threading.current_thread() is not threading.main_thread():
            return self
        for name in self._SIGNALS:
            num = getattr(_signal, name, None)
            if num is None:
                continue
            self._saved[num] = _signal.signal(num, self._handle)
        return self

    def __exit__(self, *exc):
        self._restore()
        return False


# The names a caller may pass as ``kernel``. Both mean the XLA step
# (ops/reference.py), the solver's one kernel; ``reference`` is kept so
# that existing scripts keep working.
KERNELS = ("auto", "reference")


def resolve_kernel(kernel: str, params: Params) -> str:
    """Validate a kernel name and the working precision; returns the
    kernel that runs (always the XLA step, ``"reference"``)."""
    if kernel not in KERNELS:
        raise ValueError(
            f"unknown kernel {kernel!r}: the XLA step ('auto' or "
            "'reference') is the only kernel"
        )
    from lbm_tpu.params import ensure_dtype_computable

    ensure_dtype_computable(params)
    return "reference"


def make_step(params: Params):
    """One timestep ``(cells, obstacles) -> (cells, tot_u)``: forcing on
    row ny-2, then the fused collide-stream pass."""
    w1, w2, omega = params.accel_w1, params.accel_w2, params.omega
    return lambda cells, obs: ref_ops.fused_step(cells, obs, w1, w2, omega)


def step_loop(step, n, cells, obstacles, inv_fluid, av_vels, t0):
    """``n`` steps of ``step`` in one ``fori_loop``, writing
    av_vels[t0 : t0+n] (used verbatim inside halo's shard_map programs
    too). Per-step scaling by 1/num_fluid_cells is algebraically the
    reference's end-of-run scaling of the reduced sums
    (d2q9-bgk.c:445-446). ``t0`` may be a python int or traced scalar."""

    def body(i, carry):
        cells, av = carry
        cells, tot = step(cells, obstacles)
        av = lax.dynamic_update_slice(av, (tot * inv_fluid)[None], (t0 + i,))
        return cells, av

    return lax.fori_loop(0, n, body, (cells, av_vels))


def make_simulate(params: Params, kernel: str = "auto", n_iters: int | None = None):
    """Build the jitted whole-simulation function
    ``(cells0, obstacles, inv_fluid) -> (final_cells, av_vels)``.
    """
    resolve_kernel(kernel, params)
    iters = params.max_iters if n_iters is None else n_iters
    step = make_step(params)
    av_dtype = params.dtype

    @partial(jax.jit, donate_argnums=(0,))
    def simulate(cells, obstacles, inv_fluid):
        av_vels = jnp.zeros((iters,), dtype=av_dtype)
        return step_loop(step, iters, cells, obstacles, inv_fluid, av_vels, 0)

    return simulate


def make_chunk(params: Params, kernel: str, chunk_iters: int):
    """Jitted chunk runner ``(cells, obstacles, inv, av, t0) -> (cells, av)``
    executing ``chunk_iters`` steps that write av_vels[t0:t0+chunk_iters]."""
    resolve_kernel(kernel, params)
    step = make_step(params)

    def chunk(cells, obstacles, inv_fluid, av_vels, t0):
        return step_loop(step, chunk_iters, cells, obstacles, inv_fluid,
                         av_vels, t0)

    return jax.jit(chunk, donate_argnums=(0, 3))


def _fence(small_output) -> None:
    """Wait for the computation producing ``small_output`` by fetching
    it to the host: the timed compute phase ends when the run's
    trajectory exists on the host."""
    np.asarray(small_output)


def save_checkpoint(path: str | Path, step: int, cells, av_vels) -> None:
    """Persist (step, lattice, trajectory prefix) as .npz."""
    np.savez_compressed(
        path,
        step=np.int64(step),
        cells=np.asarray(cells),
        av_vels=np.asarray(av_vels),
    )


def load_checkpoint(path: str | Path):
    """Returns (step, cells, av_vels) from a checkpoint file."""
    try:
        with np.load(path) as z:
            return int(z["step"]), z["cells"], z["av_vels"]
    except OSError:
        raise  # missing/unreadable file — already on the CLI die() path
    except Exception as exc:
        # zipfile.BadZipFile (truncated/corrupt), KeyError (missing
        # arrays), EOFError, numpy's misleading pickled-data ValueError
        # — translate to the CLI's one-line die() contract instead of
        # an unhandled traceback or a cryptic message (review finding).
        raise ValueError(f"invalid checkpoint file {path!r}: {exc!r}") \
            from exc


def run_simulation(
    params: Params,
    obstacles: np.ndarray,
    kernel: str = "auto",
    n_iters: int | None = None,
    mesh=None,
    debug: bool = False,
    checkpoint_every: int | None = None,
    checkpoint_file: str | Path | None = None,
    resume_from: str | Path | None = None,
    trace_dir: str | Path | None = None,
    chunk_iters: int | None = None,
) -> SimulationResult:
    """Run the full simulation and return final state + trajectory.

    ``mesh``: optional ``jax.sharding.Mesh`` with a single 'y' axis; when
    given, the lattice is row-sharded and stepped under ``shard_map`` with
    ppermute halo exchange (the reference's MPI decomposition,
    d2q9-bgk.c:341-393, 483-503).

    ``checkpoint_every``/``checkpoint_file``: periodically persist state;
    ``resume_from``: continue a previous run's checkpoint.
    ``chunk_iters``: bound any single device execution to this many
    timesteps WITHOUT checkpoint I/O (trajectory identical — the same
    chunked runners the checkpoint path uses, minus the per-chunk host
    flush), for schedulers or watchdogs that limit one execution's
    length.
    ``debug``: print the reference's -DDEBUG per-step block (slow path).
    ``trace_dir``: capture a jax.profiler trace of the compute phase
    (the gprof/Advisor analogue — profiling.trace; view with xprof or
    summarise with scripts/trace_report.py).
    """
    import contextlib

    from lbm_tpu.profiling import trace as _trace

    trace_ctx = (
        (lambda: _trace(str(trace_dir)))
        if trace_dir is not None
        else contextlib.nullcontext
    )
    from lbm_tpu.profiling import PhaseTimers

    timers = PhaseTimers()
    timers.start("total")
    timers.start("init")
    if checkpoint_every is not None and checkpoint_every <= 0:
        raise ValueError(
            f"checkpoint_every must be a positive step count, "
            f"got {checkpoint_every}"
        )
    if checkpoint_every is not None and checkpoint_file is None:
        # Without a file the chunked path would run (slower) and save
        # nothing — a misconfiguration, not a request. Execution-length
        # bounding without I/O is chunk_iters' job.
        raise ValueError(
            "checkpoint_every requires checkpoint_file (periodic "
            "checkpointing needs somewhere to write); to bound "
            "execution length without saving, use chunk_iters"
        )
    if chunk_iters is not None and chunk_iters <= 0:
        raise ValueError(
            f"chunk_iters must be a positive step count, got {chunk_iters}"
        )
    if chunk_iters is not None and checkpoint_every is not None:
        # Two competing strides would silently pick one; refuse.
        raise ValueError(
            "chunk_iters and checkpoint_every are mutually exclusive "
            "(checkpointing already chunks at its own stride)"
        )
    iters = params.max_iters if n_iters is None else n_iters
    if iters <= 0:
        # Params validates max_iters > 0; the n_iters override must
        # hold the same contract or --iters -5 surfaces as a cryptic
        # 'negative dimensions are not allowed' from jnp.zeros (and 0
        # silently writes an empty av_vels.dat) — review finding.
        raise ValueError(f"iteration count must be positive, got {iters}")
    obstacles = np.asarray(obstacles, dtype=bool)
    orig_ny = params.ny
    pad_rows, wrap_pad = 0, 0
    resolve_kernel(kernel, params)
    if mesh is not None:
        # Non-divisor device counts: pad with obstacle rows instead of
        # demoting the mesh (halo.plan_padding_mode; the reference's
        # allocate_rows balancing, d2q9-bgk.c:483-492) — wall-shielded
        # behind boundary walls, periodic-wrap otherwise (exact: the
        # shard step re-routes the wrap around the pad). The pad is
        # sliced back off the final state below.
        from lbm_tpu.parallel import halo as _halo

        pad_mode, pad_rows = _halo.plan_padding_mode(params, obstacles, mesh)
        if pad_rows:
            params, obstacles = _halo.pad_scene(params, obstacles, pad_rows)
        if pad_mode == "wrap":
            wrap_pad = pad_rows
    inv_fluid = num_non_obstacles_r(obstacles, dtype=params.dtype)
    obs_dev = jnp.asarray(obstacles)

    start_step = 0
    av0 = np.zeros((iters,), dtype=params.dtype)
    if resume_from is not None:
        start_step, cells_np, av_prefix = load_checkpoint(resume_from)
        if not 0 <= start_step <= iters:
            # A clamp here would return the checkpoint's too-advanced
            # lattice as the "result" of a shorter run (review finding).
            raise ValueError(
                f"checkpoint at step {start_step} cannot resume a "
                f"{iters}-iteration run"
            )
        # Reconcile row padding: checkpoints store the PADDED lattice of
        # the run that wrote them, and this run's device count may pad
        # differently (review finding: a 6-device 1024->1056-row
        # checkpoint resumed on 8 divisor devices crashed on shapes).
        # Pad rows never feed the interior — wall-shielded pads are
        # causally disconnected behind the walls, and wrap-mode pads
        # are rewritten from the wrap halo before any real row reads
        # them (plan_padding_mode) — so stripping the writer's pad and
        # substituting fresh equilibrium pad rows is exact either way.
        old_pad = cells_np.shape[1] - orig_ny
        if (cells_np.shape[0] != D2Q9.Q
                or cells_np.shape[2] != params.nx or old_pad < 0):
            raise ValueError(
                f"checkpoint lattice shape {cells_np.shape} does not "
                f"match the {orig_ny}x{params.nx} scene"
            )
        if old_pad != pad_rows:
            interior = cells_np[:, old_pad:, :]
            if pad_rows:
                # Host-side twin: the lattice is on the host already.
                fresh = initial_state_np(params, dtype=params.dtype)
                fresh[:, pad_rows:, :] = interior
                cells_np = fresh
            else:
                cells_np = interior
        cells0 = jnp.asarray(cells_np.astype(params.dtype, copy=False))
        if len(av_prefix) < start_step:
            # A truncated write (or a hand-edited step field) would
            # otherwise surface as a raw numpy broadcast error.
            raise ValueError(
                f"checkpoint av_vels prefix has {len(av_prefix)} "
                f"entries but claims step {start_step}"
            )
        av0[:start_step] = av_prefix[:start_step]
    else:
        cells0 = initial_state(params, dtype=params.dtype)

    if debug:
        return _run_debug(
            params, cells0, obs_dev, inv_fluid, kernel, iters, timers,
            start_step, av0,
            checkpoint_every=checkpoint_every,
            checkpoint_file=checkpoint_file,
            trace_ctx=trace_ctx,
            mesh=mesh,
            pad_rows=pad_rows,
            wrap_pad=wrap_pad,
        )

    completed, preempted = iters, False
    chunked = bool(checkpoint_every or chunk_iters or start_step)
    if mesh is not None and not chunked:
        from lbm_tpu.parallel import halo

        simulate = halo.make_sharded_simulate(
            params, mesh, kernel=kernel, n_iters=iters, wrap_pad=wrap_pad
        )
        cells0, obs_dev = halo.shard_inputs(mesh, cells0, obs_dev)
        compiled = simulate.lower(cells0, obs_dev, inv_fluid).compile()
        jax.block_until_ready((cells0, obs_dev))
        timers.stop("init")
        with timers.phase("compute"), trace_ctx():
            cells, av_vels = compiled(cells0, obs_dev, inv_fluid)
            _fence(av_vels)
    elif chunked:
        # Chunked path (single-device or sharded): one jitted runner per
        # distinct chunk length (full chunks + possibly a shorter tail),
        # all compiled before the compute timer starts.
        stride = checkpoint_every or chunk_iters or (iters - start_step)
        if mesh is not None:
            from lbm_tpu.parallel import halo

            cells0, obs_dev = halo.shard_inputs(mesh, cells0, obs_dev)
            mk = lambda n: halo.make_sharded_chunk(
                params, mesh, kernel, n, wrap_pad=wrap_pad
            )
        else:
            mk = lambda n: make_chunk(params, kernel, n)
        sizes = []
        tt_probe = start_step
        while tt_probe < iters:
            n = min(stride, iters - tt_probe)
            if n not in sizes:
                sizes.append(n)
            tt_probe += n
        av_vels = jnp.asarray(av0)
        runners = {
            n: mk(n).lower(
                cells0, obs_dev, inv_fluid, av_vels, jnp.int32(0)
            ).compile()
            for n in sizes
        }
        cells = cells0
        jax.block_until_ready((cells0, obs_dev))
        timers.stop("init")
        timers.start("compute")
        guard = _PreemptionGuard(
            enabled=bool(checkpoint_every and checkpoint_file is not None)
        )
        with trace_ctx(), guard:
            tt = start_step
            while tt < iters:
                n = min(stride, iters - tt)
                cells, av_vels = runners[n](
                    cells, obs_dev, inv_fluid, av_vels, jnp.int32(tt)
                )
                tt += n
                if checkpoint_every and checkpoint_file is not None:
                    # save_checkpoint's np.asarray is itself the fence.
                    save_checkpoint(checkpoint_file, tt, cells, av_vels)
                if guard.requested:
                    # Preempted: the chunk just completed and its state
                    # is flushed — stop here; the caller resumes from
                    # the checkpoint (latency bound: one chunk).
                    break
            _fence(av_vels)
        timers.stop("compute")
        completed, preempted = tt, guard.requested and tt < iters
    else:
        simulate = make_simulate(params, kernel=kernel, n_iters=iters)
        compiled = simulate.lower(cells0, obs_dev, inv_fluid).compile()
        jax.block_until_ready((cells0, obs_dev))
        timers.stop("init")
        with timers.phase("compute"), trace_ctx():
            cells, av_vels = compiled(cells0, obs_dev, inv_fluid)
            _fence(av_vels)

    # Collate: device -> host gather of the final lattice + trajectory.
    # Reynolds is computed on the DEVICE-RESIDENT state, so the lattice
    # is never uploaded again.
    with timers.phase("collate"):
        cells_np = np.asarray(jax.device_get(cells), dtype=params.dtype)
        av_np = np.asarray(jax.device_get(av_vels), dtype=params.dtype)
        reynolds = float(calc_reynolds(params, cells, obs_dev))
    timers.stop("total")
    if pad_rows:
        cells_np = cells_np[:, pad_rows:, :]

    return SimulationResult(
        cells=cells_np,
        av_vels=av_np,
        reynolds=reynolds,
        timings=dict(timers.elapsed),
        completed_steps=completed,
        preempted=preempted,
    )


def _run_debug(params, cells0, obs_dev, inv_fluid, kernel, iters, timers,
               start_step=0, av0=None,
               checkpoint_every=None, checkpoint_file=None,
               trace_ctx=None, mesh=None, pad_rows=0, wrap_pad=0):
    """Python-loop path printing the reference's -DDEBUG block per step
    (d2q9-bgk.c:198-202); resumes mid-trajectory when given a start step
    and av prefix, and honours periodic checkpointing like the jitted
    path. Under a ``mesh`` it steps the sharded one-step chunk runner —
    the reference's -DDEBUG block also worked under MPI
    (d2q9-bgk.c:198-202; the per-step reduce is the debug path's
    explicit cost)."""
    import contextlib

    av = np.zeros((iters,), dtype=params.dtype) if av0 is None else av0
    # AOT-compile during init so the first-call compile lands in the
    # init timer like every other path.
    if mesh is not None:
        from lbm_tpu.parallel import halo

        cells, obs_dev = halo.shard_inputs(mesh, cells0, obs_dev)
        av_box = [jnp.asarray(av)]  # replicated on-device trajectory
        chunk = halo.make_sharded_chunk(params, mesh, kernel, 1,
                                        wrap_pad=wrap_pad)
        compiled = chunk.lower(
            cells, obs_dev, inv_fluid, av_box[0], jnp.int32(0)
        ).compile()

        def do_step(cells, tt):
            cells, av_box[0] = compiled(
                cells, obs_dev, inv_fluid, av_box[0], jnp.int32(tt)
            )
            # Host fetch of one scalar: the per-step psum is already
            # inside the chunk; av_vels[tt] is replicated.
            return cells, float(av_box[0][tt])
    else:
        cells = cells0
        step = jax.jit(make_step(params)).lower(cells0, obs_dev).compile()
        inv = float(inv_fluid)

        def do_step(cells, tt):
            cells, tot_u = step(cells, obs_dev)
            return cells, float(tot_u) * inv

    timers.stop("init")
    timers.start("compute")
    # The profiler trace covers the compute phase only, like every
    # other path — entered after the AOT compile so a --debug --trace
    # capture isn't dominated by compilation (review finding).
    done = start_step
    guard = _PreemptionGuard(
        enabled=bool(checkpoint_every and checkpoint_file is not None)
    )
    with (trace_ctx or contextlib.nullcontext)(), guard:
        for tt in range(start_step, iters):
            cells, av[tt] = do_step(cells, tt)
            print("==timestep: %d==" % tt)
            print("av velocity: %.12E" % av[tt])
            # Exclude the wall-shielded pad rows (non-divisor meshes):
            # their mass is not part of the scene, and the pad region
            # is not exactly at rest (its row adjacent to the wall
            # pulls from the evolving wall row), so the reference's
            # debug block would otherwise report a drifting offset.
            print("tot density: %.12E" % float(
                total_density(cells[:, pad_rows:, :] if pad_rows else cells)
            ))
            done = tt + 1
            if (checkpoint_every and checkpoint_file is not None
                    and (done % checkpoint_every == 0 or done == iters
                         or guard.requested)):
                save_checkpoint(checkpoint_file, done, cells, av)
            if guard.requested:
                # The per-step python loop can flush immediately — no
                # chunk boundary to wait for.
                break
    timers.stop("compute")
    with timers.phase("collate"):
        cells_np = np.asarray(jax.device_get(cells), dtype=params.dtype)
        reynolds = float(calc_reynolds(params, cells, obs_dev))
    timers.stop("total")
    if pad_rows:
        cells_np = cells_np[:, pad_rows:, :]
    return SimulationResult(
        cells=cells_np,
        av_vels=av,
        reynolds=reynolds,
        timings=dict(timers.elapsed),
        completed_steps=done,
        preempted=guard.requested and done < iters,
    )
