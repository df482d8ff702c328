"""Command-line driver: ``python -m lbm_tpu <paramfile> <obstaclefile>``.

Prints the reference's exact stdout contract (d2q9-bgk.c:219-226) —
``==done==``, the Reynolds number, and the four elapsed-time sections —
then writes ``final_state.dat`` and ``av_vels.dat``.
"""

from __future__ import annotations

import argparse
import sys

from lbm_tpu import io as lio
from lbm_tpu.obstacles import load_obstacles
from lbm_tpu.params import load_params
from lbm_tpu.runner import KERNELS, run_simulation


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="lbm_tpu",
        description="D2Q9 BGK lattice-Boltzmann solver on JAX/XLA",
    )
    p.add_argument("paramfile", help=".params scene file")
    p.add_argument("obstaclefile", help="obstacle .dat mask file")
    p.add_argument(
        "--kernel",
        choices=list(KERNELS),
        default="auto",
        help="step implementation; both names run the XLA step",
    )
    p.add_argument(
        "--devices",
        type=int,
        default=1,
        help="shard the lattice rows over this many devices (1 = unsharded)",
    )
    p.add_argument(
        "--final-state-file", default=lio.FINAL_STATE_FILE, help="output path"
    )
    p.add_argument("--av-vels-file", default=lio.AV_VELS_FILE, help="output path")
    p.add_argument(
        "--iters", type=int, default=None, help="override maxIters (debugging)"
    )
    p.add_argument(
        "--debug", action="store_true",
        help="print per-step av velocity and total density "
             "(the reference's -DDEBUG block)",
    )
    p.add_argument(
        "--checkpoint-every", type=int, default=None, metavar="N",
        help="save a checkpoint every N steps",
    )
    p.add_argument(
        "--checkpoint-file", default=None, metavar="PATH",
        help="checkpoint path (with --checkpoint-every; default "
             "lbm_checkpoint.npz)",
    )
    p.add_argument(
        "--resume", default=None, metavar="CKPT",
        help="resume from a checkpoint file",
    )
    p.add_argument(
        "--chunk-iters", type=int, default=None, metavar="N",
        help="bound any single device execution to N timesteps, without "
             "checkpoint I/O (identical trajectory; for schedulers or "
             "watchdogs that limit one execution's length)",
    )
    p.add_argument(
        "--precision",
        choices=["float32", "float64"],
        default="float32",
        help="working precision: float32 matches the reference artifact; "
             "float64 reproduces the golden data's original code",
    )
    p.add_argument(
        "--trace", default=None, metavar="DIR",
        help="capture a jax.profiler trace of the compute phase into DIR "
             "(the gprof/Advisor analogue; summarise with "
             "scripts/trace_report.py)",
    )
    p.add_argument(
        "--compilation-cache", default=None, metavar="DIR",
        help="persistent XLA compilation cache directory (default: "
             "$JAX_COMPILATION_CACHE_DIR, else <checkout>/.jax_cache); "
             "repeat runs of a scene skip the compile",
    )
    return p


def main(argv: list[str] | None = None) -> int:
    try:
        return _main(argv)
    except (OSError, ValueError) as exc:
        # The reference's die(): message to stderr, exit 1 (d2q9-bgk.c:754).
        # OSError covers missing inputs AND output-write failures
        # (permission/ENOSPC after an hour-long run deserves the same
        # one-line treatment, review finding).
        print(f"Error: {exc}", file=sys.stderr)
        return 1


def _main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    import numpy as np

    from lbm_tpu import jax_cache

    jax_cache.enable(args.compilation_cache)

    dtype = np.float64 if args.precision == "float64" else np.float32
    if dtype is np.float64:
        import jax

        jax.config.update("jax_enable_x64", True)
    params = load_params(args.paramfile, dtype=dtype)
    obstacles = load_obstacles(args.obstaclefile, params.nx, params.ny)

    mesh = None
    if args.devices > 1:
        # Clamp to visible devices; non-divisor counts pad behind
        # boundary walls or via periodic-wrap padding (wall-less masks),
        # demoting to a divisor only when even that can't fit — the
        # whole policy lives (and is unit-tested) in halo.resolve_mesh.
        from lbm_tpu.parallel.halo import resolve_mesh

        mesh, notes = resolve_mesh(params, obstacles, args.devices)
        for note in notes:
            print(note, file=sys.stderr)

    ckpt_file = args.checkpoint_file
    if args.checkpoint_every is None:
        if ckpt_file is not None:
            # The runner errors on the reverse misconfiguration
            # (every-without-file); this direction silently saves
            # nothing, which deserves at least a note (review finding).
            print(
                "note: --checkpoint-file without --checkpoint-every "
                "saves nothing; pass --checkpoint-every N",
                file=sys.stderr,
            )
    elif ckpt_file is None:
        ckpt_file = "lbm_checkpoint.npz"

    result = run_simulation(
        params,
        obstacles,
        kernel=args.kernel,
        n_iters=args.iters,
        mesh=mesh,
        debug=args.debug,
        checkpoint_every=args.checkpoint_every,
        checkpoint_file=ckpt_file,
        resume_from=args.resume,
        trace_dir=args.trace,
        chunk_iters=args.chunk_iters,
    )

    if result.preempted:
        # Graceful preemption (SIGTERM/SIGINT with periodic
        # checkpointing on): state through completed_steps is flushed
        # to the checkpoint — do NOT write final outputs (a partial
        # final_state.dat would masquerade as a finished run) and exit
        # with EX_TEMPFAIL so an orchestrator knows to re-launch with
        # --resume.
        print(
            f"preempted at step {result.completed_steps}/"
            f"{args.iters or params.max_iters}: checkpoint saved to "
            f"{ckpt_file}; resume with --resume {ckpt_file}",
            file=sys.stderr,
        )
        return 75  # EX_TEMPFAIL

    t = result.timings
    print("==done==")
    print("Reynolds number:\t\t%.12E" % result.reynolds)
    print("Elapsed Init time:\t\t\t%.6f (s)" % t["init"])
    print("Elapsed Compute time:\t\t\t%.6f (s)" % t["compute"])
    print("Elapsed Collate time:\t\t\t%.6f (s)" % t["collate"])
    print("Elapsed Total time:\t\t\t%.6f (s)" % t["total"])

    lio.write_final_state(args.final_state_file, params, result.cells, obstacles)
    lio.write_av_vels(args.av_vels_file, result.av_vels)
    return 0


if __name__ == "__main__":
    sys.exit(main())
