#!/usr/bin/env python3
"""Chip smoke test: the solver's main path on the GPU, checked against
the repo's own references. One process, which holds the card(s).

Default (one card), phase by phase:

1. device — platform, device_kind and device count as JAX reports them,
   the card's name and power limit from nvidia-smi, the compile-cache
   directory; fails unless JAX's devices are GPUs;
2. the official 1024x1024 x 20000 scene through the CLI
   (``lbm_tpu.cli.main``, in-process), gated against
   ``goldens/1024x1024.final_state.f64.npz`` with the reference
   checker's formula and its 1% tolerance; each file's max %diff is
   printed and flagged when over the 0.3% drift budget; Init (compile),
   Compute and Total time and the GLUPS, beside the card; then the
   scene's steady rate and memory figures;
3. the official 256x256 x 80000 scene, the same gate (launch-bound);
4. stress sizes 16384x1024 and 131072x128 x 2000 steps: float32
   through ``run_simulation`` against float64 on the same card, within
   0.3% by check.py's formula; the steady rate,
   ``compiled.memory_analysis()`` and peak device memory;
5. bandwidth probe: one large device copy, and the XLA step's share of
   its rate at each size (a single-step hand-written kernel can gain at
   most 1/share).

``--four-cards`` runs only the sharded path, on four cards: 16384x1024
over a 4-device mesh against the same scene on one card, and a
wall-less scene whose ny does not divide 4 (wrap padding) against its
one-card run, with the shards checked to sit on four devices.

The last stdout line is ``{"ok": true, "device": {"platform": ...,
"kind": ..., "count": ...}}``. Without a GPU, or when any phase fails,
the script exits 1 and prints no such line.

Usage: python chip_smoke.py [--four-cards]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

import bench  # noqa: E402
from lbm_tpu import jax_cache  # noqa: E402
from lbm_tpu.device import (  # noqa: E402
    NoGPUError, parse_card, query_card, require_gpu,
)

GATE_PCT = 1.0  # check.py's tolerance
DRIFT_BUDGET_PCT = 0.3  # float32 vs float64 drift budget
SCENE_DIR = REPO / "scenes"
GOLDEN_DIR = REPO / "goldens"
OFFICIAL_SCENES = ["1024x1024", "256x256"]
STRESS_SIZES = [(16384, 1024, 2000), (131072, 128, 2000)]  # nx, ny, iters
COPY_BYTES = 2 * 1024 ** 3
# --four-cards: (label, nx, ny, iters, wall_less)
FOUR_CARD_RUNS = [
    ("16384x1024", 16384, 1024, 2000, False),
    ("wall-less 4096x1022", 4096, 1022, 2000, True),
]
N_CARDS = 4
# The sharded-vs-unsharded tolerances of the multi-device dryrun.
CELLS_RTOL, CELLS_ATOL, AV_RTOL = 2e-5, 5e-8, 1e-4


def say(*parts) -> None:
    print(*parts, flush=True)


def max_pct(ref, sim) -> float:
    """check.py's max %diff (io._diff, the library's one copy)."""
    from lbm_tpu.io import _diff

    return abs(float(_diff(np.ravel(np.asarray(ref, np.float64)),
                           np.ravel(np.asarray(sim, np.float64))
                           ).max_diff_pcnt))


def phase_device(count: int) -> str:
    devices = require_gpu(count)
    d = devices[0]
    say(f"device: platform={d.platform} device_kind={d.device_kind} "
        f"count={len(devices)}")
    line = query_card()
    name, limit = parse_card(line)
    say("card (nvidia-smi name, power.limit):")
    say(line)
    say(f"compile cache: {jax_cache.cache_dir()}")
    return f"{name}, {limit}"


def phase_scene(name: str, card: str, scene_dir: Path = SCENE_DIR,
                golden_dir: Path = GOLDEN_DIR) -> dict:
    """One official scene, full length, through the CLI, gated against
    its float64 golden."""
    from lbm_tpu.cli import main as cli_main
    from lbm_tpu.io import compare_golden_npz
    from lbm_tpu.obstacles import load_obstacles
    from lbm_tpu.params import load_params

    params_file = scene_dir / f"input_{name}.params"
    mask_file = scene_dir / f"obstacles_{name}.dat"
    params = load_params(params_file)
    with tempfile.TemporaryDirectory() as td:
        av, fs = Path(td) / "av_vels.dat", Path(td) / "final_state.dat"
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli_main([str(params_file), str(mask_file),
                           "--av-vels-file", str(av),
                           "--final-state-file", str(fs)])
        for line in out.getvalue().splitlines():
            say(f"  | {line}")
        if rc != 0:
            raise RuntimeError(f"{name}: the CLI exited {rc}")
        res = compare_golden_npz(
            av, fs, golden_dir / f"{name}.final_state.f64.npz",
            tolerance=GATE_PCT,
        )
    t = {k.lower(): float(v) for k, v in re.findall(
        r"Elapsed (\w+) time:\s+(\S+)", out.getvalue())}
    glups = params.nx * params.ny * params.max_iters / t["compute"] / 1e9
    for label, diff in (("av_vels", res.av_vels),
                        ("final_state", res.final_state)):
        pct = abs(diff.max_diff_pcnt)
        flag = (f"  FLAG: over the {DRIFT_BUDGET_PCT}% drift budget"
                if pct > DRIFT_BUDGET_PCT else "")
        say(f"  {name} {label}: max %diff {pct:.6g}% vs the float64 "
            f"golden (gate {GATE_PCT}%){flag}")
    say(f"  {name} x {params.max_iters}: Init (compile) {t['init']:.3f} s, "
        f"Compute {t['compute']:.3f} s, Total {t['total']:.3f} s, "
        f"{glups:.3f} GLUPS [{card}]")
    if not res.passed:
        raise RuntimeError(f"{name}: check.py's {GATE_PCT}% gate failed")
    obstacles = load_obstacles(mask_file, params.nx, params.ny)
    return steady(name, params, obstacles, card)


def steady(label: str, params, obstacles, card: str) -> dict:
    """The whole-run program's warm rate (bench.measure) and memory."""
    m = bench.measure(params, obstacles)
    m.update(label=label, cells=params.nx * params.ny,
             iters=params.max_iters)
    say(f"  {label} steady: {m['glups']:.3f} GLUPS ({m['best_s']:.4f} s "
        f"for {params.max_iters} steps, compile {m['compile_s']:.3f} s) "
        f"[{card}]")
    say(f"  {label} compiled.memory_analysis(): {m['memory_analysis']}")
    say(f"  {label} peak_bytes_in_use (process so far): "
        f"{m['peak_bytes_in_use']}")
    return m


def phase_stress(nx: int, ny: int, iters: int, card: str) -> dict:
    """float32 against float64 on the same device, then the steady rate."""
    import jax

    from lbm_tpu.io import final_state_fields
    from lbm_tpu.runner import run_simulation

    label = f"{nx}x{ny}"
    p32, obstacles = bench.scene(nx, ny, iters)
    r32 = run_simulation(p32, obstacles)
    with jax.enable_x64(True):
        p64, _ = bench.scene(nx, ny, iters, dtype=np.float64)
        r64 = run_simulation(p64, obstacles)
    for p, r in (("float32", r32), ("float64", r64)):
        t = r.timings
        say(f"  {label} x {iters} {p}: Init (compile) {t['init']:.3f} s, "
            f"Compute {t['compute']:.3f} s, "
            f"{nx * ny * iters / t['compute'] / 1e9:.3f} GLUPS [{card}]")
    av_pct = max_pct(r64.av_vels, r32.av_vels)
    fs_pct = max_pct(final_state_fields(p64, r64.cells, obstacles)[3],
                     final_state_fields(p32, r32.cells, obstacles)[3])
    say(f"  {label} float32 vs float64: av_vels max %diff {av_pct:.6g}%, "
        f"final_state max %diff {fs_pct:.6g}% (budget {DRIFT_BUDGET_PCT}%)")
    if not (av_pct <= DRIFT_BUDGET_PCT and fs_pct <= DRIFT_BUDGET_PCT):
        raise RuntimeError(f"{label}: float32 drifts past the budget")
    return steady(label, p32, obstacles, card)


def phase_bandwidth(rates: list, card: str, nbytes: int = COPY_BYTES):
    """Time one large device-to-device pass (read + write ``nbytes``
    each), then the XLA step's share of that rate at each size."""
    import jax
    import jax.numpy as jnp

    from lbm_tpu.profiling import BYTES_PER_CELL_F32_MASK

    x = jnp.ones((nbytes // 4,), jnp.float32)
    copy = jax.jit(lambda a: -a)
    copy(x).block_until_ready()
    best = float("inf")
    for _ in range(10):
        t0 = time.perf_counter()
        copy(x).block_until_ready()
        best = min(best, time.perf_counter() - t0)
    copy_gbps = 2 * nbytes / best / 1e9
    say(f"  copy of {nbytes / 1e9:.2f} GB: {best * 1e3:.4f} ms, "
        f"{copy_gbps:.1f} GB/s read+write [{card}]")
    for m in rates:
        gbps = m["glups"] * BYTES_PER_CELL_F32_MASK
        share = gbps / copy_gbps
        say(f"  {m['label']}: step {m['glups']:.3f} GLUPS = {gbps:.1f} GB/s "
            f"by the 76 B/cell model, {share:.3f} of the copy rate; a "
            f"single-step hand-written kernel can gain at most "
            f"1/share = {1 / share:.2f}x")
    return copy_gbps


def wall_less_mask(nx: int, ny: int, seed: int = 0) -> np.ndarray:
    """Scattered obstacles, no wall rows: periodic in y."""
    mask = np.random.default_rng(seed).random((ny, nx)) < 0.02
    mask[ny - 2, :] = False  # keep the forced row fluid
    return mask


def placed_devices(params, obstacles, mesh) -> set:
    """Run the sharded program briefly and return the devices its result
    lattice's shards sit on."""
    import jax.numpy as jnp

    from lbm_tpu.obstacles import num_non_obstacles_r
    from lbm_tpu.parallel import halo
    from lbm_tpu.state import initial_state

    mode, pad = halo.plan_padding_mode(params, obstacles, mesh)
    if pad:
        params, obstacles = halo.pad_scene(params, obstacles, pad)
    cells, obs = halo.shard_inputs(mesh, initial_state(params),
                                   jnp.asarray(obstacles))
    sim = halo.make_sharded_simulate(
        params, mesh, n_iters=10, wrap_pad=pad if mode == "wrap" else 0)
    out, _ = sim(cells, obs, num_non_obstacles_r(obstacles))
    shard_devices = [s.device for s in out.addressable_shards]
    if len(set(shard_devices)) != len(shard_devices):
        raise RuntimeError(f"shards share devices: {shard_devices}")
    return set(out.sharding.device_set)


def phase_four_cards(card: str):
    from lbm_tpu.parallel.halo import plan_padding_mode, resolve_mesh
    from lbm_tpu.runner import run_simulation

    n = N_CARDS
    for label, nx, ny, iters, wall_less in FOUR_CARD_RUNS:
        params, obstacles = bench.scene(nx, ny, iters)
        if wall_less:
            obstacles = wall_less_mask(nx, ny)
        mesh, notes = resolve_mesh(params, obstacles, n)
        if mesh is None or mesh.shape["y"] != n:
            raise RuntimeError(f"{label}: no {n}-device mesh ({notes})")
        mode, pad = plan_padding_mode(params, obstacles, mesh)
        used = placed_devices(params, obstacles, mesh)
        if len(used) != n:
            raise RuntimeError(f"{label}: shards on {len(used)} devices")
        say(f"  {label} x {iters}: padding {mode} ({pad} rows), shards on "
            f"{sorted(d.id for d in used)}")
        one = run_simulation(params, obstacles)
        many = run_simulation(params, obstacles, mesh=mesh)
        cells_err = np.max(np.abs(many.cells - one.cells))
        av_err = np.max(np.abs(many.av_vels - one.av_vels)
                        / np.abs(one.av_vels))
        for what, r in (("1 card", one), (f"{n} cards", many)):
            t = r.timings["compute"]
            say(f"  {label} {what}: Compute {t:.3f} s, "
                f"{nx * ny * iters / t / 1e9:.3f} GLUPS [{card}]")
        say(f"  {label}: max |cells diff| {cells_err:.3g}, max av_vels "
            f"rel diff {av_err:.3g} (rtol {CELLS_RTOL}/atol {CELLS_ATOL}, "
            f"av rtol {AV_RTOL})")
        np.testing.assert_allclose(one.cells, many.cells, rtol=CELLS_RTOL,
                                   atol=CELLS_ATOL, err_msg=label)
        np.testing.assert_allclose(one.av_vels, many.av_vels, rtol=AV_RTOL,
                                   err_msg=label)


def run_one_card(card: str) -> None:
    rates = []
    for name in OFFICIAL_SCENES:
        say(f"== phase: official scene {name} ==")
        rates.append(phase_scene(name, card))
    for nx, ny, iters in STRESS_SIZES:
        say(f"== phase: stress {nx}x{ny} ==")
        rates.append(phase_stress(nx, ny, iters, card))
    say("== phase: bandwidth probe ==")
    phase_bandwidth(rates, card)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help=f"run only the {N_CARDS}-card sharded phase")
    args = ap.parse_args(argv)
    jax_cache.enable()
    try:
        say("== phase: device ==")
        card = phase_device(N_CARDS if args.four_cards else 1)
        if args.four_cards:
            say(f"== phase: {N_CARDS}-card mesh ==")
            phase_four_cards(card)
        else:
            run_one_card(card)
    except NoGPUError as exc:
        print(f"chip_smoke: {exc}", file=sys.stderr)
        return 1
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    import jax

    devices = jax.devices()
    say(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
