"""Checkpoint/resume and debug-mode tests."""

import numpy as np
import pytest

from lbm_tpu.obstacles import generate_obstacles
from lbm_tpu.params import Params
from lbm_tpu.runner import (
    load_checkpoint,
    run_simulation,
    save_checkpoint,
)

from conftest import SCENES


def small_params(**kw):
    defaults = dict(nx=32, ny=16, max_iters=30, reynolds_dim=10,
                    density=0.1, accel=0.005, omega=1.85)
    defaults.update(kw)
    return Params(**defaults)


def test_checkpoint_roundtrip(tmp_path):
    f = tmp_path / "ck.npz"
    cells = np.random.default_rng(0).random((9, 4, 8)).astype(np.float32)
    av = np.arange(5, dtype=np.float32)
    save_checkpoint(f, 5, cells, av)
    step, c, a = load_checkpoint(f)
    assert step == 5
    np.testing.assert_array_equal(c, cells)
    np.testing.assert_array_equal(a, av)


def test_chunked_equals_single_shot(tmp_path):
    p = small_params()
    obstacles = generate_obstacles(p.nx, p.ny)
    base = run_simulation(p, obstacles, kernel="reference")
    ck = run_simulation(
        p, obstacles, kernel="reference",
        checkpoint_every=7, checkpoint_file=tmp_path / "ck.npz",
    )
    np.testing.assert_array_equal(base.cells, ck.cells)
    np.testing.assert_allclose(base.av_vels, ck.av_vels, rtol=1e-6)
    # The final checkpoint holds the completed run.
    step, cells, av = load_checkpoint(tmp_path / "ck.npz")
    assert step == p.max_iters
    np.testing.assert_array_equal(cells, ck.cells)


def test_resume_continues_trajectory(tmp_path):
    p = small_params(max_iters=30)
    obstacles = generate_obstacles(p.nx, p.ny)
    full = run_simulation(p, obstacles, kernel="reference")

    # Run half, checkpoint, then resume to the end.
    half = run_simulation(
        p, obstacles, kernel="reference", n_iters=15,
        checkpoint_every=15, checkpoint_file=tmp_path / "ck.npz",
    )
    resumed = run_simulation(
        p, obstacles, kernel="reference", resume_from=tmp_path / "ck.npz",
    )
    np.testing.assert_array_equal(full.cells, resumed.cells)
    np.testing.assert_allclose(full.av_vels, resumed.av_vels, rtol=1e-6)
    np.testing.assert_allclose(full.av_vels[:15], half.av_vels, rtol=1e-6)


def test_debug_mode_prints_reference_block(capsys):
    p = small_params(max_iters=3)
    obstacles = generate_obstacles(p.nx, p.ny)
    res = run_simulation(p, obstacles, kernel="reference", debug=True)
    out = capsys.readouterr().out
    assert "==timestep: 0==" in out
    assert "==timestep: 2==" in out
    assert "av velocity: " in out
    assert "tot density: " in out
    # Debug trajectory equals the jitted path's.
    base = run_simulation(p, obstacles, kernel="reference")
    np.testing.assert_allclose(base.av_vels, res.av_vels, rtol=1e-6)


def test_sharded_resume_matches_full():
    """Resume + checkpoint work under a device mesh (regression: the mesh
    branch used to silently re-run from step 0 of the checkpoint)."""
    from lbm_tpu.parallel.decomp import make_mesh

    p = small_params(ny=32, max_iters=24)
    obstacles = generate_obstacles(p.nx, p.ny)
    mesh = make_mesh(4)
    full = run_simulation(p, obstacles, kernel="reference", mesh=mesh)
    run_simulation(
        p, obstacles, kernel="reference", mesh=mesh, n_iters=12,
        checkpoint_every=12, checkpoint_file="/tmp/ck_shard.npz",
    )
    resumed = run_simulation(
        p, obstacles, kernel="reference", mesh=mesh,
        resume_from="/tmp/ck_shard.npz",
    )
    np.testing.assert_array_equal(full.cells, resumed.cells)
    np.testing.assert_allclose(full.av_vels, resumed.av_vels, rtol=1e-6)


def test_debug_resume_continues_labels(tmp_path, capsys):
    """Debug mode resumes from the checkpointed step (labels and av
    prefix preserved)."""
    p = small_params(max_iters=6)
    obstacles = generate_obstacles(p.nx, p.ny)
    half = run_simulation(
        p, obstacles, kernel="reference", n_iters=3,
        checkpoint_every=3, checkpoint_file=tmp_path / "ck.npz",
    )
    res = run_simulation(
        p, obstacles, kernel="reference", debug=True,
        resume_from=tmp_path / "ck.npz",
    )
    out = capsys.readouterr().out
    assert "==timestep: 3==" in out and "==timestep: 0==" not in out
    full = run_simulation(p, obstacles, kernel="reference")
    np.testing.assert_allclose(full.av_vels, res.av_vels, rtol=1e-6)


def test_debug_with_mesh_matches_unsharded(capsys):
    """--debug works under a device mesh (VERDICT r3 #6 — the
    reference's -DDEBUG per-step block worked under MPI,
    d2q9-bgk.c:198-202): per-step av velocity and total density from a
    sharded run print the reference block and match the unsharded
    debug trajectory."""
    from lbm_tpu.parallel.decomp import make_mesh

    p = small_params(max_iters=4)
    obstacles = generate_obstacles(p.nx, p.ny)
    res = run_simulation(
        p, obstacles, kernel="reference", debug=True, mesh=make_mesh(4)
    )
    out = capsys.readouterr().out
    assert "==timestep: 0==" in out and "==timestep: 3==" in out
    assert "av velocity: " in out and "tot density: " in out
    base = run_simulation(p, obstacles, kernel="reference", debug=True)
    base_out = capsys.readouterr().out
    np.testing.assert_allclose(base.av_vels, res.av_vels, rtol=1e-5)
    np.testing.assert_allclose(base.cells, res.cells, rtol=2e-5, atol=5e-8)
    # The printed density lines agree too (same conserved quantity).
    dens = [l for l in out.splitlines() if l.startswith("tot density")]
    base_dens = [l for l in base_out.splitlines()
                 if l.startswith("tot density")]
    assert len(dens) == len(base_dens) == 4
    for a, b in zip(dens, base_dens):
        va, vb = float(a.split()[-1]), float(b.split()[-1])
        assert abs(va - vb) <= 1e-4 * abs(vb)


def test_debug_with_mesh_nondivisor_padding(capsys):
    """--debug composes with non-divisor padding: the pad rows are
    obstacles and EXCLUDED from the printed tot density (they are not
    part of the scene, and the pad row adjacent to the wall is not
    exactly at rest), so both debug lines match an unsharded debug
    run of the same scene."""
    from lbm_tpu.parallel.decomp import make_mesh

    p = small_params(ny=46, max_iters=3)
    obstacles = generate_obstacles(p.nx, p.ny)
    res = run_simulation(
        p, obstacles, kernel="reference", debug=True, mesh=make_mesh(3)
    )
    out = capsys.readouterr().out
    base = run_simulation(p, obstacles, kernel="reference", debug=True)
    base_out = capsys.readouterr().out
    assert res.cells.shape == base.cells.shape
    np.testing.assert_allclose(base.av_vels, res.av_vels, rtol=1e-5)
    np.testing.assert_allclose(base.cells, res.cells, rtol=2e-5, atol=5e-8)
    dens = [float(l.split()[-1]) for l in out.splitlines()
            if l.startswith("tot density")]
    base_dens = [float(l.split()[-1]) for l in base_out.splitlines()
                 if l.startswith("tot density")]
    assert len(dens) == len(base_dens) == 3
    np.testing.assert_allclose(dens, base_dens, rtol=1e-6)


def test_f64_pallas_rejected_cleanly():
    import pytest

    p = small_params()
    import numpy as _np

    p64 = Params(nx=p.nx, ny=p.ny, max_iters=2, reynolds_dim=10,
                 density=0.1, accel=0.005, omega=1.85, dtype=_np.float64)
    obstacles = generate_obstacles(p.nx, p.ny)
    # The Pallas kernels are gone: the name is refused with a clear error
    # naming the one kernel, at any precision.
    with pytest.raises(ValueError, match="only kernel"):
        run_simulation(p64, obstacles, kernel="pallas")
    # In a non-x64 process an f64 run would silently compute f32 and
    # relabel it; the runner refuses instead (the CLI enables x64 first —
    # see test_float64.py for the real f64 trajectory check).
    with pytest.raises(ValueError, match="x64"):
        run_simulation(p64, obstacles, kernel="auto", n_iters=2)


def test_sharded_odd_stride_checkpoint(tmp_path):
    """Sharded chunked runner with an odd stride (7 does not divide 20):
    the shard_map chunk runners for 7 and 6 steps reproduce the
    unsharded trajectory."""
    from lbm_tpu.parallel.decomp import make_mesh

    p = small_params(ny=32, nx=32, max_iters=20)
    obstacles = generate_obstacles(p.nx, p.ny)
    base = run_simulation(p, obstacles, kernel="reference")
    ck = run_simulation(
        p, obstacles, mesh=make_mesh(4),
        checkpoint_every=7, checkpoint_file=tmp_path / "ck.npz",
    )
    np.testing.assert_allclose(base.cells, ck.cells, rtol=2e-5, atol=5e-8)
    np.testing.assert_allclose(base.av_vels, ck.av_vels, rtol=1e-4)
    assert load_checkpoint(tmp_path / "ck.npz")[0] == 20


def test_preemption_padding_checkpoint(tmp_path, monkeypatch):
    """Checkpoint x padding x preemption composed: a wall-bounded
    NON-DIVISOR scene (ny=60 over 8 devices pads to 64) runs chunked +
    checkpointed on the 8-virtual-device CPU mesh, is SIGTERM-preempted
    at the first chunk boundary, and resumes to the uninterrupted
    unsharded trajectory — the reference's implicit guarantee that
    decomposition never changes results (d2q9-bgk.c:395-447)."""
    import os
    import signal

    from lbm_tpu import runner as runner_mod
    from lbm_tpu.parallel.decomp import make_mesh
    from lbm_tpu.parallel.halo import plan_padding_mode

    mesh = make_mesh(8)
    p = small_params(ny=60, nx=32, max_iters=24)
    obstacles = generate_obstacles(p.nx, p.ny)
    assert plan_padding_mode(p, obstacles, mesh) == ("wall", 4)
    base = run_simulation(p, obstacles, kernel="reference")

    f = tmp_path / "ck.npz"
    real_save = runner_mod.save_checkpoint

    def save_and_preempt(path, step, cells, av):
        real_save(path, step, cells, av)
        os.kill(os.getpid(), signal.SIGTERM)

    monkeypatch.setattr(runner_mod, "save_checkpoint", save_and_preempt)
    res = run_simulation(p, obstacles, mesh=mesh,
                         checkpoint_every=8, checkpoint_file=f)
    monkeypatch.setattr(runner_mod, "save_checkpoint", real_save)
    assert res.preempted and res.completed_steps == 8
    # The flushed checkpoint holds the PADDED lattice of the writer.
    assert load_checkpoint(f)[1].shape == (9, 64, p.nx)

    resumed = run_simulation(p, obstacles, mesh=mesh, resume_from=f)
    assert not resumed.preempted and resumed.completed_steps == 24
    assert resumed.cells.shape == base.cells.shape
    np.testing.assert_allclose(base.cells, resumed.cells, rtol=2e-5,
                               atol=5e-8)
    np.testing.assert_allclose(base.av_vels, resumed.av_vels, rtol=1e-4)


def test_checkpoint_every_requires_file():
    """checkpoint_every without checkpoint_file used to silently take
    the chunked path and save nothing (review finding r3); now it is a
    loud misconfiguration error."""
    import pytest

    p = small_params(ny=16, nx=32, max_iters=8)
    obstacles = generate_obstacles(p.nx, p.ny)
    with pytest.raises(ValueError, match="checkpoint_file"):
        run_simulation(p, obstacles, kernel="reference", checkpoint_every=4)


def test_resume_past_requested_iters_rejected(tmp_path):
    """A checkpoint beyond the requested run length is an error, not a
    silent clamp that would report the checkpoint's too-advanced lattice
    as the shorter run's result (review finding)."""
    p = small_params(max_iters=20)
    obstacles = generate_obstacles(p.nx, p.ny)
    f = tmp_path / "ck.npz"
    run_simulation(p, obstacles, kernel="reference",
                   checkpoint_every=20, checkpoint_file=f)
    assert load_checkpoint(f)[0] == 20
    with pytest.raises(ValueError, match="cannot resume"):
        run_simulation(p, obstacles, kernel="reference", n_iters=10,
                       resume_from=f)
    # Resuming at exactly the end is legal (nothing left to run).
    done = run_simulation(p, obstacles, kernel="reference", resume_from=f)
    assert len(done.av_vels) == 20


def test_resume_rejects_mismatched_scene(tmp_path):
    """A checkpoint whose lattice cannot belong to this scene fails with
    a clear error instead of an opaque shape crash (review finding)."""
    p = small_params()
    obstacles = generate_obstacles(p.nx, p.ny)
    f = tmp_path / "ck.npz"
    save_checkpoint(f, 5, np.zeros((9, p.ny, p.nx * 2), np.float32),
                    np.zeros(5, np.float32))
    with pytest.raises(ValueError, match="does not match"):
        run_simulation(p, obstacles, kernel="reference", resume_from=f)
    save_checkpoint(f, 5, np.zeros((9, p.ny - 4, p.nx), np.float32),
                    np.zeros(5, np.float32))
    with pytest.raises(ValueError, match="does not match"):
        run_simulation(p, obstacles, kernel="reference", resume_from=f)


def test_resume_across_device_counts_reconciles_padding(tmp_path):
    """Checkpoints are portable across device counts with different row
    padding (review finding): a 3-device run pads ny=46 to 48 and
    checkpoints the 48-row lattice; resuming on 2 divisor devices (no
    padding) — and the reverse — must reproduce the unpadded base
    trajectory, not crash on shapes. Pad rows sit behind the scene's
    wall rows, so swapping them for fresh equilibrium rows is exact."""
    from lbm_tpu.parallel.decomp import make_mesh

    p = small_params(ny=46, nx=64, max_iters=24)
    obstacles = generate_obstacles(p.nx, p.ny)
    base = run_simulation(p, obstacles, kernel="reference")

    # Padded writer (3 devices, pad 2) -> unpadded reader (2 devices).
    f = tmp_path / "ck3.npz"
    run_simulation(p, obstacles, kernel="reference", mesh=make_mesh(3),
                   n_iters=12, checkpoint_every=12, checkpoint_file=f)
    assert load_checkpoint(f)[1].shape == (9, 48, 64)
    got = run_simulation(p, obstacles, kernel="reference",
                         mesh=make_mesh(2), resume_from=f)
    np.testing.assert_allclose(base.cells, got.cells, rtol=2e-5, atol=5e-8)
    np.testing.assert_allclose(base.av_vels, got.av_vels, rtol=1e-4)

    # Unpadded writer (single device) -> padded reader (3 devices).
    f2 = tmp_path / "ck1.npz"
    run_simulation(p, obstacles, kernel="reference", n_iters=12,
                   checkpoint_every=12, checkpoint_file=f2)
    assert load_checkpoint(f2)[1].shape == (9, 46, 64)
    got = run_simulation(p, obstacles, kernel="reference",
                         mesh=make_mesh(3), resume_from=f2)
    np.testing.assert_allclose(base.cells, got.cells, rtol=2e-5, atol=5e-8)
    np.testing.assert_allclose(base.av_vels, got.av_vels, rtol=1e-4)


def test_wrap_checkpoint_resume(tmp_path):
    """Checkpoint/resume composed with wrap padding (wall-less
    non-divisor): the checkpoint stores the padded lattice, the resume
    substitutes fresh equilibrium pad rows, and the wrap discipline
    rewrites the one consumed pad row from the wrap halo before any real
    row reads it — so the resumed trajectory must equal the
    uninterrupted unsharded run exactly."""
    from lbm_tpu.parallel.decomp import make_mesh

    p = small_params(ny=46, nx=32, max_iters=18)
    rng = np.random.default_rng(9)
    no_walls = rng.random((p.ny, p.nx)) < 0.08
    no_walls[p.ny - 2, 3] = False
    base = run_simulation(p, no_walls)

    f = tmp_path / "ckwrap.npz"
    run_simulation(p, no_walls, mesh=make_mesh(3),
                   n_iters=9, checkpoint_every=9, checkpoint_file=f)
    assert load_checkpoint(f)[1].shape == (9, 48, 32)  # padded writer
    got = run_simulation(p, no_walls, mesh=make_mesh(3), resume_from=f)
    np.testing.assert_array_equal(base.cells, got.cells)
    np.testing.assert_allclose(base.av_vels, got.av_vels, rtol=2e-5)


def test_corrupt_checkpoint_is_a_clean_error(tmp_path):
    """Corrupt/truncated/not-an-npz checkpoint files surface as the
    CLI's one-line die() error, not an unhandled zipfile/KeyError
    traceback (review finding)."""
    p = small_params(max_iters=8)
    obstacles = generate_obstacles(p.nx, p.ny)

    garbage = tmp_path / "garbage.npz"
    garbage.write_bytes(b"not a zip archive at all")
    with pytest.raises(ValueError, match="invalid checkpoint"):
        run_simulation(p, obstacles, kernel="reference",
                       resume_from=garbage)

    missing_keys = tmp_path / "missing.npz"
    np.savez(missing_keys, step=4)  # no cells/av_vels arrays
    with pytest.raises(ValueError, match="invalid checkpoint"):
        run_simulation(p, obstacles, kernel="reference",
                       resume_from=missing_keys)


def test_truncated_av_prefix_is_a_clean_error(tmp_path):
    """A checkpoint whose av_vels array is shorter than its own step
    field fails with a checkpoint-validation message, not a numpy
    broadcast error (review finding)."""
    from lbm_tpu.runner import save_checkpoint
    from lbm_tpu.state import initial_state_np

    p = small_params(max_iters=20)
    obstacles = generate_obstacles(p.nx, p.ny)
    f = tmp_path / "short.npz"
    save_checkpoint(f, 10, initial_state_np(p),
                    np.zeros((6,), dtype=np.float32))
    with pytest.raises(ValueError, match="av_vels prefix"):
        run_simulation(p, obstacles, kernel="reference", resume_from=f)


def test_nonpositive_iters_rejected():
    """--iters 0/-5 must be a loud validation error, not an empty
    av_vels.dat or a cryptic negative-dimension crash (review
    finding); Params already enforces the same for max_iters."""
    p = small_params()
    obstacles = generate_obstacles(p.nx, p.ny)
    for bad in (0, -5):
        with pytest.raises(ValueError, match="must be positive"):
            run_simulation(p, obstacles, kernel="reference", n_iters=bad)


def test_graceful_preemption_chunked(tmp_path, monkeypatch):
    """SIGTERM during a chunked checkpointed run stops at the next chunk
    boundary with the state flushed (graceful preemption — preemptible
    machines are routinely reclaimed; the reference lost the whole run),
    and the
    checkpoint resumes to the uninterrupted trajectory."""
    import os
    import signal

    from lbm_tpu import runner as runner_mod

    p = small_params(max_iters=40)
    obstacles = generate_obstacles(p.nx, p.ny)
    full = run_simulation(p, obstacles, kernel="reference")

    f = tmp_path / "ck.npz"
    real_save = runner_mod.save_checkpoint
    saves = []

    def save_and_preempt(path, step, cells, av):
        real_save(path, step, cells, av)
        saves.append(step)
        if len(saves) == 2:  # mid-run: 2 of 5 chunks done
            os.kill(os.getpid(), signal.SIGTERM)

    monkeypatch.setattr(runner_mod, "save_checkpoint", save_and_preempt)
    res = run_simulation(p, obstacles, kernel="reference",
                         checkpoint_every=8, checkpoint_file=f)
    monkeypatch.setattr(runner_mod, "save_checkpoint", real_save)

    assert res.preempted
    assert res.completed_steps == 16
    # The guard restored the default handler on the way out.
    assert signal.getsignal(signal.SIGTERM) == signal.SIG_DFL
    step, _, av_prefix = load_checkpoint(f)
    assert step == 16
    np.testing.assert_allclose(full.av_vels[:16], av_prefix[:16], rtol=1e-6)

    resumed = run_simulation(p, obstacles, kernel="reference",
                             resume_from=f)
    assert not resumed.preempted
    assert resumed.completed_steps == 40
    np.testing.assert_array_equal(full.cells, resumed.cells)
    np.testing.assert_allclose(full.av_vels, resumed.av_vels, rtol=1e-6)


def test_graceful_preemption_sharded(tmp_path, monkeypatch):
    """Preemption composes with the sharded chunked runner: the break
    lands between shard_map chunk calls, the flushed checkpoint holds
    the gathered global lattice, and resume reproduces the full
    trajectory."""
    import os
    import signal

    from lbm_tpu import runner as runner_mod
    from lbm_tpu.parallel.decomp import make_mesh

    p = small_params(ny=32, max_iters=24)
    obstacles = generate_obstacles(p.nx, p.ny)
    full = run_simulation(p, obstacles, kernel="reference",
                          mesh=make_mesh(4))

    f = tmp_path / "ck.npz"
    real_save = runner_mod.save_checkpoint

    def save_and_preempt(path, step, cells, av):
        real_save(path, step, cells, av)
        os.kill(os.getpid(), signal.SIGTERM)

    monkeypatch.setattr(runner_mod, "save_checkpoint", save_and_preempt)
    res = run_simulation(p, obstacles, kernel="reference",
                         mesh=make_mesh(4),
                         checkpoint_every=8, checkpoint_file=f)
    monkeypatch.setattr(runner_mod, "save_checkpoint", real_save)
    assert res.preempted and res.completed_steps == 8
    assert load_checkpoint(f)[0] == 8

    resumed = run_simulation(p, obstacles, kernel="reference",
                             mesh=make_mesh(4), resume_from=f)
    np.testing.assert_array_equal(full.cells, resumed.cells)
    np.testing.assert_allclose(full.av_vels, resumed.av_vels, rtol=1e-6)


def test_graceful_preemption_debug_path(tmp_path, monkeypatch):
    """The per-step debug loop flushes a checkpoint immediately on the
    signal (no chunk boundary to wait for) and stops."""
    import os
    import signal

    from lbm_tpu import runner as runner_mod

    p = small_params(max_iters=12)
    obstacles = generate_obstacles(p.nx, p.ny)
    f = tmp_path / "ck.npz"
    real_save = runner_mod.save_checkpoint

    def save_and_preempt(path, step, cells, av):
        real_save(path, step, cells, av)
        os.kill(os.getpid(), signal.SIGTERM)

    monkeypatch.setattr(runner_mod, "save_checkpoint", save_and_preempt)
    res = run_simulation(p, obstacles, kernel="reference", debug=True,
                         checkpoint_every=3, checkpoint_file=f)
    monkeypatch.setattr(runner_mod, "save_checkpoint", real_save)

    # The boundary save at step 3 delivered the signal; the loop broke
    # right after it (the flush-on-request save is for signals landing
    # BETWEEN boundaries, exercised by the break path here).
    assert res.preempted and res.completed_steps == 3
    assert load_checkpoint(f)[0] == 3
    assert signal.getsignal(signal.SIGTERM) == signal.SIG_DFL


def test_cli_preemption_exit_code(tmp_path, monkeypatch, capsys):
    """A preempted CLI run exits 75 (EX_TEMPFAIL), points at the resume
    command on stderr, and does NOT write partial output files (a
    partial final_state.dat would masquerade as a finished run)."""
    import os
    import signal

    from lbm_tpu import runner as runner_mod
    from lbm_tpu.cli import main

    real_save = runner_mod.save_checkpoint

    def save_and_preempt(path, step, cells, av):
        real_save(path, step, cells, av)
        os.kill(os.getpid(), signal.SIGTERM)

    monkeypatch.setattr(runner_mod, "save_checkpoint", save_and_preempt)
    ck = tmp_path / "ck.npz"
    av_f, fs_f = tmp_path / "av.dat", tmp_path / "fs.dat"
    rc = main([
        str(SCENES / "input_128x128.params"),
        str(SCENES / "obstacles_128x128.dat"),
        "--kernel", "reference", "--iters", "40",
        "--checkpoint-every", "8", "--checkpoint-file", str(ck),
        "--av-vels-file", str(av_f), "--final-state-file", str(fs_f),
    ])
    monkeypatch.setattr(runner_mod, "save_checkpoint", real_save)
    assert rc == 75
    captured = capsys.readouterr()
    assert "preempted at step 8/40" in captured.err
    assert f"--resume {ck}" in captured.err
    assert "==done==" not in captured.out
    assert ck.exists() and not av_f.exists() and not fs_f.exists()


def test_cli_checkpoint_file_without_every_warns(tmp_path, capsys):
    """--checkpoint-file without --checkpoint-every saves nothing; the
    CLI says so instead of silently ignoring the flag (review finding —
    the runner already errors on the reverse misconfiguration)."""
    from lbm_tpu.cli import main

    ck = tmp_path / "ck.npz"
    rc = main([
        str(SCENES / "input_128x128.params"),
        str(SCENES / "obstacles_128x128.dat"),
        "--kernel", "reference", "--iters", "20",
        "--checkpoint-file", str(ck),
        "--av-vels-file", str(tmp_path / "av.dat"),
        "--final-state-file", str(tmp_path / "fs.dat"),
    ])
    assert rc == 0
    assert "saves nothing" in capsys.readouterr().err
    assert not ck.exists()


def test_chunk_iters_equals_single_shot():
    """chunk_iters bounds single device executions with NO checkpoint
    I/O and an identical trajectory. Exercises full chunks + a shorter
    tail (30 = 7+7+7+7+2)."""
    p = small_params()
    obstacles = generate_obstacles(p.nx, p.ny)
    base = run_simulation(p, obstacles, kernel="reference")
    ch = run_simulation(p, obstacles, kernel="reference", chunk_iters=7)
    np.testing.assert_array_equal(base.cells, ch.cells)
    np.testing.assert_array_equal(base.av_vels, ch.av_vels)
    assert ch.completed_steps == p.max_iters
    assert not ch.preempted


def test_chunk_iters_sharded_equals_single_shot():
    from lbm_tpu.parallel.decomp import make_mesh

    p = small_params()
    obstacles = generate_obstacles(p.nx, p.ny)
    base = run_simulation(p, obstacles, kernel="reference")
    ch = run_simulation(p, obstacles, kernel="reference", chunk_iters=8,
                        mesh=make_mesh(4))
    np.testing.assert_array_equal(np.asarray(base.cells),
                                  np.asarray(ch.cells))
    np.testing.assert_allclose(base.av_vels, ch.av_vels, rtol=1e-6)


def test_chunk_iters_validation():
    p = small_params()
    obstacles = generate_obstacles(p.nx, p.ny)
    with pytest.raises(ValueError, match="chunk_iters must be"):
        run_simulation(p, obstacles, chunk_iters=0)
    with pytest.raises(ValueError, match="mutually exclusive"):
        run_simulation(p, obstacles, chunk_iters=5, checkpoint_every=5,
                       checkpoint_file="x.npz")
