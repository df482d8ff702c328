"""Tests for profiling utilities and the analysis/generator scripts."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from lbm_tpu.profiling import PhaseTimers, roofline_report

REPO = Path(__file__).resolve().parent.parent


def test_phase_timers_report():
    t = PhaseTimers()
    with t.phase("total"):
        with t.phase("init"):
            pass
        with t.phase("compute"):
            pass
    rep = t.report()
    assert "Elapsed Init time:" in rep
    assert "Elapsed Compute time:" in rep
    assert "Elapsed Total time:" in rep
    assert t.elapsed["total"] >= t.elapsed["init"]


def test_roofline_report_memory_bound():
    # 1024^2 x 2000 iters in 0.4 s ~ 5.2 GLUPS.
    r = roofline_report(1024, 1024, 2000, 0.4,
                        device_kind="NVIDIA H100 80GB HBM3")
    assert r["bound"] == "memory"
    assert 5.0 < r["glups"] < 5.5
    assert 0 < r["hbm_utilisation"] < 1
    assert np.isclose(r["arithmetic_intensity"], 130 / 76, rtol=1e-6)


def test_generate_obstacles_script(tmp_path):
    out = tmp_path / "obs.dat"
    res = subprocess.run(
        [sys.executable, str(REPO / "scripts/generate_obstacles.py"),
         "16", "8", "-o", str(out)],
        capture_output=True, text=True,
    )
    assert res.returncode == 0, res.stderr
    lines = out.read_text().splitlines()
    # 2*W + 2*H lines, duplicates at corners included (reference format).
    assert len(lines) == 2 * 16 + 2 * 8
    assert lines[0] == "0 0 1"


def test_scaling_script(tmp_path):
    data = [
        {"grid": "128x128", "backend": "gpu", "devices": 1, "seconds": 2.0,
         "iters": 100, "glups": 1.0},
        {"grid": "128x128", "backend": "gpu", "devices": 4, "seconds": 0.5,
         "iters": 100, "glups": 4.0},
        {"grid": "256x256", "devices": 2, "error": "X"},
    ]
    f = tmp_path / "sweep.json"
    f.write_text(json.dumps(data))
    res = subprocess.run(
        [sys.executable, str(REPO / "scripts/scaling.py"), str(f)],
        capture_output=True, text=True,
    )
    assert res.returncode == 0, res.stderr
    assert "(4, 4.000)" in res.stdout


def test_plot_script(tmp_path):
    fs = tmp_path / "final_state.dat"
    lines = []
    for jj in range(4):
        for ii in range(4):
            lines.append(f"{ii} {jj} 0.0E+00 0.0E+00 {0.1*ii:.6E} 3.3E-02 0")
    fs.write_text("\n".join(lines) + "\n")
    out = tmp_path / "fs.png"
    res = subprocess.run(
        [sys.executable, str(REPO / "scripts/plot_final_state.py"),
         str(fs), "-o", str(out)],
        capture_output=True, text=True,
    )
    assert res.returncode == 0, res.stderr
    assert out.stat().st_size > 0


def test_plot_roofline_script(tmp_path):
    import json

    # The roofline plots single-device GPU rows only (functional CPU
    # rows would be meaningless on a GPU's roofs).
    data = [{"grid": "1024x1024", "devices": 1,
             "iters": 100, "seconds": 0.01, "glups": 10.0,
             "backend": "gpu", "device_kind": "NVIDIA H100 80GB HBM3"},
            {"grid": "64x64", "devices": 1,
             "iters": 100, "seconds": 0.01, "glups": 0.001,
             "backend": "cpu", "device_kind": "cpu",
             "mode": "functional-not-hardware"}]
    f = tmp_path / "sweep.json"
    f.write_text(json.dumps(data))
    out = tmp_path / "roofline.png"
    res = subprocess.run(
        [sys.executable, str(REPO / "scripts/plot_roofline.py"),
         str(f), "-o", str(out)],
        capture_output=True, text=True,
    )
    assert res.returncode == 0, res.stderr
    assert out.stat().st_size > 0


def _load_trace_report():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "trace_report", REPO / "scripts/trace_report.py")
    tr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tr)
    return tr


def _write_trace(tmp_path, events):
    d = tmp_path / "plugins" / "profile" / "run"
    d.mkdir(parents=True)
    (d / "t.trace.json").write_text(json.dumps({"traceEvents": events}))


def test_trace_report_self_time_accounting(tmp_path):
    """summarise() reports gprof-style SELF time for nested host spans
    (nested spans subtract their immediate children per track), full
    kernel time for GPU stream spans, and excludes the aggregate 'XLA
    Modules' lane."""
    tr = _load_trace_report()
    events = [
        {"ph": "M", "pid": 3, "name": "process_name",
         "args": {"name": "/device:GPU:0"}},
        {"ph": "M", "pid": 3, "tid": 2, "name": "thread_name",
         "args": {"name": "XLA Modules"}},
        {"ph": "M", "pid": 3, "tid": 3, "name": "thread_name",
         "args": {"name": "Stream #13(Compute)"}},
        {"ph": "M", "pid": 1, "name": "process_name",
         "args": {"name": "/host:CPU"}},
        # Module lane: one aggregate span over everything (excluded).
        {"ph": "X", "pid": 3, "tid": 2, "name": "jit_sim",
         "ts": 0, "dur": 100.0},
        # Stream lane: two kernel calls and one other kernel.
        {"ph": "X", "pid": 3, "tid": 3, "name": "kernel", "ts": 5,
         "dur": 40.0},
        {"ph": "X", "pid": 3, "tid": 3, "name": "kernel", "ts": 50,
         "dur": 35.0},
        {"ph": "X", "pid": 3, "tid": 3, "name": "glue", "ts": 92,
         "dur": 8.0},
        # Host lane: a dispatch span containing two calls.
        {"ph": "X", "pid": 1, "tid": 1, "name": "PjitFunction",
         "ts": 0, "dur": 90.0},
        {"ph": "X", "pid": 1, "tid": 1, "name": "launch", "ts": 5,
         "dur": 40.0},
        {"ph": "X", "pid": 1, "tid": 1, "name": "launch", "ts": 50,
         "dur": 35.0},
    ]
    _write_trace(tmp_path, events)
    rep = tr.summarise(str(tmp_path))
    by_op = {r["op"]: r for r in rep["ops"]}
    assert "jit_sim" not in by_op  # aggregate lane excluded
    assert by_op["kernel"]["total_us"] == 75.0
    assert by_op["kernel"]["count"] == 2
    assert by_op["glue"]["total_us"] == 8.0
    host = {r["op"]: r for r in rep["host_context"]}
    assert host["PjitFunction"]["self_us"] == 15.0  # 90 - 40 - 35
    assert host["PjitFunction"]["total_us"] == 90.0
    assert host["launch"]["self_us"] == 75.0
    assert "PjitFunction" not in by_op
    # Busy = the union of kernel spans, over the 5..100 window.
    assert rep["device_busy_us"] == 83.0
    assert rep["device_window_us"] == 95.0
    assert rep["device_idle_share"] == round(1 - 83 / 95, 4)
    assert by_op["kernel"]["pct_busy"] == round(100 * 75 / 83, 2)


def test_trace_report_concurrent_kernels(tmp_path):
    """Kernels of one CUDA graph can overlap on a stream: each counts in
    full, and busy time is their union, not their sum."""
    tr = _load_trace_report()
    events = [
        {"ph": "M", "pid": 3, "name": "process_name",
         "args": {"name": "/device:GPU:0"}},
        {"ph": "X", "pid": 3, "tid": 3, "name": "a", "ts": 0, "dur": 10.0},
        {"ph": "X", "pid": 3, "tid": 3, "name": "b", "ts": 4, "dur": 10.0},
        {"ph": "X", "pid": 3, "tid": 3, "name": "c", "ts": 30, "dur": 10.0},
    ]
    _write_trace(tmp_path, events)
    rep = tr.summarise(str(tmp_path))
    by_op = {r["op"]: r for r in rep["ops"]}
    assert by_op["a"]["total_us"] == by_op["b"]["total_us"] == 10.0
    assert rep["device_busy_us"] == 24.0
    assert rep["device_window_us"] == 40.0
    assert rep["device_idle_share"] == 0.4


def test_full_scenes_script(tmp_path):
    """scripts/full_scenes.py mechanics on a tiny synthetic scene: the
    float32 and float64 CLI legs run, the drift gate passes, and
    --append merges."""
    scene_dir = tmp_path / "scenes"
    scene_dir.mkdir()
    (scene_dir / "input_32x16.params").write_text(
        "32\n16\n20\n10\n0.1\n0.005\n1.85\n"
    )
    res = subprocess.run(
        [sys.executable, str(REPO / "scripts/generate_obstacles.py"),
         "32", "16", "-o", str(scene_dir / "obstacles_32x16.dat")],
        capture_output=True, text=True,
    )
    assert res.returncode == 0, res.stderr

    out = tmp_path / "full_scenes.json"
    cmd = [sys.executable, str(REPO / "scripts/full_scenes.py"),
           "--scenes", "32x16", "--scene-dir", str(scene_dir), "-o",
           str(out)]
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    res = subprocess.run(cmd, capture_output=True, text=True, env=env)
    assert res.returncode == 0, res.stdout + res.stderr
    data = json.loads(out.read_text())
    assert data["ok"] is True
    (row,) = data["scenes"]
    assert row["pass"] is True
    assert 0 < row["max_av_vels_pct"] <= data["gate_pct"]
    assert row["float32"]["reynolds"] == pytest.approx(
        row["float64"]["reynolds"], rel=1e-4)

    # --append replaces the re-run scene's row and keeps others.
    data["scenes"].append({"scene": "other", "pass": True})
    out.write_text(json.dumps(data))
    res = subprocess.run(cmd + ["--append"], capture_output=True,
                         text=True, env=env)
    assert res.returncode == 0, res.stdout + res.stderr
    data = json.loads(out.read_text())
    assert {s["scene"] for s in data["scenes"]} == {"32x16", "other"}
    assert sum(s["scene"] == "32x16" for s in data["scenes"]) == 1


def test_full_scenes_cli_leg_timeout_is_returned_not_raised(monkeypatch):
    """A CLI leg that hits its subprocess timeout comes back as an error
    row, not an exception that would abort the remaining scenes."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "fs_timeout", REPO / "scripts/full_scenes.py")
    fs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fs)

    def raise_timeout(*a, **k):
        raise subprocess.TimeoutExpired(cmd="lbm", timeout=5)

    monkeypatch.setattr(fs.subprocess, "run", raise_timeout)
    leg = fs._run_cli("32x16", Path("/nonexistent"), "float32",
                      Path("/tmp"), timeout=5.0)
    assert "timed out" in leg["error"]
    row = fs.run_scene("32x16", Path("/nonexistent"), Path("/tmp"), 0.3,
                       5.0)
    assert row["pass"] is False and row["precision"] == "float32"


def _import_bench():
    sys.path.insert(0, str(REPO))
    import bench

    return bench


def test_bench_refuses_without_gpu(capsys):
    """On a machine whose JAX has no GPU, bench.py exits 1, says so, and
    prints no rate."""
    bench = _import_bench()
    assert bench.main() == 1
    out, err = capsys.readouterr()
    assert out == ""
    assert "no GPU found" in err


def test_bench_lines_carry_device_fields(monkeypatch, capsys):
    """One JSON line per grid, in grid order, each naming the device and
    the card's name and power limit."""
    import jax

    bench = _import_bench()
    from lbm_tpu import device

    monkeypatch.setattr(device, "require_gpu", lambda count=1: jax.devices())
    monkeypatch.setattr(device, "query_card",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.setattr(bench, "measure", lambda params, obstacles: {
        "glups": 12.4, "compile_s": 1.5, "best_s": 0.25})
    monkeypatch.setattr(bench, "scene", lambda nx, ny, iters: (None, None))
    assert bench.main() == 0
    lines = [json.loads(s) for s in
             capsys.readouterr().out.strip().splitlines()]
    assert [ln["metric"] for ln in lines] == [m for m, *_ in bench.GRIDS]
    for ln in lines:
        assert ln["platform"] == jax.devices()[0].platform
        assert ln["device_kind"] == jax.devices()[0].device_kind
        assert ln["device_count"] == len(jax.devices())
        assert ln["card"] == "NVIDIA H100 80GB HBM3"
        assert ln["power_limit"] == "700.00 W"
        assert ln["value"] == 12.4 and ln["compile_s"] == 1.5


def test_bench_measure_times_a_whole_run():
    """bench.measure on a tiny grid: compile timed apart from the run,
    a finite rate and the program's memory analysis."""
    bench = _import_bench()
    params, obstacles = bench.scene(32, 16, 20)
    m = bench.measure(params, obstacles, repeats=1)
    assert m["compile_s"] > 0 and m["best_s"] > 0
    assert m["glups"] == pytest.approx(32 * 16 * 20 / m["best_s"] / 1e9)
    assert "argument_size_in_bytes" in m["memory_analysis"]
