"""chip_smoke.py's contract, checked on the CPU: its last line, its
refusals, which phases each mode runs, and each phase's mechanics at tiny
sizes (the card runs them at full size)."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from conftest import REPO

sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


@pytest.fixture
def on_cpu(monkeypatch):
    """Let chip_smoke take the virtual CPU devices for GPUs."""
    import jax

    asked = []

    def fake_require_gpu(count=1):
        asked.append(count)
        return jax.devices()[:count]

    monkeypatch.setattr(chip_smoke, "require_gpu", fake_require_gpu)
    monkeypatch.setattr(chip_smoke, "query_card", lambda: CARD)
    return asked


def _last_json(out):
    lines = out.strip().splitlines()
    return json.loads(lines[-1]) if lines else None


def test_refuses_without_gpu():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, env=env)
    assert res.returncode != 0
    assert "no GPU found" in res.stderr
    assert '"ok"' not in res.stdout


def test_fails_alone_without_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": ""}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, env=env)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_last_line_contract(on_cpu, monkeypatch, capsys):
    import jax

    ran = []
    monkeypatch.setattr(chip_smoke, "run_one_card", lambda card: ran.append(card))
    assert chip_smoke.main([]) == 0
    out = capsys.readouterr().out
    assert _last_json(out) == {"ok": True, "device": {
        "platform": jax.devices()[0].platform,
        "kind": jax.devices()[0].device_kind,
        "count": len(jax.devices()),
    }}
    # The card's nvidia-smi line is printed verbatim on a line of its own.
    assert CARD in out.splitlines()
    assert ran == [CARD] and on_cpu == [1]


def test_four_cards_runs_only_the_mesh_phase(on_cpu, monkeypatch, capsys):
    ran = []
    monkeypatch.setattr(chip_smoke, "run_one_card",
                        lambda card: pytest.fail("one-card phases ran"))
    monkeypatch.setattr(chip_smoke, "phase_four_cards",
                        lambda card: ran.append(card))
    assert chip_smoke.main(["--four-cards"]) == 0
    assert ran == [CARD] and on_cpu == [chip_smoke.N_CARDS] == [4]
    assert _last_json(capsys.readouterr().out)["ok"] is True


@pytest.mark.parametrize("mode", [[], ["--four-cards"]])
def test_failed_phase_exits_nonzero(on_cpu, monkeypatch, capsys, mode):
    def boom(card):
        raise RuntimeError("phase failed on purpose")

    monkeypatch.setattr(chip_smoke, "run_one_card", boom)
    monkeypatch.setattr(chip_smoke, "phase_four_cards", boom)
    assert chip_smoke.main(mode) == 1
    out, err = capsys.readouterr()
    assert '"ok"' not in out
    assert "phase failed on purpose" in err


@pytest.mark.parametrize("line,want", [
    ("NVIDIA H100 80GB HBM3, 700.00 W", ("NVIDIA H100 80GB HBM3", "700.00 W")),
    ("NVIDIA H100 80GB HBM3, 400.00 W", ("NVIDIA H100 80GB HBM3", "400.00 W")),
    ("Some, Card, Name, [N/A]", ("Some, Card, Name", "[N/A]")),
])
def test_parse_card(line, want):
    assert chip_smoke.parse_card(line) == want


@pytest.mark.parametrize("line", ["", "no comma here", ", 700 W", "card,"])
def test_parse_card_refuses_malformed(line):
    with pytest.raises(ValueError):
        chip_smoke.parse_card(line)


def test_phase_stress_tiny(capsys):
    """float32 against float64 on one device within the budget, then the
    steady rate."""
    m = chip_smoke.phase_stress(64, 16, 20, CARD)
    assert m["label"] == "64x16" and m["glups"] > 0
    out = capsys.readouterr().out
    assert "float32 vs float64" in out and CARD in out


def test_phase_four_cards_tiny(monkeypatch, capsys):
    """The sharded phase on 4 of the virtual devices: a divisor scene and
    a wall-less non-divisor one, each against its one-device run."""
    monkeypatch.setattr(chip_smoke, "FOUR_CARD_RUNS", [
        ("64x32", 64, 32, 12, False),
        ("wall-less 32x22", 32, 22, 12, True),
    ])
    chip_smoke.phase_four_cards(CARD)
    out = capsys.readouterr().out
    assert "padding none" in out and "padding wrap (2 rows)" in out
    assert out.count("shards on [0, 1, 2, 3]") == 2


def test_phase_bandwidth_tiny(capsys):
    rates = [{"label": "a", "glups": 1.0}]
    gbps = chip_smoke.phase_bandwidth(rates, CARD, nbytes=1 << 20)
    assert gbps > 0
    assert "1/share" in capsys.readouterr().out


@pytest.mark.parametrize("scale,passes", [(1.0, True), (1.05, False)])
def test_phase_scene_tiny(tmp_path, scale, passes, capsys):
    """The CLI in-process on a tiny scene, gated against a golden made
    from its own outputs (scaled by 5% to make it fail)."""
    from lbm_tpu.io import load_av_vels, load_final_state
    from lbm_tpu.obstacles import generate_obstacles, write_obstacles

    (tmp_path / "input_32x16.params").write_text(
        "32\n16\n30\n10\n0.1\n0.005\n1.85\n")
    write_obstacles(tmp_path / "obstacles_32x16.dat",
                    generate_obstacles(32, 16))
    from lbm_tpu.cli import main as cli_main

    av, fs = tmp_path / "av.dat", tmp_path / "fs.dat"
    assert cli_main([str(tmp_path / "input_32x16.params"),
                     str(tmp_path / "obstacles_32x16.dat"),
                     "--av-vels-file", str(av),
                     "--final-state-file", str(fs)]) == 0
    np.savez(tmp_path / "32x16.final_state.f64.npz",
             av_vels=load_av_vels(av) * scale,
             pressure=load_final_state(fs)[:, 2])
    capsys.readouterr()
    if passes:
        m = chip_smoke.phase_scene("32x16", CARD, scene_dir=tmp_path,
                                   golden_dir=tmp_path)
        assert m["label"] == "32x16" and m["iters"] == 30
        assert "Init (compile)" in capsys.readouterr().out
    else:
        with pytest.raises(RuntimeError, match="gate failed"):
            chip_smoke.phase_scene("32x16", CARD, scene_dir=tmp_path,
                                   golden_dir=tmp_path)
        assert "FLAG: over the 0.3% drift budget" in capsys.readouterr().out


@pytest.mark.gpu
def test_chip_smoke_on_the_card(gpu):
    """The whole default run on a real GPU (skips elsewhere)."""
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, env=gpu,
                         timeout=1200)
    assert res.returncode == 0, res.stderr[-3000:]
    last = _last_json(res.stdout)
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
