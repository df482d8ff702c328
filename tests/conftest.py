"""Test configuration: force an 8-virtual-device CPU platform BEFORE jax
initialises, so sharded paths are testable without a cluster (SURVEY.md
§4), and point the tests at the repo-owned scenes and goldens.
"""

from lbm_tpu.parallel.decomp import provision_virtual_cpu

provision_virtual_cpu(8)

import pathlib

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
SCENES = REPO / "scenes"
GOLDENS = REPO / "goldens"


def golden(scene: str) -> dict:
    """The float64 golden arrays of ``scene`` (goldens/*.f64.npz)."""
    with np.load(GOLDENS / f"{scene}.final_state.f64.npz") as z:
        return {k: z[k] for k in ("av_vels", "pressure", "u")}


@pytest.fixture(scope="session")
def params_128():
    from lbm_tpu.params import load_params

    return load_params(SCENES / "input_128x128.params")


@pytest.fixture(scope="session")
def obstacles_128(params_128):
    from lbm_tpu.obstacles import load_obstacles

    return load_obstacles(
        SCENES / "obstacles_128x128.dat", params_128.nx, params_128.ny
    )


@pytest.fixture
def gpu():
    """Skip unless a GPU is present. Asked of a child process that is not
    pinned to the CPU, since this test process is (above)."""
    import os
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    res = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        capture_output=True, text=True, env=env, timeout=300,
    )
    if res.stdout.strip() != "gpu":
        pytest.skip("needs a GPU (JAX found none)")
    return env


_SESSION_T0 = None


def pytest_sessionstart(session):
    # Wall-clock origin for the full-suite record below; a module global
    # rather than TerminalReporter._sessionstarttime, which does not
    # exist in this pytest version (the attribute crash cost a 25-min
    # green run its record).
    global _SESSION_T0
    import time as _time

    _SESSION_T0 = _time.time()


def pytest_terminal_summary(terminalreporter, exitstatus, config):
    """Record each passing FULL-profile run (`make test-full`, i.e.
    `pytest tests/ -m ""`) in docs/artifacts/test_full_record.json —
    VERDICT r4 #4: the fast profile is re-proven every round, but
    nothing recorded when the full 26-slow-test suite last passed.
    Partial invocations (per-file, -k, fast profile) are not records of
    the full suite and are skipped."""
    if (
        exitstatus != 0
        or config.getoption("markexpr")
        or config.getoption("keyword")
        or [pathlib.Path(a).name for a in config.args] != ["tests"]
    ):
        return
    stats = terminalreporter.stats
    counts = {k: len(stats.get(k, [])) for k in
              ("passed", "failed", "skipped", "deselected")}
    if counts["deselected"] or not counts["passed"]:
        return
    import datetime
    import json
    import time as _time

    record = {
        "date": datetime.datetime.now(datetime.timezone.utc).isoformat(
            timespec="seconds"
        ),
        "profile": "full",
        **counts,
        "duration_s": (
            round(_time.time() - _SESSION_T0, 1) if _SESSION_T0 else None
        ),
    }
    out = pathlib.Path(__file__).parent.parent / "docs" / "artifacts" \
        / "test_full_record.json"
    try:
        try:
            history = json.loads(out.read_text()) if out.exists() else []
        except ValueError:
            # Corrupt existing artifact (this hook rewrites the file —
            # a killed run can truncate it): start fresh rather than
            # turning a green 23-minute full run into an INTERNALERROR
            # (review finding; JSONDecodeError is a ValueError).
            history = []
        if not isinstance(history, list):
            history = []
        history = (history + [record])[-10:]
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(history, indent=2) + "\n")
        terminalreporter.write_line(f"full-suite record -> {out}")
    except OSError:
        pass  # a read-only checkout must not fail the suite
