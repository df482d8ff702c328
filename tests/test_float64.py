"""Float64 validation mode: reproduces the golden data's original
double-precision trajectory to ~1e-10 % (vs ~1e-2 % for f32 drift).

Runs the CLI in a subprocess because jax_enable_x64 is process-global.
"""

import subprocess
import sys

import numpy as np
import pytest

from conftest import REPO, SCENES, golden


@pytest.mark.parametrize("scene,iters", [("256x256", 2000),
                                         ("1024x1024", 200)])
def test_f64_prefix_matches_golden_exactly(tmp_path, scene, iters):
    """The repo scene (params + mask) in float64 reproduces the golden
    av_vels prefix to the 13 significant digits av_vels.dat holds. At
    1024x1024 this also pins the mask: the golden's u == 0 cells are the
    boundary walls plus the interior wall at x = 341."""
    av = tmp_path / "av.dat"
    fs = tmp_path / "fs.dat"
    code = (
        "import jax; jax.config.update('jax_platforms','cpu')\n"
        "from lbm_tpu.cli import main\n"
        f"main([r'{SCENES}/input_{scene}.params',"
        f"r'{SCENES}/obstacles_{scene}.dat',"
        f"'--precision','float64','--iters','{iters}',"
        f"'--av-vels-file',r'{av}','--final-state-file',r'{fs}'])\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, cwd=REPO,
        env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
             "JAX_PLATFORMS": "cpu", "HOME": str(tmp_path)},
    )
    assert res.returncode == 0, res.stderr[-2000:]
    sim = np.loadtxt(av, usecols=[1])
    ref = golden(scene)["av_vels"][:iters]
    pct = 100.0 * np.abs((ref - sim) / ref)
    # Measured ~4e-11 % (the %.12E text rounding).
    assert pct.max() < 1e-9, f"f64 should match golden near-exactly, got {pct.max():.2e}%"
