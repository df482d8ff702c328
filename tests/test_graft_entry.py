"""The driver-facing contract of ``__graft_entry__``.

The round driver compile-checks ``entry()`` single-chip and executes
``dryrun_multichip(n)`` on a virtual CPU mesh; until now nothing in the
suite imported the module, so a refactor of the underlying APIs
(Params fields, fused_step signature, halo entry points) could break
the driver's gate without any test going red.
"""

import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = str(pathlib.Path(__file__).resolve().parents[1])
# Module-level so EITHER test can import __graft_entry__ when run in
# isolation (pytest only auto-inserts tests/, not the repo root).
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def test_entry_returns_jittable_step_and_args():
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    cells, tot_u = out
    assert cells.shape == args[0].shape
    assert cells.dtype == args[0].dtype
    np.testing.assert_array_equal(np.isfinite(np.asarray(cells)), True)
    assert np.isfinite(float(tot_u))


@pytest.mark.slow
def test_dryrun_multichip_subprocess():
    # dryrun_multichip self-provisions its own virtual mesh in a
    # subprocess, so it is safe to invoke from the 8-device suite
    # process; 2 devices keeps the four sharding configs cheap.
    res = subprocess.run(
        [sys.executable, "-c",
         "import __graft_entry__ as g; g.dryrun_multichip(2)"],
        capture_output=True, text=True, cwd=REPO,
        # Above dryrun_multichip's own inner 1800 s subprocess timeout,
        # so a slow-but-diagnosable inner failure surfaces as its
        # RuntimeError (with captured output) rather than an opaque
        # outer TimeoutExpired (advisor finding).
        timeout=2100,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    # Every sharding case must report, not just the first (a partial
    # hang masked by capture would still contain one 'ok').
    n_cases = res.stdout.count("] ok:")
    import __graft_entry__ as g

    expected = len(g._dryrun_cases(2))
    assert n_cases == expected, (
        f"expected {expected} dryrun case lines, saw {n_cases}:\n"
        + res.stdout
    )
