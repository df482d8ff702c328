#!/usr/bin/env bash
# Clean-environment build + smoke check — the reference's
# check_submission.sh analogue: rebuild the native extension from scratch,
# verify the package imports, run a short end-to-end simulation of the
# repo's 256x256 scene on the CPU, and gate its trajectory prefix against
# the repo-owned float64 golden.
set -euo pipefail

cd "$(dirname "$0")/.."
echo "== rebuild native extension =="
rm -f lbm_tpu/_native*.so
python setup.py build_ext --inplace >/dev/null
test -f lbm_tpu/_native*.so && echo "native extension built"

echo "== package import =="
python -c "import lbm_tpu; print('lbm_tpu', lbm_tpu.__version__)"

echo "== smoke run (256x256, 100 iters, CPU) =="
TMP=$(mktemp -d)
trap 'rm -rf "$TMP"' EXIT
JAX_PLATFORMS=cpu python -m lbm_tpu \
    scenes/input_256x256.params scenes/obstacles_256x256.dat \
    --iters 100 \
    --av-vels-file "$TMP/av_vels.dat" --final-state-file "$TMP/fs.dat" \
    | grep -E "==done==|Reynolds"

python - "$TMP/av_vels.dat" <<'PY'
import sys
import numpy as np
sim = np.loadtxt(sys.argv[1], usecols=[1])
with np.load("goldens/256x256.final_state.f64.npz") as z:
    ref = z["av_vels"][: len(sim)]
pct = 100 * np.abs((ref - sim) / ref).max()
print(f"golden prefix max diff: {pct:.2e}%")
# The f32 default drifts far under the 1% gate (check/check.py) over
# 100 steps; 0.1% catches real divergence with margin.
assert pct < 0.1, "trajectory prefix diverged from golden data"
PY
echo "check_install OK"
