"""Scene layer tests: .params parsing, obstacle masks, state init."""

import numpy as np
import pytest

from lbm_tpu.params import Params, load_params
from lbm_tpu.obstacles import (
    generate_obstacles,
    load_obstacles,
    num_non_obstacles_r,
    write_obstacles,
)
from lbm_tpu.state import D2Q9, initial_state

from conftest import SCENES


def test_load_params_128():
    p = load_params(SCENES / "input_128x128.params")
    assert (p.nx, p.ny, p.max_iters, p.reynolds_dim) == (128, 128, 40000, 10)
    assert p.density == np.float32(0.1)
    assert p.accel == np.float32(0.005)
    assert p.omega == np.float32(1.85)
    # viscosity = (1/6)(2/omega - 1)  (d2q9-bgk.c:676)
    assert np.isclose(p.viscosity, (1 / 6) * (2 / 1.85 - 1), rtol=1e-6)


def test_load_params_missing(tmp_path):
    f = tmp_path / "bad.params"
    f.write_text("128\n128\n")
    with pytest.raises(ValueError, match="maxIters"):
        load_params(f)
    with pytest.raises(FileNotFoundError):
        load_params(tmp_path / "nope.params")


def test_params_validation():
    with pytest.raises(ValueError):
        Params(nx=0, ny=4, max_iters=1, reynolds_dim=1,
               density=0.1, accel=0.005, omega=1.85)


def test_load_obstacles_128():
    mask = load_obstacles(SCENES / "obstacles_128x128.dat", 128, 128)
    # File has 512 lines with 4 duplicate corners -> 508 unique blocked cells.
    assert int(mask.sum()) == 508
    assert mask[0].all() and mask[-1].all()
    assert mask[:, 0].all() and mask[:, -1].all()
    assert not mask[1:-1, 1:-1].any()
    # Normaliser counts unique fluid cells (matches the golden data's
    # original tot_cells count, d2q9-bgk.c:475).
    assert num_non_obstacles_r(mask) == np.float32(1.0 / (128 * 128 - 508))


def test_obstacle_validation(tmp_path):
    f = tmp_path / "obs.dat"
    f.write_text("5 5 2\n")
    with pytest.raises(ValueError, match="blocked"):
        load_obstacles(f, 8, 8)
    f.write_text("9 5 1\n")
    with pytest.raises(ValueError, match="x-coord"):
        load_obstacles(f, 8, 8)
    f.write_text("5 9 1\n")
    with pytest.raises(ValueError, match="y-coord"):
        load_obstacles(f, 8, 8)


def test_generator_matches_reference_mask():
    # obstacles_128x128.dat is the generator's boundary-walls output.
    ref = load_obstacles(SCENES / "obstacles_128x128.dat", 128, 128)
    gen = generate_obstacles(128, 128)
    np.testing.assert_array_equal(ref, gen)


def test_obstacle_roundtrip(tmp_path):
    mask = generate_obstacles(16, 8, interior_walls=True)
    write_obstacles(tmp_path / "m.dat", mask)
    back = load_obstacles(tmp_path / "m.dat", 16, 8)
    np.testing.assert_array_equal(mask, back)


def test_initial_state_values():
    p = Params(nx=8, ny=4, max_iters=1, reynolds_dim=1,
               density=0.1, accel=0.005, omega=1.85)
    cells = np.asarray(initial_state(p))
    assert cells.shape == (9, 4, 8)
    assert cells.dtype == np.float32
    d = np.float32(0.1)
    assert (cells[0] == d * np.float32(4.0) / np.float32(9.0)).all()
    for k in (1, 2, 3, 4):
        assert (cells[k] == d / np.float32(9.0)).all()
    for k in (5, 6, 7, 8):
        assert (cells[k] == d / np.float32(36.0)).all()


def test_d2q9_constants():
    # Opposite pairs are mutual and reverse the velocity.
    for k in range(9):
        o = int(D2Q9.OPP[k])
        assert int(D2Q9.OPP[o]) == k
        assert D2Q9.CX[o] == -D2Q9.CX[k]
        assert D2Q9.CY[o] == -D2Q9.CY[k]
    assert np.isclose(D2Q9.W.sum(), 1.0)


def test_compilation_cache_flag(tmp_path):
    """--compilation-cache, or else JAX_COMPILATION_CACHE_DIR, populates a
    persistent XLA cache dir so repeat scene runs skip recompilation
    (production QoL over the reference's ahead-of-time C build)."""
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    cache = tmp_path / "xla_cache"
    env_cache = tmp_path / "env_cache"

    def run(extra_args, extra_env):
        code = (
            "import jax; jax.config.update('jax_platforms','cpu')\n"
            "from lbm_tpu.cli import main\n"
            f"main([r'{SCENES / 'input_128x128.params'}',"
            f"r'{SCENES / 'obstacles_128x128.dat'}',"
            f"'--iters','100',*{extra_args!r},"
            f"'--av-vels-file',r'{tmp_path / 'av.dat'}',"
            f"'--final-state-file',r'{tmp_path / 'fs.dat'}'])\n"
        )
        res = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True,
            cwd=repo,
            env={"PYTHONPATH": str(repo), "PATH": "/usr/bin:/bin",
                 "JAX_PLATFORMS": "cpu", "HOME": str(tmp_path),
                 **extra_env},
        )
        assert res.returncode == 0, res.stderr[-2000:]

    # The explicit flag.
    run(["--compilation-cache", str(cache)], {})
    assert cache.is_dir() and any(cache.iterdir()), (
        "compilation cache directory should be populated"
    )
    # JAX_COMPILATION_CACHE_DIR, with no flag: the cache goes there.
    run([], {"JAX_COMPILATION_CACHE_DIR": str(env_cache)})
    assert env_cache.is_dir() and any(env_cache.iterdir())


def test_obstacle_parser_accepts_token_stream(tmp_path):
    """The reference's fscanf is newline-agnostic (d2q9-bgk.c:628) and
    the native parser matches it; the numpy fallback must parse the
    same token-stream triplets (review finding: it used to reject
    multi-triplet lines the other parsers accept)."""
    from lbm_tpu.obstacles import load_obstacles

    f = tmp_path / "obs.dat"
    f.write_text("1 1 1 2 2 1\n3 3 1\n")
    mask = load_obstacles(f, 8, 8)
    assert mask[1, 1] and mask[2, 2] and mask[3, 3]
    assert mask.sum() == 3
    # A dangling token is still malformed.
    f.write_text("1 1 1 2 2\n")
    import pytest

    with pytest.raises(ValueError, match="3 values"):
        load_obstacles(f, 8, 8)


def test_initial_state_follows_params_dtype():
    """initial_state/initial_state_np default to params.dtype (review
    finding: a hardcoded f32 default silently rounded f64 validation
    states)."""
    import jax

    from lbm_tpu.params import Params
    from lbm_tpu.state import initial_state, initial_state_np

    p32 = Params(nx=8, ny=8, max_iters=1, reynolds_dim=10,
                 density=0.1, accel=0.005, omega=1.85)
    assert initial_state(p32).dtype == np.float32
    assert initial_state_np(p32).dtype == np.float32
    if jax.config.read("jax_enable_x64"):  # pragma: no cover
        pass  # x64 runs assert the f64 branch in test_float64.py
    assert initial_state_np(p32, dtype=np.float64).dtype == np.float64


def test_av_velocity_coerces_integer_masks():
    """A reference-style int 0/1 obstacle mask must count fluid cells
    correctly (review finding: bitwise ~ on ints marked every cell
    fluid and produced a negative count)."""
    import jax.numpy as jnp

    from lbm_tpu.observables import av_velocity
    from lbm_tpu.params import Params
    from lbm_tpu.state import initial_state

    p = Params(nx=8, ny=8, max_iters=1, reynolds_dim=10,
               density=0.1, accel=0.005, omega=1.85)
    cells = initial_state(p)
    mask_bool = jnp.zeros((8, 8), bool).at[0, :].set(True)
    mask_int = mask_bool.astype(jnp.int32)
    a = float(av_velocity(cells, mask_bool))
    b = float(av_velocity(cells, mask_int))
    assert a == b and np.isfinite(a)


def test_compilation_cache_dir_resolution(monkeypatch):
    """The flag wins, then JAX_COMPILATION_CACHE_DIR, then the fixed
    <checkout>/.jax_cache derived from the package's location."""
    from lbm_tpu import jax_cache

    from conftest import REPO

    assert jax_cache.cache_dir("/x", environ={}) == "/x"
    assert jax_cache.cache_dir(
        None, environ={"JAX_COMPILATION_CACHE_DIR": "/env"}) == "/env"
    assert jax_cache.cache_dir(None, environ={}) == str(REPO / ".jax_cache")
    assert jax_cache.cache_dir(
        "/x", environ={"JAX_COMPILATION_CACHE_DIR": "/env"}) == "/x"


@pytest.mark.parametrize("scene,iters,accel", [
    ("128x128", 40000, 0.005),
    ("128x256", 40000, 0.005),
    ("256x256", 80000, 0.005),
    ("1024x1024", 20000, 0.01),
])
def test_repo_scene_files(scene, iters, accel):
    """The repo-owned scenes: the reference's parameter sets, and masks
    of boundary walls (plus, at 1024x1024, the interior wall at x=341
    that the golden's u == 0 cells show)."""
    nx, ny = (int(v) for v in scene.split("x"))
    p = load_params(SCENES / f"input_{scene}.params")
    assert (p.nx, p.ny, p.max_iters, p.reynolds_dim) == (nx, ny, iters, 10)
    assert (p.density, p.accel, p.omega) == (
        np.float32(0.1), np.float32(accel), np.float32(1.85))
    mask = load_obstacles(SCENES / f"obstacles_{scene}.dat", nx, ny)
    want = generate_obstacles(nx, ny)
    if scene == "1024x1024":
        want[:, 341] = True
        from conftest import golden

        u = golden(scene)["u"].reshape(ny, nx)
        np.testing.assert_array_equal(mask, u == 0)
    np.testing.assert_array_equal(mask, want)
