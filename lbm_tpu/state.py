"""Lattice constants and state initialisation.

State layout is planar SoA: one ``(9, ny, nx)`` float32 array — the
analogue of the reference's nine separately-allocated speed planes
(``t_speed``, d2q9-bgk.c:90-100). ``nx`` is the contiguous minor axis
(every shipped grid has nx a multiple of 128, the same alignment contract
the reference exploited with ``__assume(params.nx % 16 == 0)``,
d2q9-bgk.c:291), so consecutive GPU threads read consecutive cells; the 9
speeds are the major axis so each plane is a contiguous 2-D image.

Speed numbering (d2q9-bgk.c:7-13)::

    6 2 5
     \\|/
    3-0-1
     /|\\
    7 4 8
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from lbm_tpu.params import Params


class D2Q9:
    """D2Q9 lattice constants."""

    Q = 9
    # Velocity components, indexed by speed (d2q9-bgk.c:7-13).
    CX = np.array([0, 1, 0, -1, 0, 1, -1, -1, 1], dtype=np.int32)
    CY = np.array([0, 0, 1, 0, -1, 1, 1, -1, -1], dtype=np.int32)
    # Quadrature weights (d2q9-bgk.c:272-274).
    W = np.array(
        [4.0 / 9.0] + [1.0 / 9.0] * 4 + [1.0 / 36.0] * 4, dtype=np.float32
    )
    # Opposite ("bounce-back mirror") speed for each speed: the obstacle
    # branch of the fused kernel writes speed k from streamed speed OPP[k]
    # (d2q9-bgk.c:325-333).
    OPP = np.array([0, 3, 4, 1, 2, 7, 8, 5, 6], dtype=np.int32)
    # (The east/west forcing sets of d2q9-bgk.c:254-261 and the
    # equilibrium expansion constants of d2q9-bgk.c:269-271 live where
    # they are computed — ops/reference.py builds them in the working
    # dtype — rather than duplicated here.)


def initial_state(params: Params, dtype=None) -> jnp.ndarray:
    """Uniform equilibrium-at-rest initial distributions (d2q9-bgk.c:584-604).

    speed 0 = density*4/9, axis speeds = density/9, diagonals = density/36,
    everywhere (obstacle cells included). ``dtype`` defaults to
    ``params.dtype`` (review finding: a float32 default silently
    f32-rounded the state of float64 validation runs unless every
    caller remembered to pass it); float64 gives the original
    coursework code's precision (the golden data's), for validation
    runs on CPU with jax_enable_x64.
    """
    dtype = params.dtype if dtype is None else dtype
    d = np.dtype(dtype).type
    w0 = d(params.density) * d(4.0) / d(9.0)
    w1 = d(params.density) / d(9.0)
    w2 = d(params.density) / d(36.0)
    per_speed = np.array([w0, w1, w1, w1, w1, w2, w2, w2, w2], dtype=dtype)
    return jnp.broadcast_to(
        jnp.asarray(per_speed)[:, None, None], (D2Q9.Q, params.ny, params.nx)
    ).astype(dtype)


def initial_state_np(params: Params, dtype=None) -> np.ndarray:
    """NumPy twin of :func:`initial_state` for host-side tooling;
    same ``params.dtype`` default and weight arithmetic."""
    dtype = params.dtype if dtype is None else dtype
    d = np.dtype(dtype).type
    w0 = d(params.density) * d(4.0) / d(9.0)
    w1 = d(params.density) / d(9.0)
    w2 = d(params.density) / d(36.0)
    per_speed = np.array([w0, w1, w1, w1, w1, w2, w2, w2, w2], dtype=dtype)
    return np.broadcast_to(
        per_speed[:, None, None], (D2Q9.Q, params.ny, params.nx)
    ).copy()
