"""Compute ops: the accelerate-flow forcing and the fused
collide-stream step, in plain jnp left to XLA (:mod:`lbm_tpu.ops.reference`).
"""

from lbm_tpu.ops.reference import (
    accelerate_flow,
    collide_stream,
    fused_step,
)

__all__ = ["accelerate_flow", "collide_stream", "fused_step"]
