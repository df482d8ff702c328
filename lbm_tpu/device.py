"""The accelerator a measurement runs on: the GPU check every benchmark
entry point makes first, and the card's name and power limit as
``nvidia-smi`` reports them (a card set below its maximum power runs
slower under load, so every number is printed beside the limit).

A measurement path that finds no GPU fails; it never falls back to the
CPU.
"""

from __future__ import annotations

import subprocess

NVIDIA_SMI_QUERY = [
    "nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
]


class NoGPUError(RuntimeError):
    """JAX found no GPU (or fewer than the run needs)."""


def require_gpu(count: int = 1):
    """JAX's devices, which must be at least ``count`` GPUs."""
    import jax

    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        raise NoGPUError(
            f"no GPU found: JAX's default devices are {platform!r}"
        )
    if len(devices) < count:
        raise NoGPUError(
            f"{count} GPUs needed, JAX sees {len(devices)}"
        )
    return devices


def device_fields(devices) -> dict:
    """``platform``, ``device_kind`` and ``device_count`` as JAX reports
    them."""
    return {
        "platform": devices[0].platform,
        "device_kind": devices[0].device_kind,
        "device_count": len(devices),
    }


def query_card() -> str:
    """The first card's ``name, power.limit`` line from nvidia-smi, read
    by a child process that does not touch JAX."""
    res = subprocess.run(NVIDIA_SMI_QUERY, capture_output=True, text=True,
                         timeout=60)
    lines = res.stdout.strip().splitlines()
    if res.returncode != 0 or not lines:
        raise RuntimeError(
            f"nvidia-smi failed (rc={res.returncode}): {res.stderr.strip()}"
        )
    return lines[0].strip()


def parse_card(line: str) -> tuple[str, str]:
    """``"NVIDIA H100 80GB HBM3, 700.00 W"`` -> ``(name, power_limit)``."""
    name, sep, limit = line.rpartition(",")
    if not sep or not name.strip() or not limit.strip():
        raise ValueError(f"unexpected nvidia-smi line {line!r}")
    return name.strip(), limit.strip()
