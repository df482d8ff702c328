"""Profiling and roofline reporting.

The reference's observability was gettimeofday phase timers
(d2q9-bgk.c:174-226), gprof flat profiles (profiling/), and Intel Advisor
rooflines (roofline/). The equivalents here:

- :class:`PhaseTimers` — the same 4-phase init/compute/collate/total
  breakdown;
- :func:`trace` — a jax.profiler trace context manager (view in
  TensorBoard / xprof, or summarise with scripts/trace_report.py);
- :func:`roofline_report` — GLUPS, effective memory bandwidth and FLOP/s
  for a measured run against the device's published peaks (the
  Advisor-roofline analogue). The fused step's arithmetic intensity
  under this model is FLOPS_PER_CELL / BYTES_PER_CELL_F32_MASK ≈ 1.7
  FLOP/B — higher than the reference's 0.43–0.53
  (report_mpi/report.tex:158) because these flops count the
  divide/sqrt expansions, but far below the ridge of any table entry:
  the step is memory-bound (docs/PERF.md "Cost model" uses these exact
  constants).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import jax

# Per-cell cost model of the fused step (d2q9-bgk.c:284-335): 9 reads +
# 9 writes of f32 distributions + the obstacle mask byte(s), ~130 flops
# (incl. divides/sqrt expansions), 1 sqrt. docs/PERF.md derives its
# roofline ceilings from the same constants.
BYTES_PER_CELL_F32_MASK = (9 + 9) * 4 + 4
FLOPS_PER_CELL = 130

# Published peaks, keyed by ``jax.devices()[0].device_kind``: memory
# bandwidth in GB/s and the float32 rate outside the tensor cores (the
# step has no matrix products). A device that is not listed is an error,
# never a default.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_gbps": 3350,
        "tflops_f32": 67.0,
        "source": "NVIDIA H100 Tensor Core GPU datasheet, SXM5 part: "
                  "3.35 TB/s HBM3, 67 TFLOP/s FP32",
    },
}


def device_peaks(device_kind: str) -> dict:
    """The :data:`DEVICE_PEAKS` entry for ``device_kind``."""
    try:
        return DEVICE_PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device {device_kind!r}; known: "
            f"{sorted(DEVICE_PEAKS)}"
        ) from None


@dataclasses.dataclass
class PhaseTimers:
    """init/compute/collate wall-clock phases (d2q9-bgk.c:174-226)."""

    _marks: dict = dataclasses.field(default_factory=dict)
    elapsed: dict = dataclasses.field(default_factory=dict)

    def start(self, phase: str) -> None:
        self._marks[phase] = time.perf_counter()

    def stop(self, phase: str) -> None:
        self.elapsed[phase] = time.perf_counter() - self._marks.pop(phase)

    @contextlib.contextmanager
    def phase(self, name: str):
        self.start(name)
        try:
            yield
        finally:
            self.stop(name)

    def report(self) -> str:
        lines = []
        for name in ("init", "compute", "collate", "total"):
            if name in self.elapsed:
                lines.append(
                    "Elapsed %s time:\t\t\t%.6f (s)" % (name.capitalize(), self.elapsed[name])
                )
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace around a region (TensorBoard-viewable)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def roofline_report(nx: int, ny: int, iters: int, seconds: float,
                    device_kind: str) -> dict:
    """Throughput of a measured run against the device's published
    roofs (one HBM pass per step)."""
    peaks = device_peaks(device_kind)
    cells = nx * ny * iters
    glups = cells / seconds / 1e9
    gbps = cells * BYTES_PER_CELL_F32_MASK / seconds / 1e9
    gflops = cells * FLOPS_PER_CELL / seconds / 1e9
    ai = FLOPS_PER_CELL / BYTES_PER_CELL_F32_MASK
    ridge = peaks["tflops_f32"] * 1e3 / peaks["hbm_gbps"]
    return {
        "glups": glups,
        "effective_gbps": gbps,
        "effective_gflops": gflops,
        "hbm_utilisation": gbps / peaks["hbm_gbps"],
        "flops_utilisation": gflops / (peaks["tflops_f32"] * 1e3),
        "arithmetic_intensity": ai,
        # Bandwidth speed-of-light for this step on this device.
        "ceiling_glups": peaks["hbm_gbps"] / BYTES_PER_CELL_F32_MASK,
        "bound": "memory" if ai < ridge else "compute",
    }
