"""The roofline cost model must agree with docs/PERF.md's documented
numbers (one coherent model: 76 B/cell, 130 FLOP/cell; on the H100 the
bandwidth ceiling is 3350/76 ~= 44 GLUPS and the float32 ridge is
67e3/3350 = 20 FLOP/B)."""

import pytest

from lbm_tpu.profiling import (
    BYTES_PER_CELL_F32_MASK,
    DEVICE_PEAKS,
    FLOPS_PER_CELL,
    PhaseTimers,
    device_peaks,
    roofline_report,
)

H100 = "NVIDIA H100 80GB HBM3"


def test_cost_model_constants_match_perf_doc():
    assert BYTES_PER_CELL_F32_MASK == 76
    assert FLOPS_PER_CELL == 130
    ai = FLOPS_PER_CELL / BYTES_PER_CELL_F32_MASK
    assert 1.6 < ai < 1.8  # PERF.md: "Arithmetic intensity ~= 1.7 FLOP/B"
    peaks = DEVICE_PEAKS[H100]
    ridge = peaks["tflops_f32"] * 1e3 / peaks["hbm_gbps"]
    assert 19.5 < ridge < 20.5  # PERF.md: "ridge of ~20 FLOP/B"


def test_roofline_report_h100_ceiling():
    cells = 1024 * 1024 * 1000
    # A run at exactly the published bandwidth's speed-of-light.
    seconds = cells * BYTES_PER_CELL_F32_MASK / 3350e9
    r = roofline_report(1024, 1024, 1000, seconds, device_kind=H100)
    assert abs(r["ceiling_glups"] - 3350 / 76) < 1e-9  # ~44 GLUPS
    assert abs(r["glups"] - r["ceiling_glups"]) < 1e-6
    assert abs(r["hbm_utilisation"] - 1.0) < 1e-9
    assert r["bound"] == "memory"
    assert r["flops_utilisation"] < 0.1


def test_phase_timers_report_format():
    t = PhaseTimers()
    with t.phase("init"):
        pass
    with t.phase("compute"):
        pass
    out = t.report()
    assert "Elapsed Init time:" in out and "Elapsed Compute time:" in out


def test_device_peaks_known_kind():
    """The table is keyed by jax's device_kind and names its source."""
    peaks = device_peaks(H100)
    assert (peaks["hbm_gbps"], peaks["tflops_f32"]) == (3350, 67.0)
    assert "datasheet" in peaks["source"]


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H100 PCIe", ""])
def test_roofline_unknown_chip_rejected(kind):
    """Unknown devices raise instead of silently using another device's
    peaks."""
    with pytest.raises(ValueError, match="no published peaks"):
        roofline_report(128, 128, 100, 1.0, device_kind=kind)
