# lbm_tpu build / check harness (the reference Makefile's contract:
# `make check` compares outputs against golden data, Makefile:10-17).

PY ?= python

FINAL_STATE_FILE ?= ./final_state.dat
AV_VELS_FILE ?= ./av_vels.dat

.PHONY: all native test test-full check bench smoke validate clean

all: native

# Build the native C extension (fast .dat writers/parsers).
native:
	$(PY) setup.py build_ext --inplace

# Default fast profile: pyproject addopts deselect `slow`. The tests
# run on the CPU with 8 virtual devices (tests/conftest.py).
test:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/ -x -q

# Full suite including the slow tests.
test-full:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/ -x -q -m ""

# The reference's `make check`: pass REF_AV_VELS_FILE and
# REF_FINAL_STATE_FILE (its check/ golden files) on the command line.
check:
	$(PY) -m lbm_tpu.check --ref-av-vels-file=$(REF_AV_VELS_FILE) \
	    --ref-final-state-file=$(REF_FINAL_STATE_FILE) \
	    --av-vels-file=$(AV_VELS_FILE) --final-state-file=$(FINAL_STATE_FILE)

# GPU only: exits 1 without one.
bench:
	$(PY) bench.py

# GPU only: the main path on the card, gated (chip_smoke.py).
smoke:
	$(PY) chip_smoke.py

# The golden-bearing scenes (scenes/) through the CLI, gated against
# goldens/ with check.py's formula (writes validate_scenes.json).
validate:
	$(PY) scripts/validate_scenes.py

clean:
	rm -rf build lbm_tpu/*.so
	find . -name __pycache__ -type d -prune -exec rm -rf {} +
