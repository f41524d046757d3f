# CI entry points (the reference's .travis.yml:5-7 analog:
# build + full-tier test run; release mode un-gates the corpus grid).
#
# The unit tiers force the CPU backend with an 8-device virtual mesh
# (tests/conftest.py); the gpu and bench targets need an NVIDIA GPU.

PY ?= python
PYTEST = JAX_PLATFORMS=cpu PYTHONPATH=. $(PY) -m pytest

.PHONY: test test-release test-gpu smoke bench scaling fuzz ci

# Fast tier: every unit/differential/integration test that runs in debug
# builds of the reference (artificial corpus included, grid gated).
test:
	$(PYTEST) tests/ -q

# Release tier: adds the full corpus x config grid + the size contract
# (the reference's `cargo test --release`).
test-release:
	$(PYTEST) tests/ -q --runslow -s

# Compiled kernels vs their references on the card (skips without a GPU).
test-gpu:
	REDUX_TEST_PLATFORM=cuda PYTHONPATH=. $(PY) -m pytest tests/ -q -m gpu

# The main path on one GPU, end to end (one JSON line last).
smoke:
	$(PY) chip_smoke.py

# Benchmark (one JSON line; fails without a GPU).
bench: test-gpu
	$(PY) bench.py

scaling:
	JAX_PLATFORMS=cpu PYTHONPATH=. $(PY) scripts/scaling_bench.py

# Bounded randomized differential bug hunt (default 20 minutes): the
# GPU coder kernels (interpret mode) + generic device-path coders vs the
# oracle.
fuzz:
	$(PY) scripts/fuzz_campaign.py $(or $(MINUTES),20)

ci: test
