"""Compiled GPU kernels against their references, on the card.

The CPU tiers run the Pallas kernels in interpret mode; only a GPU run
shows what the Triton route compiles.  This test runs phase 2 of
``chip_smoke.py`` (kernels vs the XLA scans and the native twin, at the
shipped block size); the division the kernels run is checked on the card
in ``test_triton_coder.py``.  The ``gpu`` fixture skips it
unless JAX's backend is a GPU:

    REDUX_TEST_PLATFORM=cuda python -m pytest -m gpu tests/
"""

import pytest


@pytest.mark.gpu
def test_kernels_match_references_on_gpu(gpu):
    import chip_smoke

    chip_smoke.check_kernels(n_bytes=10_000_000)
