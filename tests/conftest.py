"""Test configuration.

Tests run on the CPU with 8 virtual devices, so the multi-device sharding
paths run without an accelerator.  Env vars must be set before JAX
initializes its backends, hence at conftest import time.

``REDUX_TEST_PLATFORM=cuda`` runs the suite on the GPU instead (one device,
the real backend); the ``gpu``-marked tests need it:
``REDUX_TEST_PLATFORM=cuda python -m pytest -m gpu tests/``.
"""

import atexit
import os
import pathlib
import shutil
import tempfile

_PLATFORM = os.environ.get("REDUX_TEST_PLATFORM", "cpu")
os.environ["JAX_PLATFORMS"] = _PLATFORM
if _PLATFORM == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

# Some pytest plugins import jax before this conftest runs, making the env
# var too late — force the platform through the config API as well (works
# until a backend is actually initialized).
jax.config.update("jax_platforms", _PLATFORM)

from redux_tpu import corpus  # noqa: E402

_CORPUS_DIR = pathlib.Path(tempfile.mkdtemp(prefix="redux_corpus_"))
atexit.register(shutil.rmtree, _CORPUS_DIR, ignore_errors=True)


def corpus_file(*parts: str) -> pathlib.Path:
    """A seeded stand-in for a reference corpus file (``corpus``, ``name``),
    written once per process (see :func:`redux_tpu.corpus.reference_file`)."""
    path = _CORPUS_DIR.joinpath(*parts)
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(corpus.reference_file(*parts))
    return path


@pytest.fixture
def gpu():
    """Skips the test unless JAX's backend is a GPU (decided at run time)."""
    if jax.default_backend() != "gpu":
        pytest.skip(
            "needs an NVIDIA GPU: REDUX_TEST_PLATFORM=cuda python -m pytest -m gpu tests/"
        )


def pytest_addoption(parser):
    parser.addoption(
        "--runslow",
        action="store_true",
        default=False,
        help="run the full-corpus grid tier (the reference gates these to "
        "release builds, tests/corpora.rs via cfg_attr(debug_assertions))",
    )


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: full-corpus grid (needs --runslow)")
    config.addinivalue_line("markers", "gpu: needs an NVIDIA GPU (the `gpu` fixture skips elsewhere)")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="needs --runslow (corpus grid tier)")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
