"""Golden reference-format streams: the format can never drift silently.

The fixtures in tests/golden/ were produced by the native C++ port of the
reference codec (same algorithm as the reference's src/codec.rs; the
bit-level format itself is locked by the transcribed bitio golden vectors
in tests/test_bitio.py).  The tests need no source files: each fixture
decodes to bytes whose sha256 is pinned here, and re-encoding those bytes
must give the fixture back, byte for byte — standing in for
"reference-produced archives decode byte-exactly" in an environment
without a Rust toolchain.
"""

import hashlib
import pathlib

import pytest

from redux_tpu import corpus, native, oracle
from redux_tpu.models import AdaptiveFenwickModel
from redux_tpu.params import Parameters

GOLDEN = pathlib.Path(__file__).parent / "golden"

# fixture, params, decoded length, sha256 of the decoded bytes
CASES = [
    ("paper5_8_30_32.rdx", Parameters.default(), 11954,
     "7a4b1ee6aa419ca362a9bbae383287fe8fee4324c9d6aefa7e94b6d845452ee8"),
    ("alphabet_8_14_16.rdx", Parameters(8, 14, 16), 4096,
     "bc45051ac426475f459ec0b0c88a6646d037b8dfb1b9fa3ca3ef9203ce33e283"),
    ("a_8_30_32.rdx", Parameters.default(), 1,
     "ca978112ca1bbdcafac231b39a23dc4da786eff8147c4e72b9807785afee48bb"),
    ("random4k_8_22_24.rdx", Parameters(8, 22, 24), 4096,
     "89b08d3373e55d29b18a8b4b58340a81501dbf43afc1208883d666fea8eb957b"),
]


def _case(fixture, params, n, digest):
    golden = (GOLDEN / fixture).read_bytes()
    data = native.decompress_bytes(golden, params)
    assert len(data) == n and hashlib.sha256(data).hexdigest() == digest
    return data, golden


@pytest.mark.parametrize("fixture,params,n,digest", CASES)
def test_native_matches_golden(fixture, params, n, digest):
    data, golden = _case(fixture, params, n, digest)
    assert native.compress_bytes(data, params) == golden


@pytest.mark.parametrize("fixture,params,n,digest", CASES[1:3])
def test_oracle_matches_golden(fixture, params, n, digest):
    data, golden = _case(fixture, params, n, digest)
    model = AdaptiveFenwickModel(params)
    assert oracle.compress_bytes(data, model) == golden
    assert oracle.decompress_bytes(golden, AdaptiveFenwickModel(params)) == data


def test_golden_sources_of_exact_artificial_files():
    """The two artificial fixtures whose sources are known exactly."""
    assert _case(*CASES[1])[0] == corpus.alphabet()[:4096]
    assert _case(*CASES[2])[0] == corpus.A_TXT
