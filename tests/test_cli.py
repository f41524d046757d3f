"""CLI parity tests (reference src/main.rs).

Covers flag parsing, stdin/stdout defaults, exit codes 1/2/3, the stderr
ratio summary, both formats, and format auto-detection on decompress.
"""

import os
import subprocess
import sys

import pytest

from conftest import corpus_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli(args, stdin=b"", env_extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    if env_extra:
        env.update(env_extra)
    return subprocess.run(
        [sys.executable, "-m", "redux_tpu.cli", *args],
        input=stdin,
        capture_output=True,
        env=env,
        cwd=REPO,
        timeout=240,
    )


def test_usage_exit_code_1():
    # No mode flag -> usage + exit 1 (main.rs:87).
    r = run_cli([])
    assert r.returncode == 1
    assert b"Usage:" in r.stderr
    assert run_cli(["-x"]).returncode == 1
    assert run_cli(["-c", "-i"]).returncode == 1  # missing value (main.rs:44-47)


def test_missing_input_file_exit_code_2(tmp_path):
    r = run_cli(["-c", "-i", str(tmp_path / "nope.bin")])
    assert r.returncode == 2


def test_codec_error_exit_code_3():
    # Truncated garbage in reference format -> codec error (main.rs:118).
    r = run_cli(["-d"], stdin=b"\x01")
    assert r.returncode == 3


def test_stdin_stdout_roundtrip():
    data = b"stdin/stdout roundtrip data " * 40
    c = run_cli(["-c", "--block-size", "512"], stdin=data)
    assert c.returncode == 0, c.stderr
    assert b"Compressed" in c.stderr and b"ratio" in c.stderr
    d = run_cli(["-d"], stdin=c.stdout)
    assert d.returncode == 0, d.stderr
    assert d.stdout == data
    assert b"Decompressed" in d.stderr


def test_file_roundtrip(tmp_path):
    src = corpus_file("calgary", "paper4")
    comp = tmp_path / "paper4.rxt"
    out = tmp_path / "paper4.out"
    c = run_cli(["-c", "-i", str(src), "-o", str(comp), "--block-size", "512"])
    assert c.returncode == 0, c.stderr
    d = run_cli(["-d", "-i", str(comp), "-o", str(out)])
    assert d.returncode == 0, d.stderr
    assert out.read_bytes() == src.read_bytes()


def test_reference_format_roundtrip():
    # --format redux emits a bare reference stream; decode auto-detects.
    data = b"reference single-stream format" * 10
    c = run_cli(["-c", "--format", "redux"], stdin=data)
    assert c.returncode == 0, c.stderr
    from redux_tpu.oracle import compress_bytes

    assert c.stdout == compress_bytes(data)  # byte-identical to reference CLI
    d = run_cli(["-d"], stdin=c.stdout)
    assert d.returncode == 0
    assert d.stdout == data


def test_custom_params():
    data = b"custom parameter roundtrip" * 20
    c = run_cli(["-c", "--params", "8,15,17", "--block-size", "512"], stdin=data)
    assert c.returncode == 0, c.stderr
    d = run_cli(["-d"], stdin=c.stdout)
    assert d.returncode == 0
    assert d.stdout == data
    assert run_cli(["-c", "--params", "8,9,16"], stdin=b"x").returncode == 1


@pytest.mark.parametrize("flag", ["--no-prior"])
def test_no_prior_flag(flag):
    data = bytes(range(256)) * 64
    c = run_cli(["-c", flag, "--block-size", "512"], stdin=data)
    assert c.returncode == 0, c.stderr
    d = run_cli(["-d"], stdin=c.stdout)
    assert d.stdout == data
