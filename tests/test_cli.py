"""CLI tests: the cram-test role (reference test/bin/simple.t) — pipe
interop with the real zlib/gzip tools both directions."""

import gzip
import os
import subprocess
import sys
import zlib
from pathlib import Path

import pytest

REPO = Path(__file__).parent.parent
ENV = dict(os.environ, JAX_PLATFORMS="cpu")


def run_cli(args, stdin: bytes) -> bytes:
    p = subprocess.run(
        [sys.executable, "-m", "decompress_tpu.cli", *args],
        input=stdin, capture_output=True, cwd=REPO, timeout=560, env=ENV,
    )
    assert p.returncode == 0, p.stderr.decode()
    return p.stdout


@pytest.fixture(scope="module")
def data():
    return (REPO / "tests" / "corpus" / "progc").read_bytes()[:20000]


def test_cli_zlib_pipe(data):
    comp = run_cli(["-f", "zlib", "-l", "6"], data)
    assert zlib.decompress(comp) == data          # real zlib reads ours
    back = run_cli(["-d", "-f", "zlib"], zlib.compress(data, 6))
    assert back == data                            # we read real zlib


def test_cli_deflate_roundtrip(data):
    comp = run_cli(["-f", "deflate"], data)
    assert run_cli(["-d", "-f", "deflate"], comp) == data


def test_cli_gzip_interop(data):
    comp = run_cli(["-f", "gzip", "--filename", "x.txt"], data)
    assert gzip.decompress(comp) == data
    back = run_cli(["-d", "-f", "gzip"], gzip.compress(data, 6))
    assert back == data


def test_cli_lzo_roundtrip(data):
    comp = run_cli(["-f", "lzo"], data)
    assert run_cli(["-d", "-f", "lzo"], comp) == data


def test_cli_level0_stored(data):
    comp = run_cli(["-f", "zlib", "-l", "0"], data)
    assert zlib.decompress(comp) == data
    assert len(comp) >= len(data)


def test_cli_error_on_garbage():
    p = subprocess.run(
        [sys.executable, "-m", "decompress_tpu.cli", "-d", "-f", "zlib"],
        input=b"not a zlib stream", capture_output=True, cwd=REPO, timeout=120, env=ENV,
    )
    assert p.returncode == 1
    assert b"decompress:" in p.stderr
