"""Auxiliary subsystems (SURVEY §5): config, profiling, multihost glue,
and golden malformed-bitstream errors with host/native parity
(reference invalids suite, test.ml:193+)."""

import zlib

import numpy as np
import pytest

from decompress_tpu import de, native
from decompress_tpu.core import bitstream, huffman, tables
from decompress_tpu.parallel import multihost
from decompress_tpu.utils import config, profiling


def test_config_validation():
    cfg = config.CodecConfig(level=9, window_bits=12).validate()
    assert cfg.level == 9
    assert config.CodecConfig(level=12).validate().level == 12
    with pytest.raises(ValueError):
        config.CodecConfig(level=13).validate()
    with pytest.raises(ValueError):
        config.CodecConfig(window_bits=7).validate()
    with pytest.raises(ValueError):
        config.CodecConfig(queue_capacity=100).validate()


def test_device_trace_writes_profile(tmp_path):
    import jax.numpy as jnp

    with profiling.device_trace(str(tmp_path)) as d:
        with profiling.annotate("stage"):
            (jnp.arange(10) * 2).block_until_ready()
    assert d == str(tmp_path)
    assert list(tmp_path.rglob("*.xplane.pb"))


@pytest.mark.parametrize("env", [None, "elsewhere"])
def test_compile_cache_dir_rule(monkeypatch, tmp_path, env):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache is
    the checkout's .jax_cache/."""
    from decompress_tpu.utils import cache

    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = cache._CHECKOUT / ".jax_cache"
        assert (cache._CHECKOUT / "decompress_tpu").is_dir()
    else:
        want = tmp_path / env
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(want))
    assert cache.cache_dir() == want


def test_multihost_single_process_degenerates():
    data = b"multi host degenerate path " * 400
    import gzip

    arch = multihost.sharded_gzip_compress_multihost(data, 6, member_size=4096)
    assert gzip.decompress(arch) == data
    multihost.initialize()  # idempotent no-op on one process


def _make_invalid_dynamic_header():
    """Dynamic block with an over-subscribed precode."""
    w = bitstream.BitWriter()
    w.write(1, 1)
    w.write(2, 2)       # dynamic
    w.write(0, 5)       # HLIT = 257
    w.write(0, 5)       # HDIST = 1
    w.write(15, 4)      # HCLEN = 19
    for _ in range(19):
        w.write(1, 3)   # nineteen 1-bit codes: over-subscribed
    w.write(0, 7)
    return w.getvalue()


MALFORMED = [
    # (stream, message, native status: MALFORMED or AWAIT — a streaming
    # machine reports truncation as "need more input"; the one-shot
    # wrapper turns that into the malformed error)
    (b"\x07", "invalid kind of block", native.InflateStream.MALFORMED),
    (b"\x01\x05\x00\x05\x00", "invalid complement of length", native.InflateStream.MALFORMED),
    (b"\x01\x05\x00\xfa\xff\x00", "unexpected end of input", native.InflateStream.AWAIT),
    (_make_invalid_dynamic_header(), "invalid dictionary", native.InflateStream.MALFORMED),
]


@pytest.mark.parametrize("stream,msg,nstatus", MALFORMED, ids=[m[1] for m in MALFORMED])
def test_malformed_error_parity(stream, msg, nstatus):
    """Python reference decoder and native state machine agree on the
    error class for hand-crafted invalid bitstreams."""
    with pytest.raises(de.MalformedError, match=msg.split()[1]):
        de._inflate_python(stream)
    with pytest.raises(de.MalformedError, match=msg.split()[1]):
        de.inflate(stream)  # default (native-backed) path
    if native.available():
        inf = native.InflateStream()
        status, _, _ = inf.run(stream, 1 << 16)
        assert status == nstatus
        if status == native.InflateStream.MALFORMED:
            assert msg in inf.error


def test_hlit_out_of_range():
    w = bitstream.BitWriter()
    w.write(1, 1)
    w.write(2, 2)
    w.write(30, 5)  # HLIT = 287 > 286
    w.write(0, 5)
    w.write(0, 4)
    w.write(0, 40)
    stream = w.getvalue()
    with pytest.raises(de.MalformedError, match="dictionary"):
        de._inflate_python(stream)
    if native.available():
        inf = native.InflateStream()
        status, _, _ = inf.run(stream, 1 << 12)
        assert status == native.InflateStream.MALFORMED


def test_distance_too_far_back():
    """The reference's signature error (test.ml:193)."""
    codes = huffman.canonical_codes(tables.FIXED_LIT_LENGTHS)
    lens = tables.FIXED_LIT_LENGTHS
    dcodes = huffman.canonical_codes(tables.FIXED_DIST_LENGTHS)
    w = bitstream.BitWriter()
    w.write(1, 1)
    w.write(1, 2)
    w.write(int(codes[0x61]), int(lens[0x61]))
    w.write(int(codes[257]), int(lens[257]))   # length 3
    w.write(int(dcodes[5]), 5)                 # dist base 7 > 1 byte out
    w.write(0, 1)
    w.write(int(codes[256]), int(lens[256]))
    stream = w.getvalue()
    with pytest.raises(de.MalformedError, match="distance"):
        de._inflate_python(stream)
    if native.available():
        inf = native.InflateStream()
        status, _, _ = inf.run(stream, 1 << 12)
        assert status == native.InflateStream.MALFORMED
        assert "distance" in inf.error
