"""Checksum kernels vs the C zlib oracle (checkseum's role, SURVEY §2 #25)."""

import zlib

import numpy as np
import pytest

from decompress_tpu.ops import checksum


LENGTHS = [1, 2, 7, 255, 256, 257, 511, 512, 513, 4096, 100_000, 1 << 20]


@pytest.mark.parametrize("n", LENGTHS)
def test_crc32_matches_zlib(n):
    rng = np.random.default_rng(n)
    data = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
    assert checksum.crc32(data) == zlib.crc32(data)


@pytest.mark.parametrize("n", LENGTHS)
def test_adler32_matches_zlib(n):
    rng = np.random.default_rng(n + 1)
    data = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
    assert checksum.adler32(data) == zlib.adler32(data)


def test_running_updates():
    rng = np.random.default_rng(7)
    a = rng.integers(0, 256, size=1000, dtype=np.uint8).tobytes()
    b = rng.integers(0, 256, size=3333, dtype=np.uint8).tobytes()
    assert checksum.crc32(b, checksum.crc32(a)) == zlib.crc32(b, zlib.crc32(a))
    assert checksum.adler32(b, checksum.adler32(a)) == zlib.adler32(b, zlib.adler32(a))


def test_combines():
    rng = np.random.default_rng(8)
    a = rng.integers(0, 256, size=5000, dtype=np.uint8).tobytes()
    b = rng.integers(0, 256, size=12345, dtype=np.uint8).tobytes()
    c_a, c_b = zlib.crc32(a), zlib.crc32(b)
    assert checksum.crc32_combine(c_a, c_b, len(b)) == zlib.crc32(a + b)
    ad_a, ad_b = zlib.adler32(a), zlib.adler32(b)
    assert checksum.adler32_combine(ad_a, ad_b, len(b)) == zlib.adler32(a + b)


def test_empty_and_all_zero():
    assert checksum.crc32(b"") == zlib.crc32(b"")
    assert checksum.adler32(b"") == zlib.adler32(b"")
    z = bytes(10000)
    assert checksum.crc32(z) == zlib.crc32(z)
    assert checksum.adler32(z) == zlib.adler32(z)


@pytest.mark.parametrize("fill", ["random", "ones"])
def test_crc32_batches_around_chunk_boundaries(fill):
    """The batched CRC paths (host-padded and device-resident rows) at
    lengths around CRC_CHUNK multiples.  All-0xFF rows drive every GF(2)
    column count of the int8 chunk matmul to its maximum."""
    import jax.numpy as jnp

    c = checksum.CRC_CHUNK
    lengths = np.array([1, c - 1, c, c + 1, 2 * c - 1, 2 * c, 2 * c + 1,
                        8 * c - 1, 8 * c], np.int32)
    width = int(lengths.max())
    rng = np.random.default_rng(3)
    rows = (rng.integers(0, 256, (lengths.size, width), dtype=np.uint8)
            if fill == "random"
            else np.full((lengths.size, width), 0xFF, np.uint8))
    for i, n in enumerate(lengths):
        rows[i, n:] = 0  # the device path needs zeros past each length
    want = [zlib.crc32(rows[i, :n].tobytes()) for i, n in enumerate(lengths)]
    assert list(checksum.crc32_batch(rows, lengths)) == want
    assert list(checksum.crc32_batch_device(jnp.asarray(rows), lengths)) == want
    assert checksum.crc32(rows[-1].tobytes()) == want[-1]
