"""The device pack stage: its DEFLATE blocks decode under stdlib zlib,
with and without split points."""

import zlib

import numpy as np
import pytest

import jax.numpy as jnp

from decompress_tpu import de
from decompress_tpu.ops import lz77


@pytest.mark.parametrize("n_splits,split_stride,split_bits", [
    (0, 2048, 0), (8, 64, 0), (8, 64, 256)])
def test_pack_output_decodes_under_zlib(n_splits, split_stride, split_bits):
    seg = 4096
    b = 2
    rng = np.random.default_rng(11)
    words = rng.integers(97, 111, size=48, dtype=np.uint8)
    raw = np.concatenate([
        np.tile(words[rng.integers(0, 48, 6)], 40) for _ in range(200)
    ])[: b * seg].reshape(b, seg)
    n_valid = np.array([seg, seg - 99], np.int32)
    res = lz77.lz77_analyze(jnp.asarray(raw), jnp.asarray(n_valid),
                            jnp.zeros(b, jnp.int32), level=6,
                            seg_len=seg, hist=0)
    (hv, hb), tabs, kinds = de.plan_blocks(
        np.asarray(res["hist_lit"]), np.asarray(res["hist_dist"]), n_valid,
        np.ones(b, bool))
    assert all(k != "stored" for k in kinds)
    out = de._pack_segments(
        res, jnp.asarray(raw), *[jnp.asarray(t) for t in (hv, hb, *tabs)],
        (9 * seg) // 32 + 2 * de._HDR_PAD, n_splits=n_splits,
        split_stride=split_stride, split_bits=split_bits)
    (words_out, totals), splits = out if n_splits > 1 else (out, None)
    words_out, totals = np.asarray(words_out), np.asarray(totals)
    for i in range(b):
        body = words_out[i].astype("<u4").tobytes()[: (int(totals[i]) + 7) // 8]
        d = zlib.decompressobj(-15)
        assert d.decompress(body) == raw[i, : n_valid[i]].tobytes()
        assert d.eof
    if splits is not None:
        bits = np.asarray(splits[0])
        for i in range(b):
            valid = bits[i][bits[i] > 0]
            assert valid.size > 0
            assert (np.diff(valid) > 0).all() and valid[-1] < totals[i]
