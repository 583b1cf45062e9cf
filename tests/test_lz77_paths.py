"""The XLA parse stages against independent references: the mark-path
walk, the round-B bit costs, batch independence of the cost-aware
re-parse, and the symbol histograms."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from decompress_tpu.ops import codes, lz77


def _random_jumps(rng, b, p, seg_len):
    """Jump arrays the parse actually produces: g[i] = i + step,
    step in {1} or [3, 258], clipped to p; tail positions step 1."""
    step = np.ones((b, p), np.int64)
    take = rng.random((b, seg_len)) < 0.3
    ln = rng.integers(3, 259, size=(b, seg_len))
    step[:, :seg_len] = np.where(take, ln, 1)
    return np.minimum(np.arange(p)[None, :] + step, p).astype(np.int32)


def _serial_walk(g):
    """Reference: follow the jumps from position 0, one at a time."""
    on = np.zeros(g.size, bool)
    pos = 0
    while pos < g.size:
        on[pos] = True
        pos = int(g[pos])
    return on


@pytest.mark.parametrize("case", [
    (4096, 4096, 3), (8192, 7777, 2), (1024, 1000, 1),
    "all_literals", "all_jumps"])
def test_mark_path_matches_serial_walk(case):
    if case == "all_literals":
        p = 2048
        g = np.minimum(np.arange(p, dtype=np.int32)[None, :] + 1, p)
    elif case == "all_jumps":
        p = 2048
        g = np.minimum(np.arange(p, dtype=np.int32)[None, :] + 258, p)
    else:
        p, seg_len, b = case
        g = _random_jumps(np.random.default_rng(p + b), b, p, seg_len)
    levels = p.bit_length() - 1
    want = np.stack([_serial_walk(row) for row in g])
    full = np.asarray(jax.vmap(lambda r: lz77._mark_path(r, levels))(
        jnp.asarray(g)))
    hybrid = np.asarray(jax.vmap(
        lambda r: lz77._mark_path_hybrid(r, levels))(jnp.asarray(g)))
    assert np.array_equal(full, want)
    assert np.array_equal(hybrid, want)
    if case == "all_literals":
        assert want.all()
    if case == "all_jumps":
        assert np.array_equal(np.flatnonzero(want[0]), np.arange(0, p, 258))


@pytest.mark.parametrize("b,seed", [(2, 3), (1, 11)])
def test_bit_costs_match_numpy(b, seed):
    """Round-B literal bits and match gains against a numpy reference
    built from the RFC 1951 code tables."""
    from decompress_tpu.core import tables

    rng = np.random.default_rng(seed)
    t = 1024
    lit = rng.integers(0, 256, (b, t)).astype(np.int32)
    lcost = rng.integers(1, 15, (b, 286)).astype(np.float32)
    dcost = rng.integers(1, 15, (b, 30)).astype(np.float32)
    ln = rng.integers(0, 259, (b, t)).astype(np.int32)
    dist = rng.integers(1, 1 << 15, (b, t)).astype(np.int32)

    def run(lit_r, lc, dc, ln_r, d_r):
        litbits, gain = lz77._bit_costs(lit_r, lc, dc)
        return litbits, gain(ln_r, d_r)

    litbits, gain = (np.asarray(x) for x in jax.vmap(run)(
        *map(jnp.asarray, (lit, lcost, dcost, ln, dist))))

    np.testing.assert_array_equal(
        litbits, np.take_along_axis(lcost, lit, axis=1))
    # table-driven code symbols and extra-bit counts
    lbase = np.asarray(tables.LENGTH_BASE)
    dbase = np.asarray(tables.DIST_BASE)
    lsym = np.searchsorted(lbase, np.maximum(ln, 3), side="right") - 1
    dsym = np.searchsorted(dbase, dist, side="right") - 1
    cost = (np.take_along_axis(lcost, 257 + lsym, axis=1)
            + np.asarray(tables.LENGTH_EXTRA)[lsym]
            + np.take_along_axis(dcost, dsym, axis=1)
            + np.asarray(tables.DIST_EXTRA)[dsym])
    pref = np.concatenate([np.zeros((b, 1)), np.cumsum(litbits, axis=1)],
                          axis=1)
    pos = np.arange(t)[None, :]
    span = (np.take_along_axis(pref, np.minimum(pos + ln, t), axis=1)
            - pref[:, :t])
    want = np.where(ln >= 3, span - cost, lz77.NO_GAIN)
    np.testing.assert_array_equal(gain, want.astype(np.float32))


def _mk_batch(seed, b, seg_len):
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(b):
        # compressible text-ish data with repeats and strides
        words = rng.integers(97, 123, size=64, dtype=np.uint8)
        chunks = []
        while sum(len(c) for c in chunks) < seg_len:
            w = words[rng.integers(0, 64, 8)]
            chunks.append(np.tile(w, rng.integers(1, 6)))
        parts.append(np.concatenate(chunks)[:seg_len])
    return np.stack(parts)


@pytest.mark.parametrize("seg_len,mine", [(4096, False), (8192, True)])
def test_parse_cost_batch_independent(seg_len, mine):
    """The cost-aware re-parse of a segment does not depend on what
    else shares its batch: a batch of two equals each row alone."""
    b = 2
    data = jnp.asarray(_mk_batch(7, b, seg_len))
    n_valid = jnp.asarray(np.array([seg_len, seg_len - 173], np.int32))
    hist_len = jnp.zeros(b, jnp.int32)
    res = lz77.lz77_analyze(data, n_valid, hist_len, level=6,
                            seg_len=seg_len, hist=0)
    lc, dc = lz77._cost_tables_host(np.asarray(res["hist_lit"]),
                                    np.asarray(res["hist_dist"]))
    hot = None
    if mine:
        hot = jnp.asarray(lz77._hot_dists_host(np.asarray(res["dist_counts"])))

    def parse(rows):
        return lz77.lz77_parse_cost(
            data[rows], res["cand_length"][rows], res["cand_dist"][rows],
            n_valid[rows], jnp.asarray(lc)[rows], jnp.asarray(dc)[rows],
            hist_len[rows], None if hot is None else hot[rows],
            seg_len=seg_len, hist=0, lazy=True)

    both = parse(np.arange(b))
    for i in range(b):
        one = parse(np.array([i]))
        for k in ("on_path", "is_match", "length", "dist", "hist_lit",
                  "hist_dist", "exact"):
            np.testing.assert_array_equal(
                np.asarray(both[k])[i], np.asarray(one[k])[0], err_msg=k)
    assert int(np.asarray(both["is_match"]).sum()) > 0


def test_histograms_match_bincount():
    """Round-A symbol histograms equal a bincount of the symbols on
    the parse path."""
    seg_len = 4096
    raw = _mk_batch(5, 3, seg_len)
    raw[2, 3000:] = np.random.default_rng(1).integers(0, 256, 1096)
    n_valid = np.array([seg_len, seg_len - 99, seg_len], np.int32)
    res = lz77.lz77_analyze(jnp.asarray(raw), jnp.asarray(n_valid),
                            jnp.zeros(3, jnp.int32), level=6,
                            seg_len=seg_len, hist=0)
    on_path, is_match, length, dist = (
        np.asarray(res[k]) for k in ("on_path", "is_match", "length", "dist"))
    lcode = np.asarray(codes.length_code(jnp.asarray(length)))
    dcode = np.asarray(codes.dist_code(jnp.asarray(dist)))
    for i in range(3):
        sym = np.where(is_match[i], 257 + lcode[i], raw[i])[on_path[i]]
        want_l = np.bincount(sym, minlength=286)
        want_d = np.bincount(dcode[i][is_match[i]], minlength=30)
        np.testing.assert_array_equal(np.asarray(res["hist_lit"])[i], want_l)
        np.testing.assert_array_equal(np.asarray(res["hist_dist"])[i], want_d)
    assert is_match.any() and (on_path & ~is_match).any()
