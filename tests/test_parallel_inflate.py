"""Member-parallel device inflate tests (the decode half of config 5)."""

import gzip

import numpy as np
import pytest

from decompress_tpu import de, gz
from decompress_tpu.parallel import (
    sharded_gzip_compress,
    sharded_gzip_decompress,
)
from decompress_tpu.parallel.sharded import _read_index

MEMBER = 8192


@pytest.fixture(scope="module")
def payload():
    rng = np.random.default_rng(11)
    return (
        b"parallel inflate payload " * 1500
        + rng.integers(0, 256, 15000, np.uint8).tobytes()
        + b"\x00" * 5000
    )


def test_indexed_archive_roundtrip(payload):
    arch = sharded_gzip_compress(payload, 6, member_size=MEMBER)
    # foreign tools read the indexed archive unchanged
    assert gzip.decompress(arch) == payload
    # the index lists every member and spans the archive exactly
    sizes = _read_index(de._np_u8(arch))
    assert sizes is not None and sum(sizes) == len(arch)
    # device-parallel decode is byte-exact
    assert sharded_gzip_decompress(arch) == payload


def test_unindexed_falls_back(payload):
    arch = sharded_gzip_compress(payload, 6, member_size=MEMBER, index=False)
    assert sharded_gzip_decompress(arch) == payload


def test_parallel_decode_levels(payload):
    for level in (1, 9):
        arch = sharded_gzip_compress(payload, level, member_size=MEMBER)
        assert sharded_gzip_decompress(arch) == payload


def test_corrupted_member_detected(payload):
    arch = bytearray(sharded_gzip_compress(payload, 6, member_size=MEMBER))
    sizes = _read_index(de._np_u8(bytes(arch)))
    # flip a byte inside the second member's compressed body
    off = sizes[0] + 20
    arch[off] ^= 0x10
    with pytest.raises(de.MalformedError):
        sharded_gzip_decompress(bytes(arch))


def test_stored_members_roundtrip():
    rng = np.random.default_rng(12)
    incompressible = rng.integers(0, 256, 40000, np.uint8).tobytes()
    arch = sharded_gzip_compress(incompressible, 6, member_size=MEMBER)
    assert gzip.decompress(arch) == incompressible
    # stored members are not single huffman blocks -> serial fallback
    assert sharded_gzip_decompress(arch) == incompressible


def test_device_path_actually_runs(payload, monkeypatch):
    """Regression: a root-bits mismatch once made every member decode
    fail ok=False and silently fall back to the serial path."""
    from decompress_tpu.parallel import sharded as sh

    arch = sharded_gzip_compress(payload, 6, member_size=MEMBER)

    def _no_fallback(_buf):
        raise AssertionError("device decode fell back to the serial path")

    monkeypatch.setattr(sh.gz, "decompress", _no_fallback)
    assert sh.sharded_gzip_decompress(arch) == payload


def test_split_index_present_and_used(payload, monkeypatch):
    """Archives record symbol-stream split points (SPLIT_ID subfield)
    and the decoder consumes members as chunk rows without the serial
    fallback; output is byte-exact."""
    from decompress_tpu.parallel import sharded as sh

    arch = sharded_gzip_compress(payload, 6, member_size=MEMBER)
    sizes, splits, _tb = sh._read_index_ex(de._np_u8(arch))
    assert sizes is not None and splits is not None
    assert len(splits) == len(sizes)
    # big members should have fixed-stride splits recorded (a member
    # records ~ncmds/SPLIT_STRIDE valid triples, not all 63)
    assert any(any(t[0] > 0 for t in sp) for sp in splits)
    # split offsets are strictly increasing where present
    for sp in splits:
        prev = 0
        for bo, ci, oo in sp:
            if bo:
                assert bo > prev
                prev = bo

    monkeypatch.setattr(sh.gz, "decompress", lambda _b: (_ for _ in ()).throw(
        AssertionError("serial fallback used")))
    assert sh.sharded_gzip_decompress(arch) == payload


def test_split_index_corrupt_falls_back(payload):
    """A corrupted split subfield must not break decoding: the decoder
    detects the bad index and uses whole-member rows (and the stream
    still decodes byte-exactly).  Covers both geometries: the TS
    triples get non-increasing offsets, the TB field a zeroed stride."""
    from decompress_tpu.parallel import sharded as sh

    arch = bytearray(sharded_gzip_compress(payload, 6, member_size=MEMBER))
    xlen = int.from_bytes(arch[10:12], "little")
    field = arch[12 : 12 + xlen]
    i = 0
    found = False
    while i + 4 <= len(field):
        sid = bytes(field[i : i + 2])
        ln = int.from_bytes(field[i + 2 : i + 4], "little")
        if sid == sh.SPLIT_ID:
            # reverse a bit-offset ordering: copy first triple over second
            base = 12 + i + 4 + 1
            arch[base + 12 : base + 24] = arch[base : base + 12]
            found = True
            break
        if sid == sh.TBITS_ID:
            # zero the stride: every synthesized offset collapses
            base = 12 + i + 4
            arch[base : base + 4] = b"\x00\x00\x00\x00"
            found = True
            break
        i += 4 + ln
    assert found
    assert sharded_gzip_decompress(bytes(arch)) == payload
    # legacy TS geometry exercised explicitly
    import pytest as _pytest

    mp = _pytest.MonkeyPatch()
    try:
        mp.setattr(sh, "SPLIT_BITS", 0)
        arch2 = bytearray(sharded_gzip_compress(payload, 6,
                                                member_size=MEMBER))
    finally:
        mp.undo()
    xlen = int.from_bytes(arch2[10:12], "little")
    field = arch2[12 : 12 + xlen]
    i = 0
    found = False
    while i + 4 <= len(field):
        sid = bytes(field[i : i + 2])
        ln = int.from_bytes(field[i + 2 : i + 4], "little")
        if sid == sh.SPLIT_ID:
            base = 12 + i + 4 + 1
            arch2[base + 12 : base + 24] = arch2[base : base + 12]
            found = True
            break
        i += 4 + ln
    assert found
    assert sharded_gzip_decompress(bytes(arch2)) == payload


def test_archives_identical_across_meshes_with_splits(payload):
    """Split metadata is deterministic: same archive bytes for 1 and 8
    virtual devices."""
    from decompress_tpu.parallel import sharded as sh

    a1 = sharded_gzip_compress(payload, 6, member_size=MEMBER, mesh=None)
    a8 = sharded_gzip_compress(payload, 6, member_size=MEMBER,
                               mesh=sh.make_mesh(8))
    assert a1 == a8


def test_device_expansion_with_splits(payload):
    """expand="device": chunk rows regroup into member command matrices
    on device and the LZ77 expansion + CRC run fully on device —
    byte-exact even with the split index active."""
    from decompress_tpu.parallel import sharded as sh

    arch = sharded_gzip_compress(payload, 6, member_size=MEMBER)
    out = sh.sharded_gzip_decompress(de._np_u8(arch), expand="device")
    assert out == payload


def test_nop_slots_small_window(payload, monkeypatch):
    """A small decode window forces lanes to exhaust their bit budget
    mid-step and emit NOP slots (kind 3); both the native expander and
    the on-device expansion must skip them and still produce byte-exact
    output without the serial fallback."""
    from decompress_tpu.ops import inflate as iops
    from decompress_tpu.parallel import sharded as sh

    arch = sharded_gzip_compress(payload, 6, member_size=MEMBER)
    # 75-bit budget: random-literal runs exhaust it mid-step -> NOPs,
    # but every row still fits its slot cap (nw=3 would overflow and
    # take the by-design serial fallback instead)
    monkeypatch.setattr(iops, "NW_DEFAULT", 4)
    monkeypatch.setattr(sh.gz, "decompress", lambda _b: (_ for _ in ()).throw(
        AssertionError("serial fallback used")))
    assert sh.sharded_gzip_decompress(de._np_u8(arch)) == payload
    assert sh.sharded_gzip_decompress(de._np_u8(arch), expand="device") == payload


def test_slot_counts_mixed_nops():
    """slot_counts: count-stopped rows span the first N real commands
    (NOPs included); EOB rows span up to the end marker."""
    import jax.numpy as jnp

    from decompress_tpu.ops import inflate as iops

    kinds = np.array(
        [
            [0, 3, 0, 1, 2, 2],   # stop=3: slots 0..3 hold 3 real cmds
            [3, 3, 0, 2, 2, 2],   # EOB row: end marker at slot 3
            [0, 0, 0, 0, 1, 2],   # stop=5: no nops -> 5 slots
        ],
        np.int8,
    )
    stops = np.array([3, 0, 5], np.int32)
    out = np.asarray(iops.slot_counts(jnp.asarray(kinds), jnp.asarray(stops)))
    assert out.tolist() == [4, 4, 5]


def test_nop_slots_emitted_and_skipped(payload):
    """Direct kernel check: nw=4 produces NOP slots on this payload and
    the native expander reproduces the exact member bytes through them."""
    import jax.numpy as jnp

    from decompress_tpu import native
    from decompress_tpu.ops import inflate as iops
    from decompress_tpu.parallel import sharded as sh

    arch = sharded_gzip_compress(payload, 6, member_size=MEMBER)
    st = sh._stage_rows(de._np_u8(arch))
    mw, ll, dl, sb, sc, rm = (st.words, st.lit_lens, st.dist_lens,
                              st.start_bits, st.stops, st.row_members)
    nrows, _tb = st.nrows, st.bit_mode
    lt, dt = iops.build_fused_tables(jnp.asarray(ll), jnp.asarray(dl))
    # TB archives (the default) stop rows by BIT position
    kinds, values, dists, ok = iops.decode_symbols(
        jnp.asarray(mw), jnp.asarray(sb), lt, dt,
        max_cmds=sh._ceil_pow2_int(
            max(iops.worst_case_slots(c, nw=4) for c in st.row_caps) + 4),
        stop_counts=None if _tb else jnp.asarray(sc),
        stop_bits=jnp.asarray(sc) if _tb else None,
        row_members=jnp.asarray(rm), nw=4)
    kk = np.asarray(kinds)[:nrows]
    assert bool(np.asarray(ok)[:nrows].all())
    assert (kk == 3).sum() > 0, "expected NOP slots with a 75-bit budget"

    if not native.available():
        pytest.skip("libtpuz unavailable")
    # expand the first member's row span (NOPs inline) through the C++
    # expander and compare bytes against the serial oracle
    packed = (kinds.astype(jnp.int32) << 26) | (dists << 10) | values
    ncmds = np.asarray(iops.slot_counts_bits(kinds, jnp.asarray(sc)) if _tb
                       else iops.slot_counts(kinds, jnp.asarray(sc)))
    row_starts = np.concatenate([[0], np.cumsum(ncmds)])
    flat = np.asarray(iops.compact_commands(
        packed, jnp.asarray(ncmds), int(row_starts[-1]) + 1)).astype(np.uint32)
    # rows of member 0 are the leading rows with row_members == 0
    r1 = int(np.argmax(np.asarray(rm)[:nrows] != 0)) or nrows
    seg = np.ascontiguousarray(flat[: int(row_starts[r1])])
    first_member = gzip.decompress(arch)[: MEMBER]
    outbuf = np.empty(len(first_member) + 4, np.uint8)
    produced = native.expand_cmds(seg, outbuf)
    assert produced == len(first_member)
    assert outbuf[:produced].tobytes() == first_member


def test_default_window_far_match_stream(monkeypatch):
    """Dense far-match streams (dist > 16384: 13 extra bits; len > 227:
    5 extra bits) exceed the default 10-word step budget and must ride
    the NOP path at the DEFAULT config — no serial fallback, byte-exact."""
    from decompress_tpu.parallel import sharded as sh

    rng = np.random.default_rng(21)
    base = rng.integers(0, 256, 17000, np.uint8).tobytes()
    tail = bytearray(base[:16500])
    for j in range(0, len(tail), 251):  # break matches every ~250 bytes
        tail[j] ^= 0xA5
    payload = base + bytes(tail) + base[:8000]
    arch = sharded_gzip_compress(payload, 6, member_size=65536)
    monkeypatch.setattr(sh.gz, "decompress", lambda _b: (_ for _ in ()).throw(
        AssertionError("serial fallback used")))
    assert sh.sharded_gzip_decompress(de._np_u8(arch)) == payload
