"""GPU symbol decoder (ops/inflate_triton.py): two-level table
equivalence, and kernel-vs-XLA decode agreement.  Runs on the CPU
(conftest), where the Pallas kernel runs in interpret mode; the tests
marked ``gpu`` run the compiled kernel on a card."""

import numpy as np
import jax.numpy as jnp
import pytest

from decompress_tpu.core import huffman, tables
from decompress_tpu.ops import inflate as inflate_ops
from decompress_tpu.ops import inflate_triton as it


def _random_lens(rng, nsym, maxlen=15):
    """Valid canonical code lengths via the production tree builder."""
    freqs = rng.integers(0, 1000, nsym).astype(np.int64)
    freqs[rng.integers(0, nsym)] += 10000  # skew for length spread
    lens = huffman.code_lengths_from_frequencies(
        np.asarray(freqs), max_length=maxlen)
    return np.asarray(lens, np.int32)


def _resolve(tab, root, sub, idx):
    """Host reference: resolve forward 15-bit code indices through one
    member's flat root+sub tables; returns (cls, nb, xtr, pay)."""
    e = tab[root + (idx >> it.SUB_BITS)]
    is_sub = ((e >> 24) & 7) == it.CLS_SUB
    se = tab[np.minimum(sub + (e & 0xFFFF) + (idx & 31), tab.size - 1)]
    e = np.where(is_sub, se, e)
    return (e >> 24) & 7, (e >> 20) & 15, (e >> 16) & 15, e & 0xFFFF


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_root_sub_matches_fused_lit(seed):
    rng = np.random.default_rng(seed)
    ll = np.zeros(288, np.int32)
    ll[:286] = _random_lens(rng, 286)
    dl = np.zeros(32, np.int32)
    dl[:30] = _random_lens(rng, 30)
    lit_tab, dist_tab = inflate_ops.build_fused_tables(
        jnp.asarray(ll)[None], jnp.asarray(dl)[None])
    tabs, ok = it.build_member_tables(
        jnp.asarray(ll)[None], jnp.asarray(dl)[None])
    assert bool(np.asarray(ok)[0])
    lit_tab = np.asarray(lit_tab)[0]
    dist_tab = np.asarray(dist_tab)[0]
    tab = np.asarray(tabs)[0]
    assert tab.size == it.TABLE_WORDS

    idx = np.arange(32768)
    cls, nb, xtr, pay = _resolve(tab, 0, it.LIT_SUB, idx)
    # fused-table fields
    fk, fnb = lit_tab >> 15, (lit_tab >> 11) & 15
    fx, fp = (lit_tab >> 8) & 7, lit_tab & 0xFF
    # class map: fused kind 0/1/2/3 = invalid/lit/len/eob
    assert np.array_equal(cls == 0, fk == 0)
    m = fk != 0
    assert np.array_equal(cls[m], fk[m])
    assert np.array_equal(nb[m], fnb[m])
    assert np.array_equal(xtr[m], fx[m].astype(xtr.dtype))
    assert np.array_equal(pay[m], fp[m])

    cls, nb, xtr, pay = _resolve(tab, it.DIST_ROOT, it.DIST_SUB, idx)
    fv = (dist_tab >> 23) & 1
    fnb, fx, fb = (dist_tab >> 19) & 15, (dist_tab >> 15) & 15, dist_tab & 0x7FFF
    assert np.array_equal(cls != 0, fv == 1)
    m = fv == 1
    assert np.array_equal(nb[m], fnb[m])
    assert np.array_equal(xtr[m], fx[m])
    assert np.array_equal(pay[m], fb[m])


def test_root_sub_fixed_and_incomplete():
    # fixed-Huffman litlen (all lengths <= 9: pure-root tree) and a
    # one-code dist tree (incomplete: everything else invalid)
    ll = np.asarray(tables.FIXED_LIT_LENGTHS, np.int32)
    dl = np.zeros(32, np.int32)
    dl[0] = 1
    _lit_tab, dist_tab = inflate_ops.build_fused_tables(
        jnp.asarray(ll)[None], jnp.asarray(dl)[None])
    tabs, ok = it.build_member_tables(
        jnp.asarray(ll)[None], jnp.asarray(dl)[None])
    assert bool(np.asarray(ok)[0])
    tab = np.asarray(tabs)[0]
    # fixed lit: no subptrs at all
    root = tab[: it.ROOT_SIZE]
    assert not (((root >> 24) & 7) == it.CLS_SUB).any()
    dist_tab = np.asarray(dist_tab)[0]
    cls = _resolve(tab, it.DIST_ROOT, it.DIST_SUB, np.arange(32768))[0]
    assert np.array_equal(cls != 0, ((dist_tab >> 23) & 1) == 1)


def _staged(payload, member_size=8192, level=6):
    from decompress_tpu import de
    from decompress_tpu.parallel import sharded

    arch = sharded.sharded_gzip_compress(payload, level,
                                         member_size=member_size)
    return sharded._stage_rows(de._np_u8(arch)), arch


def _rows(st, out):
    """Per row: the real command tuples (NOP slots dropped), up to and
    including the end marker of end-of-block rows."""
    kinds, values, dists = (np.asarray(a) for a in out[:3])
    rows = []
    for r in range(st.nrows):
        cmds = []
        for k, v, d in zip(kinds[r], values[r], dists[r]):
            if k == inflate_ops.KIND_NOP:
                continue
            if k == 2:
                if st.stops[r] == 0:
                    cmds.append((2, 0, 0))
                break
            cmds.append((int(k), int(v), int(d)))
        rows.append(cmds)
    return rows


def _decode_both(st, start_bits=None, stops=None, members=None):
    start_bits = st.start_bits if start_bits is None else start_bits
    stops = st.stops if stops is None else stops
    members = st.row_members if members is None else members
    words = jnp.asarray(st.words)
    lt, dt = inflate_ops.build_fused_tables(jnp.asarray(st.lit_lens),
                                            jnp.asarray(st.dist_lens))
    x = inflate_ops.decode_symbols(
        words, jnp.asarray(start_bits), lt, dt, max_cmds=st.xla_slots(),
        stop_bits=jnp.asarray(stops), row_members=jnp.asarray(members))
    t = it.decode_symbols(
        words, jnp.asarray(start_bits), jnp.asarray(st.lit_lens),
        jnp.asarray(st.dist_lens), max_cmds=st.triton_slots(),
        stop_bits=jnp.asarray(stops), row_members=jnp.asarray(members),
        interpret=True)
    return x, t


@pytest.mark.parametrize("level", [1, 6])
def test_triton_kernel_matches_xla_interpret(level):
    rng = np.random.default_rng(5)
    payload = (b"the triton decode kernel must agree with the XLA one " * 300
               + rng.integers(0, 256, 9000, np.uint8).tobytes()
               + b"\x00" * 3000)
    st, _ = _staged(payload, level=level)
    assert st.bit_mode
    x, t = _decode_both(st)
    assert bool(np.asarray(x[3])[:st.nrows].all())
    assert bool(np.asarray(t[3])[:st.nrows].all())
    # no bit window: the kernel never emits a NOP slot
    assert not (np.asarray(t[0]) == inflate_ops.KIND_NOP).any()
    assert _rows(st, x) == _rows(st, t)


@pytest.mark.parametrize("nrows", [1, it.BLOCK_LANES - 1, it.BLOCK_LANES + 3])
def test_triton_lane_grouping_and_padding(nrows):
    """Row counts that leave a program's block partly empty, or spill
    into a second program: the wrapper pads with dead rows, and every
    real row decodes as the XLA loop decodes it."""
    rng = np.random.default_rng(nrows)
    text = b"lanes of one program decode unrelated rows " * 40
    payload = b"".join(text[rng.integers(0, 64):] + bytes(rng.integers(
        0, 256, 200, np.uint8)) for _ in range(100))
    st, _ = _staged(payload, member_size=4096)
    assert st.nrows >= nrows
    # decode the first `nrows` rows only, rows in reverse order so one
    # program holds rows of several members
    order = np.arange(nrows)[::-1]
    sb, sc, rm = (a[order] for a in (st.start_bits, st.stops,
                                     st.row_members))
    x, t = _decode_both(st, sb, sc, rm)
    assert t[0].shape[0] == nrows
    okx, okt = np.asarray(x[3]), np.asarray(t[3])
    assert okx.all() and okt.all()
    sub = st._replace(rows=[st.rows[i] for i in order],
                      stops=sc)
    assert _rows(sub, x) == _rows(sub, t)


def test_triton_rejects_corrupt_rows():
    """Rows of a member whose code lengths are corrupt decode as not ok
    (so the caller takes the serial path), and do not disturb their
    neighbours' rows in the same program."""
    st, _ = _staged(b"corrupt row neighbours " * 2000)
    members = np.asarray(st.row_members[:st.nrows])
    bad_member = int(members[1])
    lit_lens = np.array(st.lit_lens)
    lit_lens[bad_member] = 0  # empty tree: every code is invalid
    _x, t = _decode_both(st._replace(lit_lens=lit_lens))
    _x_ref, t_ref = _decode_both(st)
    ok = np.asarray(t[3])[:st.nrows]
    good = members != bad_member
    assert not ok[~good].any()
    assert ok[good].all()
    assert [r for r, g in zip(_rows(st, t), good) if g] == \
        [r for r, g in zip(_rows(st, t_ref), good) if g]


def test_decoder_choice_follows_platform():
    """CPU rows take the XLA loop; command-stopped (legacy TS) rows
    take it on any platform, since the kernel stops rows by bit."""
    from decompress_tpu.parallel import sharded

    st, _ = _staged(b"decoder choice " * 3000)
    words = jnp.asarray(st.words)
    assert sharded._decoder_for(st, words) == "xla"

    class _Dev:
        platform = "gpu"

    class _OnGpu:
        def devices(self):
            return {_Dev()}

    assert sharded._decoder_for(st, _OnGpu()) == "triton"
    ts = st._replace(bit_mode=False)
    assert sharded._decoder_for(ts, _OnGpu()) == "xla"


def test_tb_index_end_to_end(monkeypatch):
    """Bit-stride archives write the compact TB subfield (u8 deltas;
    ~50 B per member instead of ~530 B) and decode byte-exact through
    BOTH decoders: the XLA loop with bit-based stops and the Triton
    kernel (interpret mode here)."""
    import functools
    import gzip

    from decompress_tpu import de
    from decompress_tpu.parallel import sharded

    rng = np.random.default_rng(17)
    payload = (b"compact TB index round trip " * 1200
               + rng.integers(0, 256, 14000, np.uint8).tobytes()
               + bytes(6000))
    monkeypatch.setattr(sharded, "SPLIT_BITS", 4096)
    monkeypatch.setattr(sharded, "N_SPLITS", 250)
    arch = sharded.sharded_gzip_compress(payload, 6, member_size=16384)
    assert gzip.decompress(arch) == payload  # still standard gzip

    buf = de._np_u8(arch)
    sizes, splits, tb = sharded._read_index_ex(buf)
    assert tb is not None and tb["bits"] == 4096
    assert splits is not None and any(len(r) for r in splits)
    # compactness: every recorded split costs 1 byte + 4/member header
    n_splits = sum(len(r) for r in splits)
    assert n_splits >= 4

    # serial-fallback poisoning: both decoder paths must succeed alone
    monkeypatch.setattr(sharded.gz, "decompress",
                        lambda _b: (_ for _ in ()).throw(
                            AssertionError("serial fallback used")))
    assert sharded._decompress(buf, "auto", "xla") == payload
    assert sharded._decompress(buf, "device", "xla") == payload
    monkeypatch.setattr(it, "decode_symbols",
                        functools.partial(it.decode_symbols, interpret=True))
    assert sharded._decompress(buf, "auto", "triton") == payload
    assert sharded._decompress(buf, "device", "triton") == payload


@pytest.mark.gpu
def test_triton_kernel_on_gpu(gpu):
    """The compiled kernel on the card: every row decodes, with the
    XLA loop's commands (the check chip_smoke.py runs at 64 MiB)."""
    import chip_smoke

    rng = np.random.default_rng(3)
    payload = (b"compiled kernel on the card " * 4000
               + rng.integers(0, 256, 20000, np.uint8).tobytes())
    st, _ = _staged(payload, member_size=65536)
    times = chip_smoke.check_decoders(st, reps=1)
    assert set(times) == {"xla", "triton"}
