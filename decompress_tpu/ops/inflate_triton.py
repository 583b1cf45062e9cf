"""GPU symbol decoder: a Pallas kernel on the Triton route.

The member-parallel device inflate decodes the symbol stream of every
split row of an indexed archive (parallel/sharded.py).  Each row is a
serial chain of dependent table lookups.  :func:`ops.inflate.
decode_symbols` runs that chain as an XLA ``while_loop`` whose every
8-symbol step is a set of separate kernels, with all lane state going
through device memory and the loop predicate read back each step.

Here one program decodes ``BLOCK_LANES`` rows with the whole symbol
loop inside it: the bit cursor stays in registers, and the stream
words and decode tables are gathered straight from device memory.  The
tables are two-level (a ``ROOT_BITS``-bit root plus fixed 32-slot
subtables for longer codes, as zlib builds them; cf. the reference's
``De.Lookup``, de.ml:660-720), 20 KiB per member, so a member's tables
stay in L1.  The kernel reads the whole stream, so it needs no bit
window and emits no NOP slots.  Slot ``i`` of every lane of a program
is one contiguous store.

Output format, stop semantics and the ``ok`` contract are those of
``decode_symbols`` with ``stop_bits`` (minus the NOP slots), so the
sharded decode swaps one for the other.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..core import tables
from .inflate import _rev15

ROOT_BITS = 10
ROOT_SIZE = 1 << ROOT_BITS
SUB_BITS = 15 - ROOT_BITS
SUB_SLOTS = 1 << SUB_BITS            # fixed 32-entry subtables
LITSUB_SIZE = 2048                   # 64 distinct long prefixes
DISTSUB_SIZE = 1024                  # 32 distinct long prefixes

#: one member's tables, flat: lit root | lit sub | dist root | dist sub
LIT_SUB = ROOT_SIZE
DIST_ROOT = LIT_SUB + LITSUB_SIZE
DIST_SUB = DIST_ROOT + ROOT_SIZE
TABLE_WORDS = DIST_SUB + DISTSUB_SIZE

#: fused entry, the same layout for lit and dist tables (int32, 27 bits):
#: cls(3)<<24 | nb(4)<<20 | xtr(4)<<16 | pay(16)
#: lit cls:  0 invalid, 1 literal (pay=byte), 2 length (pay=base-3),
#:           3 end-of-block, 4 subptr (pay=sub_base, nb=ROOT_BITS)
#: dist cls: 0 invalid, 1 dist (pay=base-1), 4 subptr
#: nb is the FULL code length for resolved entries (root and sub).
CLS_INVALID = 0
CLS_LIT = 1
CLS_LEN = 2
CLS_EOB = 3
CLS_SUB = 4

#: rows decoded by one program (a power of two, as Triton requires)
BLOCK_LANES = 32
#: warps per program: one thread per row
NUM_WARPS = 1

#: packed command word written for slots past a row's end
END_FILL = 2 << 26


def _entry(cls, nb, xtr, pay):
    return (cls << 24) | (nb << 20) | (xtr << 16) | pay


def _canonical_codes(lens):
    """MSB-first canonical code per symbol from code lengths [S]."""
    oneh = (lens[:, None] == jnp.arange(1, 16)[None, :]).astype(jnp.int32)
    bl_count = oneh.sum(0)
    codes = []
    code = jnp.int32(0)
    for l in range(1, 16):
        codes.append(code)
        code = (code + bl_count[l - 1]) << 1
    first = jnp.stack(codes)
    rank = jnp.cumsum(oneh, axis=0) - 1
    return jnp.sum(oneh * (first[None, :] + rank), axis=1)


def _scatter_cummax_table(size, idx, end_idx, entry, tag, end_tag,
                          block=None):
    """Range-fill a decode table: scatter (tag<<W | entry plane) at
    range starts and bare end sentinels at range ends, then cummax.
    ``block`` limits the cummax to 32-slot blocks (subtables).  Entries
    are 27 bits -> two 17-bit planes (int64 is unavailable)."""
    W = 17
    acc = None
    pos_tag = tag.astype(jnp.uint32) << W
    e_tag = end_tag.astype(jnp.uint32) << W
    for plane_i in range(2):
        pe = ((entry >> (plane_i * W)) & ((1 << W) - 1)).astype(jnp.uint32)
        t = jnp.zeros(size, jnp.uint32)
        t = t.at[idx].max(pos_tag | pe, mode="drop")
        t = t.at[end_idx].max(e_tag, mode="drop")
        if block is None:
            t = jax.lax.cummax(t)
        else:
            t = jax.lax.cummax(t.reshape(-1, block), axis=1).reshape(-1)
        plane = (t & ((1 << W) - 1)).astype(jnp.int32)
        acc = plane if acc is None else acc | (plane << (plane_i * W))
    return acc


def _build_one_root_sub(lens, make_entry, sub_size):
    """Root + 32-slot-subtable build from code lengths [S].

    Returns (root int32[ROOT_SIZE], sub int32[sub_size], n_sub_prefixes
    int32); callers check n_sub_prefixes * 32 <= sub_size.
    """
    S = lens.shape[0]
    l = lens
    code = _canonical_codes(l)
    valid = l > 0
    short = valid & (l <= ROOT_BITS)
    long_ = l > ROOT_BITS

    # long-code prefixes -> dense subtable ranks
    BIG = jnp.int32(1 << 20)
    pfx = jnp.where(long_, code >> (l - ROOT_BITS), BIG)
    sp = jnp.sort(pfx)
    is_new = (sp != jnp.concatenate([jnp.full(1, -1, jnp.int32), sp[:-1]])) \
        & (sp < BIG)
    uniq = jnp.sort(jnp.where(is_new, sp, BIG))
    rank = jnp.searchsorted(uniq, pfx).astype(jnp.int32)
    n_sub = jnp.sum(is_new.astype(jnp.int32))
    sub_base = rank * SUB_SLOTS

    entry = make_entry(jnp.arange(S), l)

    # root: short codes own [code << (10-l), (code+1) << (10-l)); each
    # long-code prefix owns exactly one slot holding the subptr entry
    r_start = jnp.where(short, code << (ROOT_BITS - jnp.minimum(l, ROOT_BITS)),
                        jnp.where(long_, pfx, ROOT_SIZE))
    r_size = jnp.where(short,
                       1 << (ROOT_BITS - jnp.minimum(l, ROOT_BITS)),
                       jnp.where(long_, 1, 0))
    r_entry = jnp.where(short, entry,
                        _entry(CLS_SUB, ROOT_BITS, 0, 0)
                        | jnp.minimum(sub_base, 0xFFFF))
    r_idx = jnp.where(valid, r_start, ROOT_SIZE)
    r_end = jnp.where(valid, r_start + r_size, ROOT_SIZE)
    root = _scatter_cummax_table(
        ROOT_SIZE, r_idx, r_end, r_entry, r_start, r_start + r_size)

    # subtables: the code's low (l - 10) bits placed in a 32-slot block
    low = code - (pfx << jnp.maximum(l - ROOT_BITS, 0))
    s_start = jnp.where(long_,
                        sub_base + (low << (15 - jnp.maximum(l, 1))), sub_size)
    s_size = jnp.where(long_, 1 << (15 - jnp.minimum(l, 15)), 0)
    s_end_raw = s_start + s_size
    # block-local cummax: an end at a 32-boundary needs no sentinel
    s_end = jnp.where((s_end_raw & (SUB_SLOTS - 1)) == 0, sub_size, s_end_raw)
    s_tag = s_start & (SUB_SLOTS - 1)
    s_etag = s_tag + s_size
    sub = _scatter_cummax_table(
        sub_size, jnp.where(long_, s_start, sub_size), s_end, entry,
        s_tag, s_etag, block=SUB_SLOTS)
    return root, sub, n_sub


def _lit_entry(sym, l):
    lbase = jnp.asarray(tables.LENGTH_BASE, jnp.int32)
    lextra = jnp.asarray(tables.LENGTH_EXTRA, jnp.int32)
    is_lit = sym < 256
    is_eob = sym == 256
    lcode = jnp.clip(sym - 257, 0, 28)
    cls = jnp.where(is_lit, CLS_LIT, jnp.where(is_eob, CLS_EOB, CLS_LEN))
    cls = jnp.where(sym > 285, CLS_INVALID, cls)
    xtr = jnp.where(sym > 256, lextra[lcode], 0)
    pay = jnp.where(is_lit, sym, jnp.where(is_eob, 0, lbase[lcode] - 3))
    e = _entry(cls, jnp.minimum(l, 15), xtr, pay)
    return jnp.where((l > 0) & (cls != CLS_INVALID), e, 0)


def _dist_entry(sym, l):
    dbase = jnp.asarray(tables.DIST_BASE, jnp.int32)
    dextra = jnp.asarray(tables.DIST_EXTRA, jnp.int32)
    scode = jnp.clip(sym, 0, 29)
    ok = sym < 30
    e = _entry(CLS_LIT, jnp.minimum(l, 15), dextra[scode], dbase[scode] - 1)
    return jnp.where((l > 0) & ok, e, 0)


@jax.jit
def build_member_tables(lit_lens, dist_lens):
    """Per-member two-level decode tables.

    lit_lens int32[M, 288], dist_lens int32[M, 32] ->
    (tabs int32[M, TABLE_WORDS] laid out lit root | lit sub | dist root
    | dist sub, ok bool[M]).  ``ok`` is False when a tree's long-code
    prefixes overflow the fixed subtable space (no tree this package
    writes does; such a member decodes as not ok).
    """
    lr, ls, ln = jax.vmap(
        lambda l: _build_one_root_sub(l, _lit_entry, LITSUB_SIZE))(lit_lens)
    dr, ds, dn = jax.vmap(
        lambda l: _build_one_root_sub(l, _dist_entry, DISTSUB_SIZE))(dist_lens)
    ok = (ln * SUB_SLOTS <= LITSUB_SIZE) & (dn * SUB_SLOTS <= DISTSUB_SIZE)
    return jnp.concatenate([lr, ls, dr, ds], axis=1), ok


def _peek32(lo, hi, sh):
    """32 stream bits starting ``sh`` bits into word ``lo``."""
    u32 = jnp.uint32
    return (lo >> sh) | jnp.where(sh == 0, u32(0),
                                  hi << ((u32(32) - sh) & u32(31)))


def _decode_kernel(n_slots: int, row_words: int):
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    u32 = jnp.uint32

    def kernel(words_ref, tabs_ref, start_ref, stop_ref, member_ref,
               _fill_ref, out_ref, ok_ref):
        lanes = pl.ds(pl.program_id(0) * BLOCK_LANES, BLOCK_LANES)
        stop = stop_ref[lanes]
        member = member_ref[lanes]
        wbase = member * row_words
        tbase = member * TABLE_WORDS
        last_word = words_ref.shape[0] - 1

        def word(idx):
            return words_ref[jnp.minimum(idx, last_word)]

        def lookup(base, sub_off, idx15, live):
            e = plgpu.load(tabs_ref.at[base + (idx15 >> SUB_BITS)],
                           mask=live, other=0)
            is_sub = live & ((e >> 24) == CLS_SUB)
            es = plgpu.load(
                tabs_ref.at[base + sub_off + (e & 0xFFFF)
                            + (idx15 & (SUB_SLOTS - 1))],
                mask=is_sub, other=0)
            return jnp.where(is_sub, es, e)

        def cond(carry):
            i, _, done, _ = carry
            return (i < n_slots) & (jnp.min(done) == 0)

        def body(carry):
            i, pos, done, bad = carry
            # bit-stopped rows: a row's commands are exactly those that
            # start before its stop bit
            live = (done == 0) & ~((stop > 0) & (pos >= stop))
            wi = wbase + (pos >> 5)
            w0 = word(wi)
            w1 = word(wi + 1)
            w2 = word(wi + 2)
            sh = (pos & 31).astype(u32)
            peek = _peek32(w0, w1, sh)
            e = lookup(tbase, LIT_SUB, _rev15(peek), live)
            cls = e >> 24
            nb = (e >> 20) & 15
            xtr = (e >> 16) & 15
            pay = e & 0xFFFF
            lext = ((peek >> nb.astype(u32))
                    & ((u32(1) << xtr.astype(u32)) - u32(1))).astype(jnp.int32)
            is_len = cls == CLS_LEN
            is_eob = cls == CLS_EOB
            value = jnp.where(is_len, pay + 3 + lext, pay)
            c1 = nb + xtr

            # the distance code starts c1 <= 20 bits on: at most one word
            # further, so the three words read above cover it
            o2 = pos + c1
            hop = (o2 >> 5) - (pos >> 5)
            sh2 = (o2 & 31).astype(u32)
            peek2 = _peek32(jnp.where(hop == 0, w0, w1),
                            jnp.where(hop == 0, w1, w2), sh2)
            de = lookup(tbase + DIST_ROOT, DIST_SUB - DIST_ROOT,
                        _rev15(peek2), live & is_len)
            dnb = (de >> 20) & 15
            dxn = (de >> 16) & 15
            dext = ((peek2 >> dnb.astype(u32))
                    & ((u32(1) << dxn.astype(u32)) - u32(1))).astype(jnp.int32)
            dist = (de & 0xFFFF) + 1 + dext
            c2 = jnp.where(is_len, dnb + dxn, 0)

            # an end-of-block inside a bit-stopped row is malformed
            sym_bad = ((cls == CLS_INVALID)
                       | (is_len & ((de >> 24) == CLS_INVALID))
                       | (is_eob & (stop > 0)))
            write = live & ~sym_bad
            okind = jnp.where(is_eob, 2, jnp.where(is_len, 1, 0))
            packed = (okind << 26) | (jnp.where(is_len, dist, 0) << 10) | value
            plgpu.store(out_ref.at[i, lanes], packed, mask=write)
            pos = pos + jnp.where(write, jnp.where(is_eob, c1, c1 + c2), 0)
            bad = bad | jnp.where(live & sym_bad, 1, 0)
            done = jnp.where(live & ~(write & is_eob) & ~sym_bad, 0, 1)
            return i + 1, pos, done, bad

        zeros = jnp.zeros(BLOCK_LANES, jnp.int32)
        _, pos, done, bad = jax.lax.while_loop(
            cond, body, (jnp.int32(0), start_ref[lanes], zeros, zeros))
        stopped = (stop > 0) & (pos >= stop)
        ok_ref[lanes] = jnp.where(((done != 0) | stopped) & (bad == 0), 1, 0)

    return kernel


@functools.partial(jax.jit, static_argnames=("n_slots", "interpret"))
def _decode(words, tabs, start_bits, stop_bits, row_members, n_slots: int,
            interpret: bool = False):
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    m, row_words = words.shape
    b = start_bits.shape[0]
    fill = jnp.full((n_slots, b), END_FILL, jnp.int32)
    cmds, ok = pl.pallas_call(
        _decode_kernel(n_slots, row_words),
        grid=(b // BLOCK_LANES,),
        out_shape=[jax.ShapeDtypeStruct((n_slots, b), jnp.int32),
                   jax.ShapeDtypeStruct((b,), jnp.int32)],
        input_output_aliases={5: 0},
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="inflate_decode_symbols",
    )(words.reshape(-1), tabs.reshape(-1), start_bits, stop_bits,
      row_members, fill)
    return cmds.T, ok != 0


def decode_symbols(words, start_bits, lit_lens, dist_lens, max_cmds: int,
                   stop_bits, row_members, interpret: bool = False):
    """Symbol decode of split rows, one kernel program per
    ``BLOCK_LANES`` rows.

    words uint32[M, W]; start_bits, stop_bits (0 = decode to
    end-of-block), row_members int32[B]; lit_lens int32[M, 288],
    dist_lens int32[M, 32].  Returns (kinds int8[B, max_cmds], values,
    dists int32[B, max_cmds], ok bool[B]) in the format of
    :func:`ops.inflate.decode_symbols`, with no NOP slots.
    """
    b = start_bits.shape[0]
    pad = -b % BLOCK_LANES
    if pad:
        # dead rows read the last member's tables with stop bit 1: they
        # stop before their first symbol
        start_bits = jnp.pad(start_bits, (0, pad))
        stop_bits = jnp.pad(stop_bits, (0, pad), constant_values=1)
        row_members = jnp.pad(row_members, (0, pad))
    tabs, tab_ok = build_member_tables(lit_lens, dist_lens)
    cmds, ok = _decode(words, tabs, start_bits.astype(jnp.int32),
                       stop_bits.astype(jnp.int32),
                       row_members.astype(jnp.int32), n_slots=max_cmds,
                       interpret=interpret)
    cmds, ok = cmds[:b], ok[:b] & tab_ok[row_members[:b]]
    return ((cmds >> 26).astype(jnp.int8), cmds & 0x3FF,
            (cmds >> 10) & 0xFFFF, ok)
