"""Device batch inflate: member-parallel DEFLATE decoding.

The reference's inflate is a byte-serial state machine (`De.Inf` hot
loop, de.ml:1054–1261).  Bit-serial decode of a *foreign* stream is
inherently sequential (SURVEY §7 "hard parts"), so the device design
splits the problem:

* foreign / streaming input → the native C++ state machine
  (native/tpuz.cpp), byte-serial but resumable;
* **our own archives** → member-parallel device decode: the sharded
  compressor records member byte offsets in a standard gzip FEXTRA
  index, so every member's single DEFLATE block can be decoded
  *simultaneously*, lockstep across the batch:

  1. hosts parse the tiny per-member block headers and build the
     two-level decode tables (the same construction as core/huffman);
  2. a device ``while_loop`` decodes whole commands lockstep across
     members from a carried 64-bit bit-window (16-bit conditional
     refills); table lookups are gathers into per-member table rows;
  3. LZ77 expansion: by default the used command prefixes are
     ragged-compacted on device (gather-only) and expanded by the
     native C++ runtime at memcpy speed; the fully-on-device
     alternative (literal scatter + interval-cover source computation
     + pointer-jumping copy resolution) serves device-resident
     pipelines and toolchain-less hosts.

Symbol throughput scales with batch size: the loop iteration count is
the *maximum* command count over members, so wider batches decode more
bytes for the same number of lockstep steps.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core import bitstream, huffman, tables

TABLE_BITS = 15       # single-level table: max DEFLATE code length
TABLE_SIZE = 1 << TABLE_BITS
MAX_TABLE = TABLE_SIZE   # kept for callers sizing padding rows
DIST_TABLE = TABLE_SIZE

#: fused lit-table entry (int32, 17 bits): kind(2)<<15 | nb(4)<<11 |
#: extra(3)<<8 | payload(8).  kind: 0 invalid, 1 literal, 2 length,
#: 3 end-of-block.  payload: literal byte, or length base minus 3.
LIT_INVALID = 0
#: fused dist-table entry (int32, 24 bits): valid(1)<<23 | nb(4)<<19 |
#: extra(4)<<15 | (base-1)(15)
DIST_INVALID = 0


class NotParallelizable(ValueError):
    """Stream shape the device decoder doesn't cover (multi-block
    members etc.) — callers fall back to the serial native path."""


def prepare_member(body: np.ndarray):
    """Host: parse one member's DEFLATE header; the body must be a
    single (final) fixed or dynamic block.  Returns ("huff",
    lit_lens[288] int32, dist_lens[32] int32, start_bit) — the decode
    tables themselves are built ON DEVICE (:func:`build_fused_tables`)
    so the host link carries ~320 bytes per member, not 256 KiB —
    or ("stored", bytes); raises NotParallelizable otherwise.
    """
    from .. import de

    r = bitstream.BitReader(body)
    bfinal = r.read(1)
    btype = r.read(2)
    if btype == 0:
        # stored member: a chain of stored chunks is pure byte slices —
        # resolved on host, no device work needed
        out = bytearray()
        while True:
            r.align_to_byte()
            ln = int.from_bytes(r.read_bytes(2).tobytes(), "little")
            nlen = int.from_bytes(r.read_bytes(2).tobytes(), "little")
            if ln != (nlen ^ 0xFFFF):
                raise de.MalformedError("invalid complement of length")
            out += r.read_bytes(ln).tobytes()
            if bfinal:
                return ("stored", bytes(out))
            bfinal = r.read(1)
            if r.read(2) != 0:
                raise NotParallelizable("mixed block kinds in member")
    if not bfinal or btype not in (1, 2):
        raise NotParallelizable("not a single fixed/dynamic block")
    if btype == 1:
        lit_lens = tables.FIXED_LIT_LENGTHS
        dist_lens = tables.FIXED_DIST_LENGTHS
    else:
        lit_lens, dist_lens = de._parse_dynamic_lengths(r)
    # host-side validity checks (the device build assumes sane trees)
    if huffman.kraft_slack(lit_lens) < 0 or huffman.kraft_slack(dist_lens) < 0:
        raise de.MalformedError("invalid dictionary")
    nd = int(np.sum(np.asarray(dist_lens) > 0))
    if huffman.kraft_slack(dist_lens) > 0 and nd > 1:
        raise de.MalformedError("invalid dictionary")
    if huffman.kraft_slack(lit_lens) > 0:
        raise de.MalformedError("invalid dictionary")
    ll = np.zeros(288, np.int32)
    ll[: np.asarray(lit_lens).size] = np.asarray(lit_lens, np.int32)
    dl = np.zeros(32, np.int32)
    dl[: np.asarray(dist_lens).size] = np.asarray(dist_lens, np.int32)
    start_bit = (r.pos * 8) - r.nbits
    return ("huff", ll, dl, start_bit)


def _first_codes(bl_count):
    """first canonical (MSB-first) code per length, [15]."""
    codes = []
    code = jnp.int32(0)
    for l in range(1, 16):
        codes.append(code)
        code = (code + bl_count[l - 1]) << 1
    # codes[l-1] is the first code of length l AFTER the shift chain:
    # standard RFC1951: code accumulates counts of shorter lengths
    return jnp.stack(codes)


def _build_one_table(lens, make_entry, entry_bits):
    """Forward-indexed (MSB-first, left-aligned) single-level decode
    table from code lengths, built with scatter + cummax.

    Every length-l code owns the index range [code << (15-l),
    (code+1) << (15-l)); scattering (start << 17 | entry_plane) and
    taking a running max fills each range with its entry.  Entries
    wider than 17 bits are split into 17-bit planes (int64 is
    unavailable); range ends get an invalid-entry sentinel so
    incomplete trees decode as invalid instead of bleeding the
    previous symbol.
    """
    S = lens.shape[0]
    l = lens
    oneh = (l[:, None] == jnp.arange(1, 16)[None, :]).astype(jnp.int32)
    bl_count = oneh.sum(0)
    first = _first_codes(bl_count)
    rank = jnp.cumsum(oneh, axis=0) - 1
    code = jnp.sum(oneh * (first[None, :] + rank), axis=1)
    valid = l > 0
    start = jnp.where(valid, code << (TABLE_BITS - jnp.maximum(l, 1)), 0)
    size = jnp.where(valid, 1 << (TABLE_BITS - jnp.minimum(l, TABLE_BITS)), 0)
    entry = make_entry(jnp.arange(S), l)
    idx = jnp.where(valid, start, TABLE_SIZE)           # drop absent syms
    ends = start + size
    endidx = jnp.where(valid, ends, TABLE_SIZE)          # == TABLE_SIZE drops
    W = 17
    pos_tag = start.astype(jnp.uint32) << W
    end_tag = ends.astype(jnp.uint32) << W
    acc = None
    for pl in range((entry_bits + W - 1) // W):
        pe = ((entry >> (pl * W)) & ((1 << W) - 1)).astype(jnp.uint32)
        t = jnp.zeros(TABLE_SIZE, jnp.uint32)
        t = t.at[idx].max(pos_tag | pe, mode="drop")
        t = t.at[endidx].max(end_tag, mode="drop")
        t = jax.lax.cummax(t)
        plane = (t & ((1 << W) - 1)).astype(jnp.int32)
        acc = plane if acc is None else acc | (plane << (pl * W))
    return acc


@jax.jit
def build_fused_tables(lit_lens, dist_lens):
    """Device-side decode-table build for a batch of members.

    lit_lens int32[M, 288], dist_lens int32[M, 32] ->
    (lit_tabs int32[M, 32768], dist_tabs int32[M, 32768]) with fused
    entries (symbol kind + code length + extra-bit count + base folded
    into one word), indexed by the FORWARD 15-bit code (the kernel
    bit-reverses its peek): one scatter and one cummax per table.
    """
    lbase = jnp.asarray(tables.LENGTH_BASE, jnp.int32)
    lextra = jnp.asarray(tables.LENGTH_EXTRA, jnp.int32)
    dbase = jnp.asarray(tables.DIST_BASE, jnp.int32)
    dextra = jnp.asarray(tables.DIST_EXTRA, jnp.int32)

    def lit_entry(sym, l):
        is_lit = sym < 256
        is_eob = sym == 256
        lcode = jnp.clip(sym - 257, 0, 28)
        kind = jnp.where(is_lit, 1, jnp.where(is_eob, 3, 2))
        extra = jnp.where(sym > 256, lextra[lcode], 0)
        payload = jnp.where(is_lit, sym, jnp.where(is_eob, 0, lbase[lcode] - 3))
        kind = jnp.where(sym > 285, 0, kind)
        return jnp.where(
            l > 0, (kind << 15) | (l << 11) | (extra << 8) | payload, 0)

    def dist_entry(sym, l):
        scode = jnp.clip(sym, 0, 29)
        ok = sym < 30
        e = (1 << 23) | (l << 19) | (dextra[scode] << 15) | (dbase[scode] - 1)
        return jnp.where((l > 0) & ok, e, 0)

    lit = jax.vmap(lambda ls: _build_one_table(ls, lit_entry, 17))(lit_lens)
    dist = jax.vmap(lambda ls: _build_one_table(ls, dist_entry, 24))(dist_lens)
    return lit, dist


def _rev15(x):
    """Reverse the low 15 bits (elementwise)."""
    u32 = jnp.uint32
    x = x.astype(u32) & u32(0x7FFF)
    x = ((x & u32(0x5555)) << 1) | ((x >> 1) & u32(0x5555))
    x = ((x & u32(0x3333)) << 2) | ((x >> 2) & u32(0x3333))
    x = ((x & u32(0x0F0F)) << 4) | ((x >> 4) & u32(0x0F0F))
    x = ((x & u32(0x00FF)) << 8) | ((x >> 8) & u32(0x00FF))
    return (x >> 1).astype(jnp.int32)  # 16-bit reverse -> drop 1 for 15


#: default window words per decode step.  A symbol consumes at most 48
#: bits (15 len code + 5 extra + 15 dist code + 13 extra), so a
#: worst-case 8-symbol step needs 14 words — but typical commands are
#: ~9–25 bits, so a 10-word (320-bit) window almost always feeds the
#: whole unroll, and the rare lane that runs out of bits mid-step emits
#: explicit NOP slots and resumes at the next step's re-gathered
#: window.  Gathered window elements drop from 1.75 to 1.25 per symbol
#: (of ~3.75 total).  Override per call (``nw=``), via NW_DEFAULT, or —
#: highest precedence, read at EVERY call so env sweeps work without
#: reimporting — via DECOMPRESS_TPU_INFLATE_NW.
NW_DEFAULT = 10


def _nw_default() -> int:
    import os

    env = os.environ.get("DECOMPRESS_TPU_INFLATE_NW")
    return int(env) if env is not None else NW_DEFAULT


#: decode-loop unroll: symbols attempted (slots written) per step
UNROLL = 8


def worst_case_slots(n_cmds: int, nw: int | None = None) -> int:
    """Slots sufficient to decode ``n_cmds`` commands at window ``nw``
    for ANY stream: a step starting at bit offset <= 31 decodes at
    least k = floor((BUDGET-31)/48) + 1 symbols (48 bits is the max
    command width) before exhausting its budget, so ceil(n/k) steps of
    UNROLL slots always suffice.  Callers size max_cmds with this so
    lowering the window knob cannot silently starve rows into the
    serial fallback."""
    nw = _nw_default() if nw is None else nw
    budget = 32 * nw - 53
    k = max(1, (budget - 31) // 48 + 1)
    return -(-n_cmds // k) * UNROLL

#: kinds value for a NOP slot (lane's bit window was exhausted
#: mid-step; no symbol was decoded — downstream consumers skip it)
KIND_NOP = 3


def decode_symbols(words, start_bits, lit_tabs, dist_tabs, max_cmds: int,
                   stop_counts=None, row_members=None, nw: int | None = None,
                   stop_bits=None):
    """Lockstep symbol decode across B members (or member *chunks*).

    words: uint32[M, W]; start_bits: int32[B]; lit_tabs/dist_tabs:
    int32[M, 32768] fused tables from :func:`build_fused_tables`;
    stop_counts: optional int32[B] — a row is done after decoding that
    many commands even without an end-of-block symbol (the
    split-indexed decode; 0 = EOB only).  row_members (int32[B]) maps
    rows to member arrays so chunk rows share one member upload.
    Returns (kinds int8[B, max_cmds] (0 lit, 1 copy, 2 end, 3 nop),
    values int32[B, max_cmds], dists int32[B, max_cmds], ok bool[B]).
    NOP slots carry no symbol (a lane exhausted its bit window
    mid-step); use :func:`slot_counts` to size per-row slot spans.

    Design: gather-frugal; the loop spends elementwise ops to avoid
    gathers: one stateless
    ``nw``-word bit-window gather per 8-symbol step (no carried
    hold/refill state; lanes that outrun the window emit NOPs for the
    remaining slots instead of forcing worst-case sizing), a single
    flat gather per code resolution (single-level forward table
    addressed by a bit-reversed peek — the reverse is ~10 register
    ops), and base/extra folded into the table entry: ~3.25 gathered
    elements per symbol per lane.  The CPU path and the reference for
    the GPU kernel (ops/inflate_triton.py).  Replaces the reference's
    byte-serial hot loop de.ml:1054-1261.
    """
    return _decode_symbols(words, start_bits, lit_tabs, dist_tabs,
                           max_cmds=max_cmds, stop_counts=stop_counts,
                           row_members=row_members,
                           nw=_nw_default() if nw is None else nw,
                           stop_bits=stop_bits)


@functools.partial(jax.jit, static_argnames=("max_cmds", "nw"))
def _decode_symbols(words, start_bits, lit_tabs, dist_tabs, max_cmds: int,
                    stop_counts, row_members, nw: int, stop_bits=None):
    b = start_bits.shape[0]
    M, wmax = words.shape
    words_f = words.reshape(-1)
    lit_f = lit_tabs.reshape(-1)
    dist_f = dist_tabs.reshape(-1)
    if row_members is None:
        row_members = jnp.arange(b, dtype=jnp.int32) % M
    wrow = row_members * wmax
    lrow = row_members * TABLE_SIZE
    drow = row_members * TABLE_SIZE
    u32 = jnp.uint32
    NW = nw
    # a symbol decode at window bit-offset o peeks [o, o+32) and
    # [o+c1, o+c1+32) with c1 <= 20; peek32 reads word lanes o>>5 and
    # o>>5 + 1, so it needs o+20 <= 32*(NW-1)-1, i.e. o <= 32*NW-53
    BUDGET = 32 * NW - 53
    assert BUDGET >= 31, "window must cover a 31-bit start offset"

    def step(carry):
        i, pos, done, bad, nreal, cmds = carry
        base = pos >> 5
        off0 = pos & 31
        ws = [words_f[wrow + jnp.minimum(base + k, wmax - 1)].astype(u32)
              for k in range(NW)]

        def peek32(o):
            lane = o >> 5
            sh = (o & 31).astype(u32)
            w0 = ws[0]
            w1 = ws[1]
            for k in range(1, NW):
                w0 = jnp.where(lane == k, ws[k], w0)
                w1 = jnp.where(lane == k, ws[min(k + 1, NW - 1)], w1)
            hi = jnp.where(sh == 0, u32(0), w1 << ((u32(32) - sh) & u32(31)))
            return (w0 >> sh) | hi

        o = off0
        new_done, new_bad = done, bad
        pos_new = pos
        slots = []
        for u in range(UNROLL):
            can = o <= BUDGET  # lane still has window bits for a symbol
            p = peek32(jnp.minimum(o, BUDGET))
            e = lit_f[lrow + _rev15(p)]
            kind = e >> 15
            nb = (e >> 11) & 15
            extra = (e >> 8) & 7
            payload = e & 0xFF
            lext = ((p >> nb.astype(u32)) &
                    ((u32(1) << extra.astype(u32)) - u32(1))).astype(jnp.int32)
            is_copy = kind == 2
            is_end = kind == 3
            value = jnp.where(is_copy, payload + 3 + lext, payload)
            c1 = nb + extra
            o2 = jnp.minimum(o + c1, BUDGET + 20)
            p2 = peek32(o2)
            de_ = dist_f[drow + _rev15(p2)]
            dvalid = (de_ >> 23) != 0
            dnb = (de_ >> 19) & 15
            dxn = (de_ >> 15) & 15
            dext = ((p2 >> dnb.astype(u32)) &
                    ((u32(1) << dxn.astype(u32)) - u32(1))).astype(jnp.int32)
            dist = (de_ & 0x7FFF) + 1 + dext
            c2 = jnp.where(is_copy, dnb + dxn, 0)

            if stop_bits is not None:
                # bit-stopped rows (compact TB index): a lane's commands
                # are exactly those starting before its stop bit
                new_done = new_done | ((stop_bits > 0) & (pos_new >= stop_bits))
            sym_bad = ((kind == 0) | (is_copy & ~dvalid)) & can
            write = ~new_done & can & ~sym_bad
            if stop_counts is not None or stop_bits is not None:
                # count/bit-stopped rows: mid-chunk end-of-block is
                # malformed
                interior = (stop_counts > 0) if stop_counts is not None \
                    else (stop_bits > 0)
                sym_bad = sym_bad | (write & is_end & interior)
                write = write & ~sym_bad
            nopped = ~new_done & ~can
            okind = jnp.where(is_end, 2, jnp.where(is_copy, 1, 0))
            packed = (okind << 26) | (jnp.where(is_copy, dist, 0) << 10) | value
            packed = jnp.where(
                write, packed,
                jnp.where(nopped, KIND_NOP << 26, 2 << 26))
            slots.append(packed)
            new_bad = new_bad | (~new_done & sym_bad)
            adv = jnp.where(write & ~is_end, c1 + c2,
                            jnp.where(write & is_end, c1, 0))
            o = o + jnp.where(write, c1 + c2, 0)
            pos_new = pos_new + adv
            new_done = new_done | (write & is_end) | new_bad
            nreal = nreal + write.astype(jnp.int32)
            if stop_counts is not None:
                new_done = new_done | ((stop_counts > 0) & (nreal >= stop_counts))
        # one [UNROLL, b] update per step instead of UNROLL row writes
        cmds = jax.lax.dynamic_update_slice(cmds, jnp.stack(slots), (i, 0))
        return i + UNROLL, pos_new, new_done, new_bad, nreal, cmds

    def cond(carry):
        i, _, done, _, _, _ = carry
        return (i < max_cmds - (UNROLL - 1)) & ~jnp.all(done)

    cmds0 = jnp.full((max_cmds, b), 2 << 26, jnp.int32)
    init = (jnp.int32(0), start_bits.astype(jnp.int32),
            jnp.zeros(b, bool), jnp.zeros(b, bool),
            jnp.zeros(b, jnp.int32), cmds0)
    _, _, done, bad, _, cmds = jax.lax.while_loop(cond, step, init)
    cmds = cmds.T
    kinds = (cmds >> 26).astype(jnp.int8)
    values = cmds & 0x3FF
    dists = (cmds >> 10) & 0xFFFF
    ok = done & ~bad
    return kinds, values, dists, ok


@jax.jit
def slot_counts(kinds, stop_counts):
    """Per-row SLOT span (NOP slots included): for count-stopped rows,
    the slots holding the first ``stop_counts`` real commands; for
    EOB-terminated rows, slots up to and including the end marker."""
    real = (kinds == 0) | (kinds == 1)
    cum = jnp.cumsum(real.astype(jnp.int32), axis=1)
    stopped = jnp.sum((cum < stop_counts[:, None]).astype(jnp.int32), axis=1) + 1
    ended = jnp.argmax(kinds == 2, axis=1).astype(jnp.int32) + 1
    return jnp.where(stop_counts > 0, stopped, ended)


@jax.jit
def slot_counts_bits(kinds, stop_bits):
    """Slot spans for BIT-stopped rows (compact TB index): interior
    rows (stop_bits > 0) end at the first END-filler slot, which is NOT
    part of the row (their real commands carry no end marker); EOB rows
    include their end marker as before."""
    first_end = jnp.argmax(kinds == 2, axis=1).astype(jnp.int32)
    return jnp.where(stop_bits > 0, first_end, first_end + 1)


@functools.partial(jax.jit, static_argnames=("max_cmds",))
def decode_symbols_packed(words, start_bits, lit_tabs, dist_tabs, max_cmds: int):
    """Like :func:`decode_symbols` but returns the packed [B, max_cmds]
    command words directly (for host-side expansion) plus ok flags."""
    kinds, values, dists, ok = decode_symbols(
        words, start_bits, lit_tabs, dist_tabs, max_cmds
    )
    packed = (kinds.astype(jnp.int32) << 26) | (dists << 10) | values
    return packed, ok


@functools.partial(jax.jit, static_argnames=("out_size",))
def compact_commands(packed, ncmds, out_size: int):
    """Ragged device-side compaction: concatenate each member's first
    ncmds[b] packed commands into one flat buffer (gather-only), so the
    host fetches ~sum(ncmds) words instead of the padded matrix."""
    b, m = packed.shape
    offsets = jnp.cumsum(ncmds)  # inclusive
    starts = offsets - ncmds
    j = jnp.arange(out_size, dtype=jnp.int32)
    member = jnp.searchsorted(offsets, j, side="right").astype(jnp.int32)
    member = jnp.minimum(member, b - 1)
    idx = jnp.clip(j - starts[member], 0, m - 1)
    flat = packed[member, idx]
    return jnp.where(j < offsets[-1], flat, 2 << 26)


@functools.partial(jax.jit, static_argnames=())
def command_counts(kinds):
    """Commands per member including the end marker."""
    return jnp.argmax(kinds == 2, axis=1).astype(jnp.int32) + 1


@functools.partial(jax.jit, static_argnames=("out_len", "max_rounds"))
def expand_commands(kinds, values, dists, out_len: int, max_rounds: int | None = None):
    """LZ77 expansion: commands -> bytes, member-parallel.

    For every output byte, compute its *source*: literals root the
    chains; copy bytes point at ``opos - dist + ((j - opos) % dist)``
    (modular arithmetic realises overlapping-copy semantics).  Pointer
    jumping resolves copy-of-copy chains in log(depth) rounds.
    Returns (payload uint8[B, out_len], lengths int32[B]).
    """
    if max_rounds is None:
        # chains are < out_len deep; doubling needs log2 rounds
        max_rounds = max(4, out_len.bit_length() + 1)
    b, m = kinds.shape
    is_lit = kinds == 0
    is_copy = kinds == 1
    clen = jnp.where(is_copy, values, jnp.where(is_lit, 1, 0))
    opos = jnp.cumsum(clen, axis=1) - clen  # output offset of each cmd
    total = opos[:, -1] + clen[:, -1]

    def one(is_lit, is_copy, values, dists, clen, opos, total):
        j = jnp.arange(out_len, dtype=jnp.int32)
        # literal scatter: value byte -> its output position
        lit_pos = jnp.where(is_lit, opos, out_len)  # drop non-literals
        lit_val = jnp.where(is_lit, values, 0)
        out_lit = jnp.zeros(out_len + 1, jnp.int32).at[lit_pos].add(lit_val, mode="drop")[:out_len]
        has_lit = jnp.zeros(out_len + 1, jnp.int32).at[lit_pos].add(
            jnp.where(is_lit, 1, 0), mode="drop")[:out_len] > 0
        # copy cover: scatter each copy's cmd index at its start, then
        # cummax gives the covering copy for every position
        marker = jnp.full(out_len, -1, jnp.int32).at[
            jnp.where(is_copy, opos, out_len)
        ].max(jnp.where(is_copy, jnp.arange(m), -1), mode="drop")
        cov = jax.lax.cummax(marker)
        safe_cov = jnp.maximum(cov, 0)
        c_opos = opos[safe_cov]
        c_len = clen[safe_cov]
        c_dist = dists[safe_cov]
        covered = (cov >= 0) & (j < c_opos + c_len) & is_copy[safe_cov] & (j < total)
        k = j - c_opos
        src = c_opos - c_dist + (k % jnp.maximum(c_dist, 1))
        src = jnp.where(covered, src, j)  # literals/self point at self
        src = jnp.clip(src, 0, out_len - 1)

        # pointer jumping until literal-rooted
        def jump_cond(state):
            rounds, cur, changed = state
            return (rounds < max_rounds) & changed

        def jump_body(state):
            rounds, cur, _ = state
            nxt = cur[cur]
            return rounds + 1, nxt, jnp.any(nxt != cur)

        _, root, _ = jax.lax.while_loop(
            jump_cond, jump_body, (jnp.int32(0), src, jnp.bool_(True))
        )
        out = out_lit[root].astype(jnp.uint8)
        return out, total

    return jax.vmap(one)(is_lit, is_copy, values, dists, clen, opos, total)
