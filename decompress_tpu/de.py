"""Raw DEFLATE (RFC 1951): one-shot encode/decode + building blocks.

The device-parallel counterpart of the reference's `De` module
(lib/de.ml).  Capability parity:

* ``deflate`` — one-shot compressor (role of `De.Def.Ns.deflate`,
  de.ml:3998–4009, and the `Lz77`+`Def` streaming pair): block-parallel
  two-pass pipeline — device LZ77 analysis per 32 KiB-history segment
  (ops/lz77.py), host Huffman tree construction + exact 3-way
  stored/fixed/dynamic block cost choice (semantics of
  `block_of_frequencies` de.ml:2415–2449 and `flush_block`
  de.ml:3620–3692), device two-pass bit packing (ops/bitpack.py).
* ``inflate`` — host reference inflate (role of `De.Inf.Ns.inflate`,
  de.ml:1534–1823): table-driven, byte-exact, used as the universal
  slow path and the oracle for the device batch decoder.  Error
  messages mirror de.mli:150–157.
* command-queue packing parity (`De.Queue`, de.ml:2245–2252) for the
  streaming API and property tests.

Every output stream is standard DEFLATE, decodable by any RFC 1951
inflater; matches may reference the previous segment's bytes (the
32 KiB history prefix), so whole-stream window semantics match the
reference's sliding window.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .core import bitstream, huffman, tables
from .core.tables import (
    DIST_BASE,
    DIST_EXTRA,
    EOB,
    LENGTH_BASE,
    LENGTH_EXTRA,
    MAX_MATCH,
    MIN_MATCH,
    NUM_DIST_SYMS,
    NUM_LIT_SYMS,
    PRECODE_ORDER,
    WINDOW_SIZE,
)

io_buffer_size = 65536  # parity with de.ml:207

# ---------------------------------------------------------------------------
# Command packing (De.Queue parity, de.ml:2245–2252).
# ---------------------------------------------------------------------------

_CMD_COPY_FLAG = 0x2000000


def cmd_literal(byte: int) -> int:
    return byte & 0xFF


def cmd_copy(off: int, length: int) -> int:
    """Packed copy command: ((len-3) << 16) | (off-1) | copy flag."""
    if not (1 <= off <= WINDOW_SIZE):
        raise ValueError("invalid offset")
    if not (MIN_MATCH <= length <= MAX_MATCH):
        raise ValueError("invalid length")
    return ((length - MIN_MATCH) << 16) | (off - 1) | _CMD_COPY_FLAG


CMD_EOB = 256


def cmd_is_copy(cmd: int) -> bool:
    return bool(cmd & _CMD_COPY_FLAG)


def cmd_unpack(cmd: int):
    """-> ('literal', byte) | ('copy', (off, len)) | ('end', None)."""
    if cmd & _CMD_COPY_FLAG:
        return "copy", ((cmd & 0xFFFF) + 1, ((cmd >> 16) & 0x1FF) + MIN_MATCH)
    if cmd == CMD_EOB:
        return "end", None
    return "literal", cmd & 0xFF


# ---------------------------------------------------------------------------
# Dynamic block header serialization (host; De.Def dynamic_of_frequencies
# de.ml:2387–2407 + T.scan/symbols de.ml:2070–2191).
# ---------------------------------------------------------------------------


def _rle_code_lengths(lengths: np.ndarray):
    """RFC 1951 §3.2.7 code-length RLE: yields (sym, extra_val, extra_bits)."""
    out = []
    n = lengths.size
    i = 0
    while i < n:
        v = int(lengths[i])
        j = i + 1
        while j < n and int(lengths[j]) == v:
            j += 1
        run = j - i
        if v == 0:
            while run >= 11:
                r = min(run, 138)
                out.append((18, r - 11, 7))
                run -= r
            if run >= 3:
                out.append((17, run - 3, 3))
                run = 0
            for _ in range(run):
                out.append((0, 0, 0))
        else:
            out.append((v, 0, 0))
            run -= 1
            while run >= 3:
                r = min(run, 6)
                out.append((16, r - 3, 2))
                run -= r
            for _ in range(run):
                out.append((v, 0, 0))
        i = j
    return out


@dataclasses.dataclass
class DynamicHeader:
    values: np.ndarray  # uint32 pairs to emit (excluding BFINAL/BTYPE)
    nbits: np.ndarray
    bit_length: int


def build_dynamic_header(lit_lengths: np.ndarray, dist_lengths: np.ndarray) -> DynamicHeader:
    """Serialize HLIT/HDIST/HCLEN + precode + RLE'd code lengths."""
    hlit = max(257, int(np.max(np.nonzero(lit_lengths)[0])) + 1) if np.any(lit_lengths) else 257
    nz_d = np.nonzero(dist_lengths)[0]
    hdist = (int(nz_d[-1]) + 1) if nz_d.size else 1
    seq = np.concatenate([lit_lengths[:hlit], dist_lengths[:hdist]])
    rle = _rle_code_lengths(seq)

    pre_freq = np.zeros(19, dtype=np.int64)
    for sym, _, _ in rle:
        pre_freq[sym] += 1
    pre_lengths = huffman.code_lengths_from_frequencies(pre_freq, max_length=7)
    pre_codes = huffman.canonical_codes(pre_lengths)

    order = PRECODE_ORDER
    hclen = 19
    while hclen > 4 and pre_lengths[order[hclen - 1]] == 0:
        hclen -= 1

    values = [hlit - 257, hdist - 1, hclen - 4]
    nbits = [5, 5, 4]
    for k in range(hclen):
        values.append(int(pre_lengths[order[k]]))
        nbits.append(3)
    for sym, extra_val, extra_bits in rle:
        values.append(int(pre_codes[sym]))
        nbits.append(int(pre_lengths[sym]))
        if extra_bits:
            values.append(extra_val)
            nbits.append(extra_bits)
    values = np.array(values, dtype=np.uint32)
    nbits = np.array(nbits, dtype=np.int32)
    return DynamicHeader(values, nbits, int(nbits.sum()))


# ---------------------------------------------------------------------------
# Block cost model (exact; reference 3-way chooser de.ml:3620–3692).
# ---------------------------------------------------------------------------

_FIXED_LIT_BITS = tables.FIXED_LIT_LENGTHS.astype(np.int64)
_FIXED_DIST_BITS = tables.FIXED_DIST_LENGTHS.astype(np.int64)[:30]
_LEN_EXTRA_OF_SYM = np.concatenate([np.zeros(257, np.int64), LENGTH_EXTRA.astype(np.int64)])
_DIST_EXTRA_OF_SYM = DIST_EXTRA.astype(np.int64)


def symbol_cost_bits(hist_lit: np.ndarray, hist_dist: np.ndarray,
                     lit_bits: np.ndarray, dist_bits: np.ndarray) -> int:
    """Exact bit cost of the symbol section (incl. extra bits, excl. header)."""
    lit = int(np.sum(hist_lit * (lit_bits[: hist_lit.size].astype(np.int64) + _LEN_EXTRA_OF_SYM[: hist_lit.size])))
    dst = int(np.sum(hist_dist * (dist_bits[: hist_dist.size].astype(np.int64) + _DIST_EXTRA_OF_SYM[: hist_dist.size])))
    return lit + dst


def stored_cost_bits(n: int, bitpos_in_byte: int) -> int:
    """Exact stored-block cost (reference 3-way chooser, de.ml:3620-3692).

    Each chunk is a 3-bit header, padding to the next byte boundary, a
    32-bit LEN/NLEN word, then the raw bytes.  Chunks after the first
    start byte-aligned, so their padding is exactly 5 bits.
    """
    nchunks = max(1, (n + 65534) // 65535)
    bits = 3 + ((-(bitpos_in_byte + 3)) % 8) + 32
    bits += (nchunks - 1) * (3 + 5 + 32)
    return bits + 8 * n


# ---------------------------------------------------------------------------
# One-shot deflate.
# ---------------------------------------------------------------------------

# Payload bytes per device segment: just under 2^17 so the parallel
# parse domain (pow2(seg + MAX_MATCH + 1)) stays at 2^17 instead of
# doubling — the parse costs one gather pass per level per element.
SEGMENT_SIZE = (1 << 17) - 512
# Segments per device call.  Wider batches amortize the fixed cost of
# each dispatched operation (the parse and probe lax.scans are made of
# thin gathers), at the price of proportional device memory and compile
# time; the env knob exists for on-chip sweeps.
import os as _os

MAX_DEVICE_BATCH = int(_os.environ.get("DECOMPRESS_TPU_BATCH", "8"))
_HDR_PAD = 1024          # padded header slots per segment in the pack call


def _np_u8(data) -> np.ndarray:
    if isinstance(data, np.ndarray) and data.dtype == np.uint8:
        return data
    return np.frombuffer(bytes(data), dtype=np.uint8)


def _emit_stored(w: bitstream.BitWriter, payload: np.ndarray, final: bool) -> None:
    n = payload.size
    chunks = [(i, min(i + 65535, n)) for i in range(0, n, 65535)] or [(0, 0)]
    for ci, (lo, hi) in enumerate(chunks):
        last = final and ci == len(chunks) - 1
        w.write(1 if last else 0, 1)
        w.write(0, 2)
        w.align_to_byte()
        ln = hi - lo
        w.write(ln, 16)
        w.write(ln ^ 0xFFFF, 16)
        w.write_bytes(payload[lo:hi])


def compress_bound(n: int, segment_size: int | None = None) -> int:
    """Upper bound on :func:`deflate` output size for any level
    (`Def.Ns.compress_bound` parity, de.ml:3993–3996).

    The planner never emits a block bigger than its stored encoding
    (exact 3-way cost, de.ml:3620–3692), so the bound is the stored
    worst case — up to 6 bytes of header + alignment per emitted
    stored chunk, one per min(segment, 65535) bytes — plus slack for
    the final empty block."""
    chunk = min(segment_size or SEGMENT_SIZE, 65535)
    return n + 6 * (n // chunk + 1) + 16


#: strategy name -> dedicated LEVELS slot (zlib Z_RLE / Z_HUFFMAN_ONLY
#: analogues; "fixed" is the dynamic=False knob, zl.ml:560)
STRATEGY_LEVELS = {"rle": 100, "huffman_only": 101}


def deflate(data, level: int | None = None, *, segment_size: int | None = None,
            dynamic: bool | None = None, window_bits: int | None = None,
            dictionary: bytes | None = None,
            strategy: str | None = None,
            config=None) -> bytes:
    """One-shot DEFLATE compress (device pipeline; level 0 = stored).

    ``dynamic=False`` forces fixed-Huffman blocks (the reference
    Zl.Def ``~dynamic`` knob, zl.ml:560).  ``window_bits`` (8..15)
    restricts match distances to a small window (`make_window ~bits`
    parity, de.ml:331–333) so the stream decodes with a 2^bits-byte
    window.  ``dictionary`` seeds the match window (zlib zdict
    semantics — the reference only records the FDICT flag,
    zl.ml:254/271; decoding needs the same dictionary via
    ``inflate(window=...)``)."""
    # explicit arguments win over the config object, which wins over
    # the built-in defaults (utils/config.CodecConfig, SURVEY §5.6)
    if config is not None:
        config.validate()
        level = config.level if level is None else level
        segment_size = segment_size or config.segment_size
        dynamic = config.dynamic_blocks if dynamic is None else dynamic
        window_bits = config.window_bits if window_bits is None else window_bits
    level = 6 if level is None else level
    dynamic = True if dynamic is None else dynamic
    window_bits = 15 if window_bits is None else window_bits
    if not 8 <= window_bits <= 15:
        raise ValueError("window_bits must be in 8..15")
    if strategy is not None:
        if strategy == "fixed":
            dynamic = False
        elif strategy in STRATEGY_LEVELS:
            level = STRATEGY_LEVELS[strategy] if level != 0 else 0
        else:
            raise ValueError(f"unknown strategy {strategy!r}")
    arr = _np_u8(data)
    n = arr.size
    w = bitstream.BitWriter()
    if n == 0:
        # empty fixed block: cheapest legal empty stream
        codes = huffman.canonical_codes(tables.FIXED_LIT_LENGTHS)
        w.write(1, 1)
        w.write(1, 2)
        w.write(int(codes[EOB]), int(tables.FIXED_LIT_LENGTHS[EOB]))
        return w.getvalue()
    if level == 0:
        _emit_stored(w, arr, final=True)
        return w.getvalue()

    from .ops import lz77 as lz77_ops  # deferred: importing jax is heavy

    seg = segment_size or SEGMENT_SIZE
    nseg = (n + seg - 1) // seg
    head = None
    if dictionary:
        d = _np_u8(dictionary)
        head = d[-min(d.size, tables.WINDOW_SIZE):]
    _deflate_pipelined(w, arr, nseg, level, seg, lz77_ops,
                       force_block=None if dynamic else "fixed",
                       window_bits=window_bits, dict_hist=head)
    return w.getvalue()


#: batches dispatched ahead of the host planning stage (bounds memory
#: while letting device analysis overlap host tree building / transfers)
PIPELINE_DEPTH = 4


def _build_batch(arr, seg_lo, seg_hi, seg, lz77_ops, dict_hist=None):
    n = arr.size
    b = seg_hi - seg_lo
    b_pad = MAX_DEVICE_BATCH if b == MAX_DEVICE_BATCH else 1 << (b - 1).bit_length()
    data = np.zeros((b_pad, lz77_ops.HIST + seg), dtype=np.uint8)
    n_valid = np.zeros(b_pad, dtype=np.int32)
    hist_len = np.zeros(b_pad, dtype=np.int32)
    for i, s in enumerate(range(seg_lo, seg_hi)):
        start = s * seg
        stop = min(start + seg, n)
        n_valid[i] = stop - start
        # preset dictionary: virtual history before position 0
        dlen = 0 if dict_hist is None else dict_hist.size
        hl = min(lz77_ops.HIST, start + dlen)
        hist_len[i] = hl
        from_arr = min(hl, start)
        from_dict = hl - from_arr
        if from_dict:
            data[i, lz77_ops.HIST - hl : lz77_ops.HIST - from_arr] = \
                dict_hist[dlen - from_dict :]
        data[i, lz77_ops.HIST - from_arr : lz77_ops.HIST] = arr[start - from_arr : start]
        data[i, lz77_ops.HIST : lz77_ops.HIST + (stop - start)] = arr[start:stop]
    return data, n_valid, hist_len, b


_ASSEMBLE_JIT = None


def _assemble_batch_device(payload, head_hist):
    """Device-side batch assembly: rows are consecutive segments, so
    row i's 32 KiB history is row i-1's payload tail; only the first
    row's history (and the payloads) cross the host->device link —
    ~20% less upload than shipping history per row."""
    global _ASSEMBLE_JIT
    if _ASSEMBLE_JIT is None:
        import jax
        import jax.numpy as jnp

        @jax.jit
        def assemble(pay, head):
            hist = head.shape[0]
            seg = pay.shape[1]
            prev_tail = pay[:-1, seg - hist:]
            hists = jnp.concatenate([head[None], prev_tail], axis=0)
            return jnp.concatenate([hists, pay], axis=1)

        _ASSEMBLE_JIT = assemble
    return _ASSEMBLE_JIT(payload, head_hist)


def _build_batch_payload(arr, seg_lo, seg_hi, seg, lz77_ops, dict_hist=None):
    """Payload-only host buffers for :func:`_assemble_batch_device`
    (requires seg >= HIST so one previous row covers the window)."""
    n = arr.size
    b = seg_hi - seg_lo
    b_pad = MAX_DEVICE_BATCH if b == MAX_DEVICE_BATCH else 1 << (b - 1).bit_length()
    payload = np.zeros((b_pad, seg), dtype=np.uint8)
    n_valid = np.zeros(b_pad, dtype=np.int32)
    hist_len = np.zeros(b_pad, dtype=np.int32)
    dlen = 0 if dict_hist is None else dict_hist.size
    for i, s in enumerate(range(seg_lo, seg_hi)):
        start = s * seg
        stop = min(start + seg, n)
        n_valid[i] = stop - start
        hist_len[i] = min(lz77_ops.HIST, start + dlen)
        payload[i, : stop - start] = arr[start:stop]
    start0 = seg_lo * seg
    hl0 = min(lz77_ops.HIST, start0 + dlen)
    head = np.zeros(lz77_ops.HIST, dtype=np.uint8)
    from_arr = min(hl0, start0)
    from_dict = hl0 - from_arr
    if from_dict:
        head[lz77_ops.HIST - hl0 : lz77_ops.HIST - from_arr] = \
            dict_hist[dlen - from_dict :]
    if from_arr:
        head[lz77_ops.HIST - from_arr :] = arr[start0 - from_arr : start0]
    return payload, head, n_valid, hist_len, b


def _deflate_pipelined(w, arr, nseg, level, seg, lz77_ops, force_block=None,
                       window_bits=15, dict_hist=None):
    """Pipelined segment compression: analysis for upcoming batches is
    dispatched ahead (JAX async) while the host plans/assembles earlier
    ones, hiding host time and transfers under device compute."""
    import jax.numpy as jnp

    batches = [
        (lo, min(lo + MAX_DEVICE_BATCH, nseg))
        for lo in range(0, nseg, MAX_DEVICE_BATCH)
    ]
    inflight: list = []

    def dispatch(bi):
        lo, hi = batches[bi]
        if seg >= lz77_ops.HIST:
            payload, head, n_valid, hist_len, b = _build_batch_payload(
                arr, lo, hi, seg, lz77_ops, dict_hist=dict_hist)
            d_data = _assemble_batch_device(jnp.asarray(payload),
                                            jnp.asarray(head))
            data = payload
        else:
            data, n_valid, hist_len, b = _build_batch(arr, lo, hi, seg, lz77_ops,
                                                      dict_hist=dict_hist)
            d_data = jnp.asarray(data)
        res = lz77_ops.lz77_analyze(
            d_data, jnp.asarray(n_valid), jnp.asarray(hist_len),
            level=level, seg_len=seg, window_bits=window_bits,
        )
        return (lo, hi, data, n_valid, hist_len, b, d_data, res)

    for bi in range(min(PIPELINE_DEPTH, len(batches))):
        inflight.append(dispatch(bi))
    next_dispatch = len(inflight)

    for bi in range(len(batches)):
        lo, hi, data, n_valid, hist_len, b, d_data, res = inflight.pop(0)
        if next_dispatch < len(batches):
            inflight.append(dispatch(next_dispatch))
            next_dispatch += 1
        # overestimate repair (trim-and-reparse) + the two-round
        # cost-aware re-parse both live in analyze2_finish
        res = lz77_ops.analyze2_finish(
            res, d_data, jnp.asarray(n_valid), jnp.asarray(hist_len),
            level=level, seg_len=seg, window_bits=window_bits,
        )
        _finish_batch(w, arr, lo, hi, nseg, level, seg, lz77_ops,
                      data, n_valid, b, d_data, res, force_block)


def plan_blocks(hist_lit, hist_dist, n_valid, final_flags, *, pad_to=None,
                force_block=None, shared_tree=False):
    """Host planning for a batch of blocks: choose stored/fixed/dynamic
    per block (exact 3-way cost, de.ml:3620–3692 semantics), build the
    Huffman code tables and serialized headers for the device packer.

    With ``shared_tree`` (the SURVEY §2 all-reduced-frequencies mode)
    the dynamic trees are built ONCE from the row-summed frequencies and
    every dynamic block reuses them — one tree build for the whole
    batch (the host-planning bottleneck at small member sizes), and the
    multi-chip pattern is a ~300-int frequency all-reduce instead of
    per-member tree exchange.  Per-block stored/fixed fallback still
    applies.

    Returns ((hdr_vals, hdr_bits), (lit_codes, lit_bits, dist_codes,
    dist_bits, eob_vals, eob_bits), kinds).
    """
    b = hist_lit.shape[0]
    b_pad = pad_to or b
    shared = None
    if shared_tree:
        if isinstance(shared_tree, tuple):
            shared = shared_tree  # precomputed (lit_len, dist_len, header)
        else:
            hl_sum = hist_lit.astype(np.int64).sum(axis=0)
            hl_sum[EOB] += b  # one EOB per block
            hd_sum = hist_dist.astype(np.int64).sum(axis=0)
            s_lit_len = huffman.code_lengths_from_frequencies(hl_sum)
            s_dist_len = huffman.code_lengths_from_frequencies(hd_sum)
            shared = (s_lit_len, s_dist_len,
                      build_dynamic_header(s_lit_len, s_dist_len))
    hdr_vals = np.zeros((b_pad, _HDR_PAD), dtype=np.uint32)
    hdr_bits = np.zeros((b_pad, _HDR_PAD), dtype=np.int32)
    lit_codes = np.zeros((b_pad, NUM_LIT_SYMS), dtype=np.uint32)
    lit_bits = np.zeros((b_pad, NUM_LIT_SYMS), dtype=np.int32)
    dist_codes = np.zeros((b_pad, NUM_DIST_SYMS), dtype=np.uint32)
    dist_bits = np.zeros((b_pad, NUM_DIST_SYMS), dtype=np.int32)
    eob_vals = np.zeros((b_pad, 1), dtype=np.uint32)
    eob_bits = np.zeros((b_pad, 1), dtype=np.int32)
    kinds = []
    for i in range(b):
        final = bool(final_flags[i])
        hl = hist_lit[i].astype(np.int64)
        hl[EOB] += 1
        hd = hist_dist[i].astype(np.int64)

        if shared is not None:
            dyn_lit_len, dyn_dist_len, header = shared
        else:
            dyn_lit_len = huffman.code_lengths_from_frequencies(hl)
            dyn_dist_len = huffman.code_lengths_from_frequencies(hd)
            header = build_dynamic_header(dyn_lit_len, dyn_dist_len)
        cost_dyn = 3 + header.bit_length + symbol_cost_bits(hl, hd, dyn_lit_len, dyn_dist_len)
        cost_fix = 3 + symbol_cost_bits(hl, hd, _FIXED_LIT_BITS, _FIXED_DIST_BITS)
        cost_sto = stored_cost_bits(int(n_valid[i]), 0)

        # Z_FIXED parity (zlib deflate.c): forbidding dynamic trees does
        # NOT forbid stored blocks — otherwise incompressible data would
        # expand past compress_bound()'s guarantee.
        cost_packed = cost_fix if force_block == "fixed" else min(cost_dyn, cost_fix)
        if cost_sto < cost_packed:
            kinds.append("stored")
            continue
        if force_block == "fixed" or (force_block is None and cost_fix <= cost_dyn):
            kinds.append("fixed")
            ll, dl = tables.FIXED_LIT_LENGTHS, tables.FIXED_DIST_LENGTHS[:30]
            pairs = [(1 if final else 0, 1), (1, 2)]
        else:
            kinds.append("dynamic")
            ll, dl = dyn_lit_len, dyn_dist_len
            pairs = [(1 if final else 0, 1), (2, 2)]
        lc = huffman.canonical_codes(ll)
        dc = huffman.canonical_codes(dl)
        lit_codes[i, : lc.size] = lc[:NUM_LIT_SYMS]
        lit_bits[i, : lc.size] = ll[:NUM_LIT_SYMS]
        dist_codes[i] = dc[:NUM_DIST_SYMS]
        dist_bits[i] = dl[:NUM_DIST_SYMS]
        eob_vals[i, 0] = lc[EOB]
        eob_bits[i, 0] = ll[EOB]
        if kinds[-1] == "dynamic":
            pairs += list(zip(header.values.tolist(), header.nbits.tolist()))
        for j, (v, nb) in enumerate(pairs):
            hdr_vals[i, j] = v
            hdr_bits[i, j] = nb
    tabs = (lit_codes, lit_bits, dist_codes, dist_bits, eob_vals, eob_bits)
    return (hdr_vals, hdr_bits), tabs, kinds


def _finish_batch(w, arr, seg_lo, seg_hi, nseg, level, seg, lz77_ops,
                  data, n_valid, b, d_data, res, force_block=None):
    """Host half of one batch: block planning, device pack, assembly."""
    import jax.numpy as jnp

    b_pad = data.shape[0]
    hist_lit = np.asarray(res["hist_lit"])
    hist_dist = np.asarray(res["hist_dist"])

    final_flags = np.array(
        [(seg_lo + i) == nseg - 1 for i in range(b)], dtype=bool
    )
    (hdr_vals, hdr_bits), tabs, kinds = plan_blocks(
        hist_lit[:b], hist_dist[:b], n_valid[:b], final_flags, pad_to=b_pad,
        force_block=force_block,
    )
    lit_codes, lit_bits, dist_codes, dist_bits, eob_vals, eob_bits = tabs

    # any packed (non-stored) block beat the stored cost, so < ~9 bits/byte
    out_words = (9 * seg) // 32 + 2 * _HDR_PAD
    words, totals = _pack_segments(
        res, d_data[:, lz77_ops.HIST :],
        jnp.asarray(hdr_vals), jnp.asarray(hdr_bits),
        lit_codes, lit_bits, dist_codes, dist_bits,
        jnp.asarray(eob_vals), jnp.asarray(eob_bits),
        out_words,
    )
    totals = np.asarray(totals)
    # fetch only the words actually used by non-stored segments
    used = [int(totals[i]) for i in range(b) if kinds[i] != "stored"]
    cap = (max(used) + 31) // 32 + 1 if used else 0
    words = np.asarray(words[:, :cap]) if cap else np.zeros((b_pad, 0), np.uint32)

    for i in range(b):
        final = (seg_lo + i) == nseg - 1
        start = (seg_lo + i) * seg
        if kinds[i] == "stored":
            payload = arr[start : start + int(n_valid[i])]
            _emit_stored(w, payload, final=final)
        else:
            w.write_packed(
                np.frombuffer(words[i].astype("<u4").tobytes(), dtype=np.uint8),
                int(totals[i]),
            )


_PACK_JIT = None


def _get_pack_jit():
    global _PACK_JIT
    if _PACK_JIT is not None:
        return _PACK_JIT
    import functools

    import jax
    import jax.numpy as jnp

    from .ops import bitpack as bitpack_ops
    from .ops import codes as codes_ops

    @functools.partial(jax.jit,
                       static_argnames=("out_words", "n_splits",
                                        "split_stride", "split_bits"))
    def pack(on_path, is_match, length, dist, sym_lit, hdr_vals, hdr_bits,
             lit_codes, lit_bits, dist_codes, dist_bits, eob_vals, eob_bits,
             out_words, n_splits=0, split_stride=2048, split_bits=0):
        # merged slots: (lit/len code | length extra) <= 15+5 bits and
        # (dist code | dist extra) <= 15+13 bits — two writes per command.
        # The per-segment canonical tables are packed (code<<4 | len)
        # elementwise over their tiny [B, 286]/[B, 30] extent first, so
        # each slot costs ONE gathered element, not two.
        lit_cb = (lit_codes.astype(jnp.int32) << 4) | lit_bits
        dist_cb = (dist_codes.astype(jnp.int32) << 4) | dist_bits
        # code indices, extra-bit counts and extra-bit values are
        # all elementwise arithmetic (ops/codes.py): the only
        # gathers left are the per-segment tables themselves
        lcode, lex, lval = codes_ops.length_code_parts(length)
        sym = jnp.where(is_match, 257 + lcode, sym_lit.astype(jnp.int32))
        dsym, dex, dval = codes_ops.dist_code_parts(dist)
        cb0 = jnp.take_along_axis(lit_cb, sym, axis=1)
        v0 = (cb0 >> 4).astype(jnp.uint32)
        n0 = jnp.where(on_path, cb0 & 15, 0)
        v1 = lval.astype(jnp.uint32)
        n1 = jnp.where(is_match, lex, 0)
        v01 = v0 | (v1 << n0.astype(jnp.uint32))
        n01 = n0 + n1
        cb2 = jnp.take_along_axis(dist_cb, dsym, axis=1)
        v2 = (cb2 >> 4).astype(jnp.uint32)
        n2 = jnp.where(is_match, cb2 & 15, 0)
        v3 = dval.astype(jnp.uint32)
        n3 = jnp.where(is_match, dex, 0)
        v23 = v2 | (v3 << n2.astype(jnp.uint32))
        n23 = n2 + n3

        # plane-separated pack: the two slot planes never interleave
        # (the [B,T,2]->[B,2T] merge is a strided relayout XLA pays
        # for), and the split-point writer below reuses the returned
        # per-position offsets instead of recomputing the cumsum
        words, totals, boff, posbits = bitpack_ops.pack_slot_planes(
            v01, n01, v23, n23, hdr_vals.astype(jnp.uint32), hdr_bits,
            eob_vals.astype(jnp.uint32), eob_bits, out_words)
        packed = (words, totals)
        if n_splits <= 1:
            return packed
        # split points for the member-chunk-parallel decoder: for each
        # of n_splits-1 interior boundaries, the first command starting
        # at or after j*(seg/n_splits) output bytes — its bit offset in
        # the packed body, its command index, and its output offset.
        # bit 0 marks "no split" (real offsets are >= 3 header bits).
        on_i = on_path.astype(jnp.int32)
        adv = jnp.where(on_path, jnp.where(is_match, length, 1), 0)
        opos = jnp.cumsum(adv, axis=1) - adv
        cmdi = jnp.cumsum(on_i, axis=1) - on_i
        # boff/posbits come straight from the pack (same cumsum)
        # fixed-STRIDE command splits (not output-byte quantiles): the
        # lockstep decoder's step count is the MAX command count over
        # rows, so bounding every row at `split_stride` commands keeps
        # lanes balanced across members of any density AND makes the
        # decoder's shape (max_cmds = stride) a compile-time constant.
        # Members with fewer commands simply emit fewer valid triples
        # (bit offset 0 = unused slot).  Exactly ONE on-path position
        # has cmdi == j*stride (cmdi is the exclusive command count),
        # so all n_splits-1 boundaries resolve with three scatters
        # instead of a per-boundary reduction loop.
        nslots = n_splits - 1
        # boundary resolution by BINARY SEARCH instead of scatter-max:
        # boff (and cmdi) are monotone over positions, so the command
        # owning boundary j is `searchsorted(key, q_j, 'right') - 1` —
        # nslots*log2(T) gathered elements per segment instead of three
        # full-T scatter passes.
        if split_bits:
            # fixed-BIT-stride splits (the compact TB index): boundary j goes to the command whose bit span
            # CONTAINS j*split_bits (commands are <= 48 bits, so each
            # command contains at most one boundary); spans between
            # split points are bounded by split_bits + 48, which bounds
            # the decoder's per-lane word slabs and its lane drift.
            # The last position with boff <= j*split_bits is that
            # command: command spans tile the body bit range, and the
            # non-emitting positions trailing a command share the NEXT
            # command's start offset.
            qs = jnp.arange(1, nslots + 1, dtype=jnp.int32) * split_bits
            key = boff
        else:
            # fixed-STRIDE command splits: boundary j is the command
            # with (exclusive) command index j*split_stride — the last
            # position with cmdi <= j*split_stride (the positions after
            # it carry cmdi + 1).
            qs = jnp.arange(1, nslots + 1, dtype=jnp.int32) * split_stride
            key = cmdi

        def srch(key_row):
            return jnp.searchsorted(key_row, qs, side="right") - 1

        idx = jax.vmap(srch)(key)              # [B, nslots], may be -1
        safe = jnp.maximum(idx, 0)

        def take(a):
            return jnp.take_along_axis(a, safe, axis=1)

        if split_bits:
            # valid iff the found command really contains the boundary
            sel = ((idx >= 0) & take(on_path) & (take(cmdi) > 0)
                   & (take(boff) <= qs[None, :])
                   & (take(boff) + take(posbits) > qs[None, :]))
        else:
            sel = ((idx >= 0) & take(on_path) & (take(cmdi) > 0)
                   & (take(cmdi) == qs[None, :]))

        def pick(a):
            return jnp.where(sel, take(a), 0)

        # total command count per member (EOB included): lets the index
        # writer derive the final row's density for the compact TB
        # subfield (sharded._build_index)
        ncmds = jnp.sum(on_i, axis=1) + 1
        splits = (pick(boff), pick(cmdi), pick(opos), ncmds)
        return packed, splits

    _PACK_JIT = pack
    return pack


def _pack_segments(res, sym_lit, hdr_vals, hdr_bits, lit_codes, lit_bits,
                   dist_codes, dist_bits, eob_vals, eob_bits, out_words,
                   n_splits: int = 0, split_stride: int = 2048,
                   split_bits: int = 0):
    pack = _get_pack_jit()
    return pack(
        res["on_path"], res["is_match"], res["length"], res["dist"], sym_lit,
        hdr_vals, hdr_bits, lit_codes, lit_bits, dist_codes, dist_bits,
        eob_vals, eob_bits, out_words=out_words, n_splits=n_splits,
        split_stride=split_stride, split_bits=split_bits,
    )


def reconstruct(cmds: list[int]) -> bytes:
    """Apply a command list (the fuzz `reconstruct` oracle,
    fuzz.ml:234–265): literals append, copies re-read earlier output."""
    out = bytearray()
    for c in cmds:
        kind, arg = cmd_unpack(c)
        if kind == "literal":
            out.append(arg)
        elif kind == "copy":
            off, ln = arg
            if off > len(out):
                raise MalformedError("invalid distance")
            src = len(out) - off
            for k in range(ln):
                out.append(out[src + k])
        else:
            break
    return bytes(out)


def encode_blocks(blocks: list, *, final: bool = True) -> bytes:
    """Encode a sequence of (cmds, kind) pairs as chained DEFLATE blocks
    (kind: 'fixed' | 'dynamic' | None for cost choice) — exercises
    block transitions like the reference matrix tests (test.ml:911–1135)."""
    w = bitstream.BitWriter()
    for bi, (cmds, kind) in enumerate(blocks):
        last = final and bi == len(blocks) - 1
        _encode_one_block(w, cmds, kind, last)
    return w.getvalue()


def encode_commands(cmds: list[int], *, block: str | None = None,
                    final: bool = True) -> bytes:
    """Entropy-encode a command list as one DEFLATE block (host path).

    The queue-driven `De.Def` role (de.mli:300–445): any producer that
    writes Queue commands can be encoded, independent of the match
    finder.  ``block`` forces 'fixed' or 'dynamic' (default: exact cost
    choice, de.ml:2415–2449).
    """
    w = bitstream.BitWriter()
    _encode_one_block(w, cmds, block, final)
    return w.getvalue()


def _encode_one_block(w: bitstream.BitWriter, cmds: list[int],
                      block: str | None, final: bool) -> None:
    cmds = [c for c in cmds if c != CMD_EOB]
    hist_lit = np.zeros(NUM_LIT_SYMS, dtype=np.int64)
    hist_dist = np.zeros(NUM_DIST_SYMS, dtype=np.int64)
    hist_lit[EOB] = 1
    lits, lens_, dists = [], [], []
    for c in cmds:
        kind, arg = cmd_unpack(c)
        if kind == "literal":
            hist_lit[arg] += 1
            lits.append(arg)
            lens_.append(0)
            dists.append(0)
        else:
            off, ln = arg
            sym = 257 + int(tables.length_to_code(np.array([ln]))[0])
            hist_lit[sym] += 1
            hist_dist[int(tables.dist_to_code(np.array([off]))[0])] += 1
            lits.append(-1)
            lens_.append(ln)
            dists.append(off)

    dyn_lit = huffman.code_lengths_from_frequencies(hist_lit)
    dyn_dist = huffman.code_lengths_from_frequencies(hist_dist)
    header = build_dynamic_header(dyn_lit, dyn_dist)
    cost_dyn = header.bit_length + symbol_cost_bits(hist_lit, hist_dist, dyn_lit, dyn_dist)
    cost_fix = symbol_cost_bits(hist_lit, hist_dist, _FIXED_LIT_BITS, _FIXED_DIST_BITS)
    kind = block or ("fixed" if cost_fix <= cost_dyn else "dynamic")

    w.write(1 if final else 0, 1)
    if kind == "fixed":
        w.write(1, 2)
        ll, dl = tables.FIXED_LIT_LENGTHS, tables.FIXED_DIST_LENGTHS
    else:
        w.write(2, 2)
        ll, dl = dyn_lit, dyn_dist
        packed, total = bitstream.pack_bits(header.values, header.nbits)
        w.write_packed(packed, total)
    lc = huffman.canonical_codes(ll)
    dc = huffman.canonical_codes(dl)
    for i, c in enumerate(cmds):
        if lits[i] >= 0:
            w.write(int(lc[lits[i]]), int(ll[lits[i]]))
        else:
            ln, off = lens_[i], dists[i]
            lcode = int(tables.length_to_code(np.array([ln]))[0])
            sym = 257 + lcode
            w.write(int(lc[sym]), int(ll[sym]))
            w.write(ln - int(LENGTH_BASE[lcode]), int(LENGTH_EXTRA[lcode]))
            dcode = int(tables.dist_to_code(np.array([off]))[0])
            w.write(int(dc[dcode]), int(dl[dcode]))
            w.write(off - int(DIST_BASE[dcode]), int(DIST_EXTRA[dcode]))
    w.write(int(lc[EOB]), int(ll[EOB]))


def _analyze_one(chunk: bytes, hist: bytes, level: int, seg: int):
    """Device analysis of a single chunk with explicit history; returns
    (res dict sliced to row 0 host arrays, n)."""
    import jax.numpy as jnp

    from .ops import lz77 as lz77_ops

    n = len(chunk)
    if n > seg:
        raise ValueError("chunk larger than segment")
    b_pad = MAX_DEVICE_BATCH
    data = np.zeros((b_pad, lz77_ops.HIST + seg), dtype=np.uint8)
    hl = min(len(hist), lz77_ops.HIST)
    if hl:
        data[0, lz77_ops.HIST - hl : lz77_ops.HIST] = np.frombuffer(hist[-hl:], np.uint8)
    data[0, lz77_ops.HIST : lz77_ops.HIST + n] = np.frombuffer(chunk, np.uint8)
    n_valid = np.zeros(b_pad, np.int32)
    n_valid[0] = n
    hist_len = np.zeros(b_pad, np.int32)
    hist_len[0] = hl
    res = lz77_ops.analyze2(
        jnp.asarray(data), jnp.asarray(n_valid), jnp.asarray(hist_len),
        level=level, seg_len=seg,
    )
    return res, data, n_valid, hist_len


def match_commands(chunk: bytes, hist: bytes = b"", level: int = 6,
                   seg: int | None = None) -> np.ndarray:
    """Match-find one chunk (with history) into packed commands
    (Queue int packing; no EOB appended)."""
    return match_commands_batch([chunk], [hist], level, seg)[0]


def match_commands_batch(chunks: list[bytes], hists: list[bytes],
                         level: int = 6, seg: int | None = None) -> list[np.ndarray]:
    """Match-find up to MAX_DEVICE_BATCH chunks in ONE device call
    (the batch rows are free — the kernel is always compiled at the
    padded batch).  Amortizes the per-dispatch round-trip for the
    streaming Lz77 path."""
    import jax.numpy as jnp

    from .ops import lz77 as lz77_ops

    b = len(chunks)
    if b > MAX_DEVICE_BATCH:
        raise ValueError("too many chunks for one device call")
    if seg is None:
        seg = 16384
        while seg < max(len(c) for c in chunks):
            seg *= 2
    data = np.zeros((MAX_DEVICE_BATCH, lz77_ops.HIST + seg), dtype=np.uint8)
    n_valid = np.zeros(MAX_DEVICE_BATCH, np.int32)
    hist_len = np.zeros(MAX_DEVICE_BATCH, np.int32)
    for i, (c, h) in enumerate(zip(chunks, hists)):
        if len(c) > seg:
            raise ValueError("chunk larger than segment")
        hl = min(len(h), lz77_ops.HIST)
        if hl:
            data[i, lz77_ops.HIST - hl : lz77_ops.HIST] = np.frombuffer(
                h[-hl:], np.uint8)
        data[i, lz77_ops.HIST : lz77_ops.HIST + len(c)] = np.frombuffer(c, np.uint8)
        n_valid[i] = len(c)
        hist_len[i] = hl
    res = lz77_ops.analyze2(
        jnp.asarray(data), jnp.asarray(n_valid), jnp.asarray(hist_len),
        level=level, seg_len=seg,
    )
    on_path = np.asarray(res["on_path"])
    is_match = np.asarray(res["is_match"])
    length = np.asarray(res["length"])
    dist = np.asarray(res["dist"])
    out = []
    for i, c in enumerate(chunks):
        n = len(c)
        pos = np.flatnonzero(on_path[i, :n])
        im = is_match[i, pos].astype(bool)
        ln64 = length[i, pos].astype(np.int64)
        d64 = dist[i, pos].astype(np.int64)
        lits = np.frombuffer(c, np.uint8).astype(np.int64)[pos]
        cmds = np.where(
            im, ((ln64 - MIN_MATCH) << 16) | (d64 - 1) | _CMD_COPY_FLAG, lits)
        out.append(cmds)
    return out


def deflate_segment_into(w: bitstream.BitWriter, chunk: bytes, hist: bytes,
                         level: int, seg: int, final: bool) -> None:
    """Encode one segment (with history) appending to an open writer —
    the streaming Deflate backend."""
    res, data, n_valid, _ = _analyze_one(chunk, hist, level, seg)
    from .ops import lz77 as lz77_ops

    hist_lit = np.asarray(res["hist_lit"])[:1]
    hist_dist = np.asarray(res["hist_dist"])[:1]
    (hdr_vals, hdr_bits), tabs, kinds = plan_blocks(
        hist_lit, hist_dist, n_valid[:1], np.array([final]), pad_to=MAX_DEVICE_BATCH
    )
    if kinds[0] == "stored":
        _emit_stored(w, np.frombuffer(chunk, np.uint8), final=final)
        return
    import jax.numpy as jnp

    out_words = (9 * seg) // 32 + 2 * _HDR_PAD
    words, totals = _pack_segments(
        res, jnp.asarray(data[:, lz77_ops.HIST :].astype(np.int32)),
        jnp.asarray(hdr_vals), jnp.asarray(hdr_bits),
        *tabs, out_words,
    )
    w.write_packed(
        np.frombuffer(np.asarray(words)[0].astype("<u4").tobytes(), np.uint8),
        int(np.asarray(totals)[0]),
    )


# ---------------------------------------------------------------------------
# Host reference inflate (De.Inf.Ns parity, de.ml:1534–1823).
# ---------------------------------------------------------------------------


class MalformedError(ValueError):
    """Typed data error; messages mirror the reference's `err_*`
    constructors (de.ml:702–730)."""


def _build_tables_from_header(r: bitstream.BitReader):
    lit_lens, dist_lens = _parse_dynamic_lengths(r)
    try:
        lit_dt = huffman.build_decode_table(lit_lens, huffman.ROOT_BITS_LENS)
        dist_dt = huffman.build_decode_table(
            dist_lens, huffman.ROOT_BITS_DISTS, allow_incomplete=True
        )
    except huffman.InvalidTree as e:
        raise MalformedError("invalid dictionary") from e
    return lit_dt, dist_dt


def _parse_dynamic_lengths(r: bitstream.BitReader):
    """Parse a dynamic block header up to the code lengths; returns
    (lit_lengths, dist_lengths) with the reader positioned at the
    symbol section."""
    hlit = r.read(5) + 257
    hdist = r.read(5) + 1
    hclen = r.read(4) + 4
    if hlit > 286 or hdist > 30:
        raise MalformedError("invalid dictionary")
    pre = np.zeros(19, dtype=np.int32)
    for k in range(hclen):
        pre[int(PRECODE_ORDER[k])] = r.read(3)
    try:
        pre_dt = huffman.build_decode_table(pre, huffman.ROOT_BITS_CODES)
    except huffman.InvalidTree as e:
        raise MalformedError("invalid dictionary") from e
    lengths = np.zeros(hlit + hdist, dtype=np.int32)
    i = 0
    while i < hlit + hdist:
        sym, nb = huffman.decode_one(pre_dt, r.peek(15))
        if sym < 0:
            raise MalformedError("invalid dictionary")
        r.consume(nb)
        if sym < 16:
            lengths[i] = sym
            i += 1
        elif sym == 16:
            if i == 0:
                raise MalformedError("invalid dictionary")
            rep = 3 + r.read(2)
            lengths[i : i + rep] = lengths[i - 1]
            i += rep
        elif sym == 17:
            i += 3 + r.read(3)
        else:
            i += 11 + r.read(7)
    if i > hlit + hdist:
        raise MalformedError("invalid dictionary")
    if lengths[256] == 0:
        raise MalformedError("invalid dictionary")
    return lengths[:hlit], lengths[hlit:]


_FIXED_LIT_DT = None
_FIXED_DIST_DT = None
_FIXED_CODES = None


def _fixed_codes_cached():
    """Canonical (bit-reversed, emit-ready) fixed-tree codes."""
    global _FIXED_CODES
    if _FIXED_CODES is None:
        _FIXED_CODES = (
            huffman.canonical_codes(tables.FIXED_LIT_LENGTHS),
            huffman.canonical_codes(tables.FIXED_DIST_LENGTHS[:30]),
        )
    return _FIXED_CODES


def _fixed_tables():
    global _FIXED_LIT_DT, _FIXED_DIST_DT
    if _FIXED_LIT_DT is None:
        _FIXED_LIT_DT = huffman.build_decode_table(tables.FIXED_LIT_LENGTHS, huffman.ROOT_BITS_LENS)
        _FIXED_DIST_DT = huffman.build_decode_table(tables.FIXED_DIST_LENGTHS, huffman.ROOT_BITS_DISTS)
    return _FIXED_LIT_DT, _FIXED_DIST_DT


def inflate(data, *, window: np.ndarray | None = None,
            window_bits: int = 15) -> bytes:
    """One-shot raw-DEFLATE decode (host reference path).

    ``window`` optionally seeds the 32 KiB back-reference history
    (preset-dictionary support, cf. `unsafe_set_cursor` de.ml:1826).
    ``window_bits`` (8..15) restricts back-reference distances to the
    negotiated window, like the reference's CINFO-sized `allocate
    (cinfo+8)` window (zl.ml:247-280): a stream that references past it
    fails with "invalid distance".  Raises :class:`MalformedError` on
    invalid input.
    """
    out, _ = inflate_ex(data, window=window, window_bits=window_bits)
    return out


def inflate_ex(data, *, window: np.ndarray | None = None,
               window_bits: int = 15):
    """Like :func:`inflate` but also returns bytes consumed.

    Uses the native resumable state machine (native/tpuz.cpp) when
    available — the byte-serial fast path — with the pure-Python
    table-driven decoder as reference fallback.
    """
    try:
        from . import native

        if native.available():
            return _inflate_native(_np_u8(data), window, window_bits)
    except ImportError:  # pragma: no cover
        pass
    return _inflate_python(data, window=window, window_bits=window_bits)


def _inflate_ex_arr(data, *, window: np.ndarray | None = None,
                    window_bits: int = 15) -> tuple[np.ndarray, int]:
    """Like :func:`inflate_ex` but returns the payload as a numpy uint8
    array (zero-copy from the native decoder) so framing layers can
    checksum and assemble without materializing intermediate bytes."""
    try:
        from . import native

        if native.available():
            return _inflate_native_arr(_np_u8(data), window, window_bits)
    except ImportError:  # pragma: no cover
        pass
    out, consumed = _inflate_python(data, window=window, window_bits=window_bits)
    return np.frombuffer(out, dtype=np.uint8), consumed


def inflate_into(data, dst: np.ndarray, *, window: np.ndarray | None = None,
                 window_bits: int = 15) -> tuple[int, int]:
    """One-shot inflate into a caller-owned buffer.

    Signature parity with the reference `Inf.Ns.inflate : bigstring ->
    bigstring -> (int * int, error) result` (de.ml:1807–1822): returns
    (bytes_consumed, bytes_produced); raises :class:`MalformedError`,
    including when ``dst`` is too small (the Ns output-exhaustion
    error, test_ns.ml:215–253).
    """
    out, consumed = inflate_ex(data, window=window, window_bits=window_bits)
    if len(out) > dst.size:
        raise MalformedError("unexpected end of output")
    dst[: len(out)] = np.frombuffer(out, np.uint8)
    return consumed, len(out)


def _inflate_native(buf: np.ndarray, window, window_bits: int = 15) -> tuple[bytes, int]:
    out, consumed = _inflate_native_arr(buf, window, window_bits)
    return out.tobytes(), consumed


def _inflate_native_arr(buf: np.ndarray, window,
                        window_bits: int = 15) -> tuple[np.ndarray, int]:
    """Native one-shot inflate returning a numpy uint8 view (no copy);
    framing layers checksum/concatenate the array and materialize
    bytes once at the API boundary."""
    from . import native

    inf = native.InflateStream()
    if window_bits != 15:
        inf.set_window_bits(window_bits)
    if window is not None:
        inf.set_dictionary(bytes(window))
    if not buf.flags["C_CONTIGUOUS"]:
        buf = np.ascontiguousarray(buf)
    pos = 0
    # uninitialized output buffer, grown geometrically on FLUSH
    out = np.empty(max(4 * buf.size, 1 << 16), dtype=np.uint8)
    out_pos = 0
    while True:
        status, consumed, produced = inf.run_into(buf[pos:], out, out_pos)
        pos += consumed
        out_pos += produced
        if status == native.InflateStream.END:
            return out[:out_pos], pos - len(inf.takeback())
        if status == native.InflateStream.MALFORMED:
            raise MalformedError(inf.error)
        if status == native.InflateStream.AWAIT and pos >= buf.size:
            raise MalformedError("unexpected end of input")
        if status == native.InflateStream.FLUSH:
            bigger = np.empty(out.size * 2, dtype=np.uint8)
            bigger[:out_pos] = out[:out_pos]
            out = bigger
        # AWAIT with more input: loop


def _inflate_python(data, *, window: np.ndarray | None = None,
                    window_bits: int = 15):
    win_limit = 1 << window_bits
    r = bitstream.BitReader(_np_u8(data))
    out = bytearray()
    if window is not None:
        out.extend(bytes(window))
    prefix = len(out)
    try:
        while True:
            bfinal = r.read(1)
            btype = r.read(2)
            if btype == 3:
                raise MalformedError("invalid kind of block")
            if btype == 0:
                r.align_to_byte()
                ln = int.from_bytes(r.read_bytes(2).tobytes(), "little")
                nlen = int.from_bytes(r.read_bytes(2).tobytes(), "little")
                if ln != (nlen ^ 0xFFFF):
                    raise MalformedError("invalid complement of length")
                out.extend(r.read_bytes(ln).tobytes())
            else:
                if btype == 1:
                    lit_dt, dist_dt = _fixed_tables()
                else:
                    lit_dt, dist_dt = _build_tables_from_header(r)
                while True:
                    sym, nb = huffman.decode_one(lit_dt, r.peek(15))
                    if sym < 0:
                        raise MalformedError("invalid literal/length")
                    r.consume(nb)
                    if sym == EOB:
                        break
                    if sym < 256:
                        out.append(sym)
                        continue
                    if sym > 285:
                        raise MalformedError("invalid literal/length")
                    lcode = sym - 257
                    length = int(LENGTH_BASE[lcode]) + r.read(int(LENGTH_EXTRA[lcode]))
                    dsym, dnb = huffman.decode_one(dist_dt, r.peek(15))
                    if dsym < 0 or dsym > 29:
                        raise MalformedError("invalid distance code")
                    r.consume(dnb)
                    dist = int(DIST_BASE[dsym]) + r.read(int(DIST_EXTRA[dsym]))
                    if dist > len(out) or dist > win_limit:
                        raise MalformedError("invalid distance")
                    # copy with overlap semantics; doubling keeps this O(log)
                    src = len(out) - dist
                    if dist >= length:
                        out += out[src : src + length]
                    else:
                        chunk = bytes(out[src:])
                        while len(chunk) < length:
                            chunk = chunk + chunk
                        out += chunk[:length]
            if bfinal:
                break
    except EOFError as e:
        raise MalformedError("unexpected end of input") from e
    return bytes(out[prefix:]), r.byte_position()
