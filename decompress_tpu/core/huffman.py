"""Canonical Huffman machinery (host side, numpy).

Three jobs, mirroring the reference's `De.T` (tree build from frequencies,
de.ml:1828–2192), `generate_codes`/`reverse_code` (canonical code assignment,
de.ml:1910–1950) and `De.Inf.huffman` + `De.Lookup` (two-level decode-table
construction, de.ml:349–371, 523–638) — re-derived from first principles
(RFC 1951 + the classic zlib table layout), implemented with vectorized
numpy where it matters.

Tree *construction* is a per-block, ~300-symbol problem: it runs on the
host (it is far below device-dispatch granularity); the resulting code/
length/decode-table arrays are what the device kernels consume.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np

from .tables import MAX_BITS, reverse_bits

# ---------------------------------------------------------------------------
# Code-length computation from frequencies (length-limited Huffman).
# ---------------------------------------------------------------------------


def code_lengths_from_frequencies(
    freqs: np.ndarray, max_length: int = MAX_BITS
) -> np.ndarray:
    """Compute depth-limited Huffman code lengths for ``freqs``.

    Classic Huffman tree build (heap) followed by overflow redistribution
    when any code exceeds ``max_length`` — the same semantics as the
    reference's `T.make`/`generate_lengths` (de.ml:1952–2009, itself a
    zlib trees.c port).  Also enforces the pkzip "at least 2 codes" rule
    (reference de.ml:1863–1874): if fewer than two symbols occur, pad so
    the result is always a complete, decodable tree.

    Returns an int32 array of per-symbol code lengths (0 = symbol unused).
    """
    freqs = np.asarray(freqs, dtype=np.int64)
    n = freqs.shape[0]
    used = np.flatnonzero(freqs > 0)

    lengths = np.zeros(n, dtype=np.int32)
    if used.size == 0:
        # No symbols at all: still emit two 1-bit codes so downstream
        # header serialization has a valid (trivial) tree.
        lengths[0] = 1
        lengths[min(1, n - 1)] = 1
        return lengths
    if used.size == 1:
        s = int(used[0])
        lengths[s] = 1
        lengths[0 if s != 0 else 1] = 1
        return lengths

    # Heap items: (freq, tiebreak, id). Internal nodes get ids >= n.
    # parent[] lets us recover each leaf's depth after the build.
    parent = np.full(2 * used.size, -1, dtype=np.int64)
    leaf_of = {}
    heap = []
    for rank, s in enumerate(used):
        leaf_of[rank] = int(s)
        heapq.heappush(heap, (int(freqs[s]), int(s), rank))
    next_id = used.size
    while len(heap) > 1:
        f1, _, i1 = heapq.heappop(heap)
        f2, t2, i2 = heapq.heappop(heap)
        parent[i1] = next_id
        parent[i2] = next_id
        heapq.heappush(heap, (f1 + f2, n + next_id, next_id))
        next_id += 1
    root = heap[0][2]

    # Depth of every node by walking parents, with depths clamped at
    # max_length as we descend (children of a clamped parent measure their
    # excess against the clamped depth).  `overflow` counts every node —
    # internal or leaf — pushed past max_length; with clamped parents each
    # node overshoots by exactly one level, which is the invariant the
    # redistribution loop below relies on to restore the Kraft sum.
    depth = np.zeros(next_id, dtype=np.int32)
    overflow = 0
    for node in range(next_id - 2, -1, -1):
        if parent[node] >= 0:
            d = depth[parent[node]] + 1
            if d > max_length:
                d = max_length
                overflow += 1
            depth[node] = d
    for rank, s in leaf_of.items():
        lengths[s] = depth[rank]

    # Overflow redistribution (zlib gen_bitlen semantics): clamp to
    # max_length while keeping the Kraft sum exactly 1.
    if overflow > 0:
        bl_count = np.bincount(lengths[lengths > 0], minlength=max_length + 2)
        # Move pairs: find the deepest non-full level and split one of its
        # codes into two one level down, retiring one max-length code.
        while overflow > 0:
            bits = max_length - 1
            while bl_count[bits] == 0:
                bits -= 1
            bl_count[bits] -= 1
            bl_count[bits + 1] += 2
            bl_count[max_length] -= 1
            overflow -= 2
        # Reassign lengths to symbols: longest lengths go to least-frequent
        # symbols (stable order for determinism).
        order = used[np.lexsort((used, freqs[used]))]  # by (freq, symbol) asc
        new_lengths = np.zeros(n, dtype=np.int32)
        li = max_length
        for s in order:
            while bl_count[li] == 0:
                li -= 1
            new_lengths[s] = li
            bl_count[li] -= 1
        lengths = new_lengths

    return lengths


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Assign canonical Huffman codes for the given lengths (vectorized).

    Returns LSB-first (bit-reversed) codes ready for DEFLATE emission,
    as uint32.  Equivalent to the reference's `generate_codes` +
    `reverse_code` (de.ml:1910–1950) in three vector ops.
    """
    lengths = np.asarray(lengths, dtype=np.int32)
    bl_count = np.bincount(lengths, minlength=MAX_BITS + 1)
    bl_count[0] = 0
    next_code = np.zeros(MAX_BITS + 2, dtype=np.int64)
    code = 0
    for bits in range(1, MAX_BITS + 1):
        code = (code + bl_count[bits - 1]) << 1
        next_code[bits] = code
    # canonical (MSB-first) code of each symbol: next_code[len] + rank among
    # same-length symbols in symbol order
    order = np.argsort(lengths, kind="stable")
    sorted_lengths = lengths[order]
    # rank within each length group
    ranks = np.arange(lengths.size) - np.searchsorted(sorted_lengths, sorted_lengths)
    codes = np.zeros(lengths.size, dtype=np.int64)
    codes[order] = next_code[sorted_lengths] + ranks
    return reverse_bits(codes.astype(np.uint32), lengths)


def kraft_slack(lengths: np.ndarray, max_length: int = MAX_BITS) -> int:
    """Kraft-sum slack: 0 for a complete tree, >0 incomplete, <0 invalid."""
    lengths = np.asarray(lengths)
    used = lengths[lengths > 0]
    if used.size == 0:
        return 1 << max_length
    return (1 << max_length) - int(np.sum(1 << (max_length - used.astype(np.int64))))


# ---------------------------------------------------------------------------
# Two-level decode table (zlib inftrees.c layout; reference de.ml:349–371,
# 523–638).
# ---------------------------------------------------------------------------

#: Entry packing (int32):  flags << 28 | nbits << 16 | value
#: flags 0 = symbol (value = symbol id, nbits = total code length)
#: flags 1 = link   (value = subtable offset, nbits = subtable index bits)
#: flags 2 = invalid
F_SYMBOL = 0
F_LINK = 1
F_INVALID = 2


def pack_entry(flags: int, nbits: int, value: int) -> int:
    return (flags << 28) | (nbits << 16) | value


ENTRY_INVALID = pack_entry(F_INVALID, 0, 0)

#: Root-table index widths matching the reference (de.ml:523–638):
#: 9 for the literal/length tree, 6 for distances, 7 for the precode.
ROOT_BITS_LENS = 9
ROOT_BITS_DISTS = 6
ROOT_BITS_CODES = 7


@dataclass
class DecodeTable:
    """Two-level Huffman decode table.

    ``table[:1 << root_bits]`` is the root; subtables follow.  To decode:
    peek ``root_bits`` bits ``b`` (LSB-first); ``e = table[b]``; if ``e``
    is a link, index the subtable with the next ``nbits(e)`` bits.
    """

    table: np.ndarray  # int32
    root_bits: int
    max_length: int  # longest code in the tree


class InvalidTree(ValueError):
    pass


def build_decode_table(
    lengths: np.ndarray, root_bits: int, *, allow_incomplete: bool = False
) -> DecodeTable:
    """Build the two-level decode table for canonical codes of ``lengths``.

    Raises :class:`InvalidTree` on an over-subscribed code set, or on an
    incomplete one unless ``allow_incomplete`` (DEFLATE permits incomplete
    distance trees with a single code — reference `empty_table` handling,
    de.ml:521, 601–612).
    """
    lengths = np.asarray(lengths, dtype=np.int32)
    nsyms = int(np.sum(lengths > 0))
    slack = kraft_slack(lengths)
    if slack < 0:
        raise InvalidTree("over-subscribed code set")
    if slack > 0 and not (allow_incomplete and nsyms <= 1):
        raise InvalidTree("incomplete code set")
    if nsyms == 0:
        table = np.full(1 << root_bits, ENTRY_INVALID, dtype=np.int32)
        return DecodeTable(table, root_bits, 0)

    max_len = int(lengths.max())
    root_bits_eff = min(root_bits, max(max_len, 1))
    codes = canonical_codes(lengths)  # already bit-reversed (LSB-first)

    syms = np.flatnonzero(lengths > 0)
    lens = lengths[syms]
    revs = codes[syms].astype(np.int64)

    root_size = 1 << root_bits_eff
    chunks = [np.full(root_size, ENTRY_INVALID, dtype=np.int32)]
    total = root_size

    # Short codes: replicate across all root entries sharing the code's
    # low bits (vectorized per symbol group).
    short = lens <= root_bits_eff
    for s, l, r in zip(syms[short], lens[short], revs[short]):
        step = 1 << l
        idx = np.arange(r, root_size, step)
        chunks[0][idx] = pack_entry(F_SYMBOL, int(l), int(s))

    # Long codes: group by root prefix (low root_bits of the reversed code).
    long_syms = syms[~short]
    if long_syms.size:
        long_lens = lens[~short]
        long_revs = revs[~short]
        prefixes = long_revs & (root_size - 1)
        for p in np.unique(prefixes):
            m = prefixes == p
            sub_bits = int(long_lens[m].max()) - root_bits_eff
            sub_size = 1 << sub_bits
            sub = np.full(sub_size, ENTRY_INVALID, dtype=np.int32)
            for s, l, r in zip(long_syms[m], long_lens[m], long_revs[m]):
                rem_len = int(l) - root_bits_eff
                rem_code = int(r) >> root_bits_eff
                step = 1 << rem_len
                idx = np.arange(rem_code, sub_size, step)
                sub[idx] = pack_entry(F_SYMBOL, int(l), int(s))
            chunks[0][p] = pack_entry(F_LINK, sub_bits, total)
            chunks.append(sub)
            total += sub_size

    table = np.concatenate(chunks)
    if root_bits_eff < root_bits:
        # Pad the root so callers can always index with `root_bits` bits:
        # replicate the effective root across the full 1<<root_bits range.
        reps = 1 << (root_bits - root_bits_eff)
        root = np.tile(table[:root_size], reps)
        fixed = [root]
        if table.size > root_size:
            # subtable offsets moved by the padding delta
            delta = root.size - root_size
            tail = table[root_size:]
            fixed.append(tail)
            is_link = (root >> 28) == F_LINK
            root[is_link] += delta
        table = np.concatenate(fixed)
    return DecodeTable(table, root_bits, max_len)


def decode_one(dt: DecodeTable, peek15: int) -> tuple[int, int]:
    """Scalar reference decode: (symbol, code_length) from 15 peeked bits.

    Host-side oracle used by tests; device kernels implement the same two
    probes (reference `resolve`, de.ml:640–647).
    """
    e = int(dt.table[peek15 & ((1 << dt.root_bits) - 1)])
    flags, nbits, value = e >> 28, (e >> 16) & 0xFFF, e & 0xFFFF
    if flags == F_LINK:
        e = int(dt.table[value + ((peek15 >> dt.root_bits) & ((1 << nbits) - 1))])
        flags, nbits, value = e >> 28, (e >> 16) & 0xFFF, e & 0xFFFF
    if flags != F_SYMBOL:
        return -1, 0
    return value, nbits
