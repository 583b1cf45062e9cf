"""Sharded compression over a JAX device mesh.

Design (BASELINE north star; SURVEY §2 parallelism table):

* **Data-parallel members**: the input is split into independent
  members (gzip allows multi-member concatenation, RFC 1952 §2.2), one
  batch row per member, the batch axis sharded over the ``dp`` mesh
  axis.  No communication is needed during compression — the layout
  makes XLA partition the codec kernels trivially.
* **Order-preserving gather**: compressed members are assembled by
  member index, never by arrival order, so the archive is byte-identical
  for any mesh size (1 chip == N chips).
* **Checksum combine**: the zlib mode compresses one *single* stream
  whose Adler-32 is folded across shards with the associative
  ``adler32_combine`` (ops/checksum.py) — the reduction the reference
  computes serially in its window (de.ml:453–455).
* **Multi-host**: under `jax.distributed`, each host feeds its local
  members and the final archive assembly uses a process-level
  all-gather; combine order is fixed by shard index.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .. import de, gz, zl
from ..core import bitstream
from ..ops import checksum, lz77
from ..ops import inflate as inflate_ops
from ..utils import profiling


def make_mesh(n_devices: int | None = None, axis: str = "dp"):
    """1-D mesh over the default backend's first ``n_devices`` devices
    (all of them when None); raises when there are fewer."""
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(f"need {n_devices} {devs[0].platform} devices, "
                             f"have {len(devs)}")
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def _batched_members(arr: np.ndarray, member_size: int, hist: int):
    n = arr.size
    m = max(1, (n + member_size - 1) // member_size)
    data = np.zeros((m, hist + member_size), dtype=np.uint8)
    n_valid = np.zeros(m, dtype=np.int32)
    for i in range(m):
        lo = i * member_size
        hi = min(lo + member_size, n)
        n_valid[i] = hi - lo
        data[i, hist : hist + hi - lo] = arr[lo:hi]
    return data, n_valid


def _shard_batch(x, mesh):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    if mesh is None:
        return jax.numpy.asarray(x)
    spec = P("dp", *([None] * (x.ndim - 1)))
    # pad batch to a multiple of the mesh size
    d = mesh.devices.size
    pad = -x.shape[0] % d
    if pad:
        x = np.concatenate([x, np.zeros((pad, *x.shape[1:]), x.dtype)])
    return jax.device_put(x, NamedSharding(mesh, spec))


def _compress_members(arr, level, member_size, mesh, final_flags=None,
                      want_crc=True, shared_tree=False):
    """Device-parallel member compression.

    Returns (parts, n_valid, crcs) where parts[i] is either
    ("stored", payload_u8) or ("packed", packed_u8, total_bits,
    splits) — splits being (bit_off, cmd_idx, out_off) triples at the
    N_SPLITS-1 interior symbol-stream split points (bit_off 0 = none).
    Members are processed in fixed-shape chunks (a small set of
    compiled variants; each mesh device gets MAX_DEVICE_BATCH members
    per call).

    ``shared_tree`` runs the SURVEY §2 all-reduced-frequencies mode:
    analyze all chunks first, sum the per-member histograms (across
    cards a ~300-int all-reduce), build ONE dynamic tree,
    and pack every member with it — one host tree build total.  Output
    stays deterministic for any mesh size (the tree depends only on the
    global sums).
    """
    # members are independent (window reset at boundaries), so the
    # history prefix is pure padding: run the matcher hist-free, which
    # shrinks the sort/fingerprint/probe domain and the upload by the
    # 32 KiB-per-member prefix
    hist = 0
    data, n_valid = _batched_members(arr, member_size, hist)
    m = data.shape[0]
    if final_flags is None:
        final_flags = np.ones(m, bool)

    d = mesh.devices.size if mesh is not None else 1
    chunk = de.MAX_DEVICE_BATCH * d
    out_words = (9 * member_size) // 32 + 2 * de._HDR_PAD

    # Pipelined chunk schedule with a bounded look-ahead window: chunk
    # i's analyze dispatch goes out, then chunk i-1's packed words are
    # drained while the device crunches i, then i's pack is dispatched.
    # At most TWO chunks of device buffers are live at any moment, so
    # arbitrarily large inputs stream at O(1) device footprint while
    # the device queue never starves.  shared_tree needs the
    # global frequency sums before any pack, so it stages every
    # analyze first (its footprint is inherently O(m)).
    def _dispatch_analyze(lo):
        hi = min(lo + chunk, m)
        b = hi - lo
        b_pad = chunk if b == chunk else max(d, 1 << (b - 1).bit_length())
        cdata = np.zeros((b_pad, data.shape[1]), dtype=np.uint8)
        cdata[:b] = data[lo:hi]
        cnv = np.zeros(b_pad, np.int32)
        cnv[:b] = n_valid[lo:hi]
        chl = np.zeros(b_pad, np.int32)

        d_data = _shard_batch(cdata, mesh)
        d_nv = _shard_batch(cnv, mesh)
        d_hl = _shard_batch(chl, mesh)

        with profiling.annotate("lz77_analyze_dispatch"):
            res0 = lz77.analyze2_start(d_data, d_nv, d_hl, level=level,
                                       seg_len=member_size, hist=hist)
        return (lo, hi, b, b_pad, cdata, cnv, d_data, d_nv, d_hl, res0)

    def _finish_analyze(pend):
        (lo, hi, b, b_pad, cdata, cnv, d_data, d_nv, d_hl, res0) = pend
        res = lz77.analyze2_finish(res0, d_data, d_nv, d_hl, level=level,
                                   seg_len=member_size, hist=hist)
        hist_lit = np.asarray(res["hist_lit"])[:b]
        hist_dist = np.asarray(res["hist_dist"])[:b]
        return (lo, hi, b, b_pad, cdata, cnv, d_data, res,
                hist_lit, hist_dist)

    def _dispatch_pack(st, shared):
        (lo, hi, b, b_pad, cdata, cnv, d_data, res,
         hist_lit, hist_dist) = st
        hdr, tabs, kinds = de.plan_blocks(
            hist_lit, hist_dist, cnv[:b], final_flags[lo:hi], pad_to=b_pad,
            shared_tree=shared if shared_tree else False,
        )
        with profiling.annotate("bitpack"):
            pk = de._pack_segments(
                res, d_data[:, hist:],
                *[_shard_batch(t, mesh) for t in (hdr[0], hdr[1], *tabs)],
                out_words, n_splits=N_SPLITS, split_stride=SPLIT_STRIDE,
                split_bits=SPLIT_BITS,
            )
        return (lo, hi, b, cdata, cnv, d_data, kinds, pk)

    shared = None
    if shared_tree:
        from ..core import huffman

        staged = [_finish_analyze(_dispatch_analyze(lo))
                  for lo in range(0, m, chunk)]
        hl_sum = np.zeros(de.NUM_LIT_SYMS, np.int64)
        hd_sum = np.zeros(de.NUM_DIST_SYMS, np.int64)
        for st in staged:
            hl_sum[: st[8].shape[1]] += st[8].astype(np.int64).sum(axis=0)
            hd_sum[: st[9].shape[1]] += st[9].astype(np.int64).sum(axis=0)
        hl_sum[de.EOB] += m  # one EOB per member block
        s_lit = huffman.code_lengths_from_frequencies(hl_sum)
        s_dist = huffman.code_lengths_from_frequencies(hd_sum)
        shared = (s_lit, s_dist, de.build_dynamic_header(s_lit, s_dist))
        packed_iter = (_dispatch_pack(st, shared) for st in staged)
    else:
        def _windowed():
            in_pack = None
            for lo in range(0, m, chunk):
                pend = _dispatch_analyze(lo)
                if in_pack is not None:
                    yield in_pack  # drain i-1's pack while i analyzes
                in_pack = _dispatch_pack(_finish_analyze(pend), None)
            if in_pack is not None:
                yield in_pack

        packed_iter = _windowed()

    parts: list = []
    crcs_all: list = []
    for (lo, hi, b, cdata, cnv, d_data, kinds, pk) in packed_iter:
        (words, totals), (sp_bits, sp_cmds, sp_outs, sp_n) = pk
        totals = np.asarray(totals)[:b]
        sp_bits = np.asarray(sp_bits)[:b]
        sp_cmds = np.asarray(sp_cmds)[:b]
        sp_outs = np.asarray(sp_outs)[:b]
        sp_n = np.asarray(sp_n)[:b]
        used = [int(totals[i]) for i in range(b) if kinds[i] != "stored"]
        cap = (max(used) + 31) // 32 + 1 if used else 0
        words = np.asarray(words[:b, :cap]) if cap else np.zeros((b, 0), np.uint32)
        if want_crc:
            from .. import native

            if native.available():
                # the member bytes are host-resident; native CRC avoids
                # a device round-trip entirely
                crcs_all.extend(
                    native.crc32(cdata[i, hist : hist + int(cnv[i])].tobytes())
                    for i in range(b)
                )
            else:
                crcs_all.extend(
                    checksum.crc32_batch_device(d_data[:, hist:], cnv)[:b]
                )

        for i in range(b):
            if kinds[i] == "stored":
                parts.append(("stored", cdata[i, hist : hist + cnv[i]]))
            else:
                packed = np.frombuffer(words[i].astype("<u4").tobytes(), dtype=np.uint8)
                splits = [
                    (int(sp_bits[i, j]), int(sp_cmds[i, j]), int(sp_outs[i, j]))
                    for j in range(N_SPLITS - 1)
                ]
                parts.append(("packed", packed, int(totals[i]), splits,
                              int(sp_n[i])))
    return parts, n_valid, (np.array(crcs_all) if want_crc else None)


INDEX_ID = b"TZ"  # gzip FEXTRA subfield carrying member byte sizes
SPLIT_ID = b"TS"  # FEXTRA subfield: per-member symbol-stream split points
TBITS_ID = b"TB"  # compact bit-stride splits: u8 deltas off j*SPLIT_BITS


def _encode_tb(split_rows: list, ncmds: list, stride: int) -> bytes | None:
    """Compact TB payload, or None when any split point doesn't fit the
    delta encoding (e.g. command-stride archives)."""
    out = [int(stride).to_bytes(4, "little")]
    for row, total in zip(split_rows, ncmds):
        valid = [t for t in row if t[0] > 0]
        deltas = []
        maxc = 0
        prev_ci = 0
        for j, (bo, ci, _oo) in enumerate(valid, start=1):
            d = j * stride - bo
            if not 0 <= d <= 255:
                return None
            deltas.append(d)
            maxc = max(maxc, ci - prev_ci)
            prev_ci = ci
        if valid and total:
            maxc = max(maxc, int(total) - prev_ci)
        elif not valid:
            maxc = min(int(total), 65535) if total else 0
        out.append(len(deltas).to_bytes(2, "little")
                   + min(maxc, 65535).to_bytes(2, "little")
                   + bytes(deltas))
    return b"".join(out)


# Chunk rows per member for the chunk-parallel decoder: the decoders'
# parallelism is the row count, so members split into many short
# symbol-stream rows.  Command-stride splits (SPLIT_STRIDE) cap every
# row at that many commands, so rows stay balanced across members of
# any density.  N_SPLITS bounds the recorded triples.  TB-encoded
# splits cost one byte each, so the cap is generous: 250 * SPLIT_BITS
# covers even a ratio~1 dynamic-huffman member of SEGMENT_SIZE
# (2 Mbit), keeping every row's span bounded by SPLIT_BITS + 48 bits.
N_SPLITS = 250
SPLIT_STRIDE = 2048
# Bit-stride alternative (SPLIT_BITS > 0 overrides the command
# stride): split points go to the command containing each multiple of
# SPLIT_BITS in the packed body, so every row spans <= SPLIT_BITS + 48
# stream bits.  The triple FORMAT is unchanged; either reader decodes
# either geometry.  The bit stride is the PRODUCTION default (TB
# index, ~0.05% size overhead, 1 byte per split; the GPU decoder
# stops rows by bit); set to 0 for legacy command-stride (TS) archives.
SPLIT_BITS = 8192


def sharded_gzip_compress(
    data,
    level: int = 6,
    *,
    member_size: int = de.SEGMENT_SIZE,
    mesh=None,
    mtime: int = 0,
    os=gz.OS.default(),
    index: bool = True,
    return_meta: bool = False,
    shared_tree: bool = False,
    config=None,
) -> bytes:
    """Multi-member gzip archive, members compressed data-parallel.

    Byte-identical output for any mesh size; decodable by any gzip
    (including the reference `decompress -fgzip -d`).  With ``index``
    (default), the first member carries a standard FEXTRA subfield
    listing member byte sizes so :func:`sharded_gzip_decompress` can
    decode all members in parallel; foreign tools ignore it.
    """
    if config is not None:
        config.validate()
        level = config.level if level == 6 else level
        member_size = config.member_size or member_size
        index = index and config.write_index
        shared_tree = shared_tree or config.shared_tree
    arr = de._np_u8(data)
    if arr.size == 0:
        empty = gz.compress(b"", level)
        return (empty, [len(empty)], [[(0, 0, 0)] * (N_SPLITS - 1)], [0]) \
            if return_meta else empty
    parts, n_valid, crcs = _compress_members(arr, level, member_size, mesh,
                                             shared_tree=shared_tree)
    m = len(parts)

    head = b"\x1f\x8b\x08\x00" + (mtime & 0xFFFFFFFF).to_bytes(4, "little") \
        + bytes([gz._xfl(level), int(os)])
    bodies = []
    for part in parts:
        w = bitstream.BitWriter()
        if part[0] == "stored":
            de._emit_stored(w, part[1], final=True)
        else:
            w.write_packed(part[1], part[2])
        bodies.append(w.getvalue())

    sizes = [len(head) + len(b) + 8 for b in bodies]
    split_rows = [
        part[3] if part[0] == "packed" else [(0, 0, 0)] * (N_SPLITS - 1)
        for part in parts
    ]
    ncmds = [part[4] if part[0] == "packed" else 0 for part in parts]
    xt = _build_index(m, sizes, split_rows, ncmds) if index else None
    if xt is not None:
        head0 = bytearray(head)
        head0[3] |= gz._FEXTRA
        heads = [bytes(head0) + xt] + [head] * (m - 1)
    else:
        heads = [head] * m
    out = []
    for i in range(m):  # order-preserving: by member index
        out.append(heads[i])
        out.append(bodies[i])
        out.append(int(crcs[i]).to_bytes(4, "little"))
        out.append(int(int(n_valid[i]) & 0xFFFFFFFF).to_bytes(4, "little"))
    archive = b"".join(out)
    if return_meta:
        return archive, sizes, split_rows, ncmds
    return archive


def _build_index(m: int, sizes: list, split_rows: list,
                 ncmds: list | None = None) -> bytes | None:
    """FEXTRA bytes (XLEN + subfields) for the member index, or None.

    ``sizes`` are per-member byte sizes *excluding* the index field
    itself; the first member's recorded size is grown by the field
    length.  ``split_rows`` holds ``N_SPLITS - 1`` (bit, cmd, out)
    triples per member (all-zero for stored members).  Shared by the
    single-host and multi-host assembly paths so the archive bytes are
    identical for any host count.

    When the archive was written with bit-stride splits (SPLIT_BITS)
    and ``ncmds`` (total commands per member) is available, the splits
    are encoded as the compact TB subfield: u32 stride + per member
    (u16 count, u16 max row commands, count x u8 deltas) — 3-4 bytes
    per split point less ~9, since the command index and output offset
    are derivable (bit-based stopping + device prefix sums).  A 128 KiB
    member costs ~50 B instead of ~530 B, so dense split points no
    longer dent the compression ratio or the 64 KiB FEXTRA budget.
    """
    if m > (65531 - 8) // 4:
        return None
    tb = None
    if SPLIT_BITS > 0 and ncmds is not None:
        tb = _encode_tb(split_rows, ncmds, SPLIT_BITS)
    xdata_len = 4 + 4 * m
    extra_len = 2 + 4 + xdata_len
    sfield = b""
    if tb is not None and 4 + xdata_len + 4 + len(tb) <= 65535:
        sfield = TBITS_ID + len(tb).to_bytes(2, "little") + tb
        extra_len += len(sfield)
        use_splits = False
    else:
        # legacy 12-byte triples, one global subfield
        split_len = 1 + sum(
            1 + 12 * sum(1 for t in row if t[0] > 0) for row in split_rows)
        use_splits = 4 + (4 + 4 * m) + (4 + split_len) <= 65535
    if use_splits:
        # count-prefixed VALID triples per member (bit offset 0 =
        # unused slot): members record ~ncmds/SPLIT_STRIDE triples, so
        # storing the full N_SPLITS-1 rectangle would waste ~40 KiB on
        # a typical archive
        parts_enc = []
        for row in split_rows:
            valid = [t for t in row if t[0] > 0]
            parts_enc.append(bytes([len(valid)]) + b"".join(
                bo.to_bytes(4, "little") + ci.to_bytes(4, "little")
                + oo.to_bytes(4, "little") for (bo, ci, oo) in valid))
        sdata = bytes([N_SPLITS]) + b"".join(parts_enc)
        sfield = SPLIT_ID + len(sdata).to_bytes(2, "little") + sdata
        extra_len += len(sfield)
    sizes = list(sizes)
    sizes[0] += extra_len  # first member grows by the FEXTRA
    xfield = INDEX_ID + xdata_len.to_bytes(2, "little") \
        + m.to_bytes(4, "little") \
        + b"".join(s.to_bytes(4, "little") for s in sizes) + sfield
    return len(xfield).to_bytes(2, "little") + xfield


class _Rows(NamedTuple):
    """An indexed archive cut into decode rows (see :func:`_stage_rows`)."""

    metas: list         # per member: (prepare_member result, body, crc, isize)
    huff: list          # indices of the Huffman-coded members
    rows: list          # per row: (member index, start bit, stop)
    row_caps: list      # per row: most commands it can hold
    words: np.ndarray   # uint32[len(huff) + 1, W]: bodies; last row empty
    lit_lens: np.ndarray   # int32[len(huff) + 1, 288]
    dist_lens: np.ndarray  # int32[len(huff) + 1, 32]
    start_bits: np.ndarray  # int32[B]: B = rows padded to a power of two
    stops: np.ndarray   # int32[B]: stop bit (bit_mode) or command count
    row_members: np.ndarray  # int32[B]: index into words; pad rows -> last
    bit_mode: bool      # rows stop by bit position (compact TB index)
    use_splits: bool    # members are cut at their recorded split points
    out_len: int        # largest member, rounded up to a power of two

    @property
    def nrows(self) -> int:
        return len(self.rows)

    def xla_slots(self) -> int:
        """Slot count for ``inflate.decode_symbols``: room for every
        row's commands plus the NOP slots its bit window may add."""
        worst = max(
            inflate_ops.worst_case_slots(c) for c in self.row_caps
        ) if self.use_splits else inflate_ops.worst_case_slots(self.out_len)
        return _ceil_pow2_int(worst + 4)

    def triton_slots(self) -> int:
        """Slot count for ``inflate_triton.decode_symbols`` (no NOPs)."""
        return _ceil_pow2_int(max(self.row_caps) + 4)


def _stage_rows(buf: np.ndarray) -> _Rows | None:
    """Parse an indexed archive into device decode rows.

    Returns None when the archive cannot take the member-parallel path
    (no index, sizes that do not tile the buffer, or a member that is
    not one fixed or dynamic block); those decode serially.
    """
    try:
        sizes, splits, tb = _read_index_ex(buf)
    except (gz.MalformedError, ValueError):
        return None
    if sizes is None or sum(sizes) != buf.size:
        return None
    metas = []
    off = 0
    try:
        for s in sizes:
            mem = buf[off : off + s]
            off += s
            body_off = gz._header_end(mem)
            if body_off is None:
                return None
            body = mem[body_off:-8]
            crc = int.from_bytes(mem[-8:-4].tobytes(), "little")
            isize = int.from_bytes(mem[-4:].tobytes(), "little")
            metas.append((inflate_ops.prepare_member(body), body, crc, isize))
    except (inflate_ops.NotParallelizable, de.MalformedError, EOFError):
        return None
    huff = [i for i, (p, *_rest) in enumerate(metas) if p[0] == "huff"]

    # symbol-stream split points let each member decode as several
    # independent rows (shared tables, recorded bit offsets)
    use_splits = splits is not None and len(splits) == len(metas)
    bit_mode = bool(use_splits and tb is not None)
    if use_splits:
        for i in huff:
            tri = [t for t in splits[i] if t[0] > 0]
            (_, _, _, start), _, _, isize = metas[i]
            prev_bit, prev_cmd = start, 0
            for (bo, ci, oo) in tri:
                if bo <= prev_bit or (not bit_mode and
                                      (ci <= prev_cmd or oo > isize)):
                    use_splits = False  # corrupt index: whole-member rows
                prev_bit, prev_cmd = bo, ci
    bit_mode = bit_mode and use_splits

    m = len(huff)
    if not m:  # stored members only: no device rows
        no_rows = np.zeros(0, np.int32)
        no_members = np.zeros((0, 0), np.int32)
        return _Rows(metas, huff, [], [], no_members, no_members, no_members,
                     no_rows, no_rows, no_rows, bit_mode, use_splits, 1)
    out_len = _ceil_pow2_int(max(metas[i][3] for i in huff))
    wmax = _ceil_pow2_int(max(metas[i][1].size for i in huff) // 4 + 4)
    # cap = the largest command count between consecutive split points
    # (the stride for command-stride archives; the recorded row density
    # for bit-stride ones)
    stride_cap = 0
    if bit_mode:
        stride_cap = max((tb["max_cmds"][i] for i in huff), default=0)
    elif use_splits:
        for i in huff:
            prev = 0
            for t in (t for t in splits[i] if t[0] > 0):
                stride_cap = max(stride_cap, t[1] - prev)
                prev = t[1]
    # rows: (member idx, start bit, stop) -- stop is a COMMAND count for
    # legacy TS archives and the next row's START BIT for compact TB
    # archives (0 = decode to end-of-block either way)
    rows: list = []
    row_caps: list = []
    for i in huff:
        (_, _, _, start), _, _, isize = metas[i]
        tri = [t for t in splits[i] if t[0] > 0] if use_splits else []
        bits = [start] + [t[0] for t in tri]
        cmdb = [0] + [t[1] for t in tri]
        outb = [0] + [t[2] for t in tri]
        for j in range(len(bits)):
            if j + 1 < len(bits):
                stop = bits[j + 1] if bit_mode else cmdb[j + 1] - cmdb[j]
                cap = (tb["max_cmds"][i] or stride_cap or isize + 2) \
                    if bit_mode else stop
            else:
                stop = 0
                cap = isize - outb[-1] + 2  # cmds <= out bytes + EOB
                if stride_cap:
                    # a too-small cap is safe: the row fails to reach
                    # EOB -> ok=False -> the serial fallback (and CRCs
                    # backstop everything)
                    cap = min(cap, stride_cap + 4)
            rows.append((i, bits[j], stop))
            row_caps.append(cap)
    # pow2 row bucket: bounds compile variants; the decode loops exit as
    # soon as every row is done, so rounding up is ~free
    b_pad = _ceil_pow2_int(len(rows))
    # per-MEMBER arrays (+1 sentinel row with empty tables for padding
    # rows): rows map to members on device, so the host link carries
    # each member's words and code lengths once
    midx = {i: r for r, i in enumerate(huff)}
    words = np.zeros((m + 1, wmax), np.uint32)
    lit_lens = np.zeros((m + 1, 288), np.int32)
    dist_lens = np.zeros((m + 1, 32), np.int32)
    for i in huff:
        (_, ll_, dl_, _), body, _, _ = metas[i]
        bw = np.zeros(wmax * 4, np.uint8)
        bw[: body.size] = body
        words[midx[i]] = bw.view("<u4")
        lit_lens[midx[i]] = ll_
        dist_lens[midx[i]] = dl_
    start_bits = np.zeros(b_pad, np.int32)
    stops = np.zeros(b_pad, np.int32)
    row_members = np.full(b_pad, m, np.int32)
    for row, (i, bit, stop) in enumerate(rows):
        start_bits[row] = bit
        stops[row] = stop
        row_members[row] = midx[i]
    return _Rows(metas, huff, rows, row_caps, words, lit_lens, dist_lens,
                 start_bits, stops, row_members, bit_mode, use_splits,
                 out_len)


def _decoder_for(st: _Rows, words) -> str:
    """The symbol decoder for rows staged on ``words``'s device: the
    Triton kernel on a GPU (it stops rows by bit position only), the
    XLA loop elsewhere and for command-stopped rows."""
    platform = next(iter(words.devices())).platform
    if platform == "gpu" and (st.bit_mode or not st.use_splits):
        return "triton"
    return "xla"


def _decode_rows(st: _Rows, decoder: str | None = None):
    """Symbol-decode every staged row on the device.  Returns
    (kinds int8[B, S], values, dists int32[B, S], ok bool[B]) in
    ``inflate.decode_symbols``'s format."""
    import jax.numpy as jnp

    words = jnp.asarray(st.words)
    decoder = decoder or _decoder_for(st, words)
    start_bits = jnp.asarray(st.start_bits)
    stops = jnp.asarray(st.stops)
    row_members = jnp.asarray(st.row_members)
    if decoder == "triton":
        from ..ops import inflate_triton

        with profiling.annotate("decode_symbols_triton"):
            return inflate_triton.decode_symbols(
                words, start_bits, jnp.asarray(st.lit_lens),
                jnp.asarray(st.dist_lens), max_cmds=st.triton_slots(),
                stop_bits=stops, row_members=row_members)
    with profiling.annotate("build_decode_tables"):
        lit_tabs, dist_tabs = inflate_ops.build_fused_tables(
            jnp.asarray(st.lit_lens), jnp.asarray(st.dist_lens))
    with profiling.annotate("decode_symbols"):
        return inflate_ops.decode_symbols(
            words, start_bits, lit_tabs, dist_tabs,
            max_cmds=st.xla_slots(),
            stop_counts=stops if st.use_splits and not st.bit_mode else None,
            stop_bits=stops if st.bit_mode else None,
            row_members=row_members)


def sharded_gzip_decompress(archive, *, expand: str = "auto") -> bytes:
    """Member-parallel decode of an indexed archive (device batch
    inflate); stored members resolve on host; falls back to the serial
    path when the index is absent or a member isn't device-decodable."""
    return _decompress(de._np_u8(archive), expand)


def _decompress(buf: np.ndarray, expand: str = "auto",
                decoder: str | None = None) -> bytes:
    st = _stage_rows(buf)
    if st is None:
        return gz.decompress(buf)
    import jax.numpy as jnp

    from .. import native

    metas, huff, rows = st.metas, st.huff, st.rows
    results: list = [None] * len(metas)
    crcs_ok = True
    # rows can reference earlier rows' output, so split rows need the
    # in-order expansion: the native (host) one, or the device one over
    # per-member command matrices
    use_native = native.available() and expand != "device"

    if huff:
        m = len(huff)
        nrows = st.nrows
        midx = {i: r for r, i in enumerate(huff)}
        first_row: dict = {}
        for row, (i, _bit, _stop) in enumerate(rows):
            first_row.setdefault(i, row)
        kinds, values, dvals, ok = _decode_rows(st, decoder)
        if not bool(np.asarray(ok)[:nrows].all()):
            return gz.decompress(buf)

        def _slot_spans(kk):
            stops = jnp.asarray(st.stops[:kk.shape[0]])
            if st.bit_mode:
                return inflate_ops.slot_counts_bits(kk, stops)
            return inflate_ops.slot_counts(kk, stops)

        if use_native:
            # ragged-compact the command stream on device, expand on host
            # (C++): fetches ~sum(ncmds) words instead of running the
            # pointer-jump expansion rounds.  Each member's rows are
            # consecutive, so its command stream is the concatenation of
            # its rows' spans (interior rows carry no end marker).
            packed = (kinds.astype(jnp.int32) << 26) | (dvals << 10) | values
            # per-row SLOT spans (NOP slots included: the C++ expander
            # skips kind-3 words), not command counts
            ncmds = np.asarray(_slot_spans(kinds))
            total = int(ncmds.sum())
            out_size = _ceil_pow2_int(max(total, 1))
            flat = np.asarray(
                inflate_ops.compact_commands(packed, jnp.asarray(ncmds), out_size)
            ).astype(np.uint32)
            row_starts = np.concatenate([[0], np.cumsum(ncmds)])
            for i in huff:
                _, _, crc, isize = metas[i]
                r0 = first_row[i]
                r1 = r0 + 1
                while r1 < nrows and rows[r1][0] == i:
                    r1 += 1
                seg = np.ascontiguousarray(
                    flat[int(row_starts[r0]) : int(row_starts[r1])]
                )
                outbuf = np.empty(isize + 4, np.uint8)
                try:
                    produced = native.expand_cmds(seg, outbuf)
                except ValueError:
                    crcs_ok = False
                    break
                if produced != isize or native.crc32(outbuf[:isize].tobytes()) != crc:
                    crcs_ok = False
                    break
                results[i] = outbuf[:isize].tobytes()
        else:
            # fully-on-device path (device-resident outputs / no native
            # lib): rows are regrouped into per-MEMBER command matrices
            # on device (the compacted flat stream is member-major), then
            # LZ77-expanded and CRC'd on device
            if st.use_splits:
                packed = (kinds.astype(jnp.int32) << 26) | (dvals << 10) | values
                ncmds = np.asarray(_slot_spans(kinds))
                total = int(ncmds.sum())
                flat = inflate_ops.compact_commands(
                    packed, jnp.asarray(ncmds), _ceil_pow2_int(max(total, 1)))
                row_starts = np.concatenate([[0], np.cumsum(ncmds)])
                mstart = np.zeros(m, np.int64)
                mtotal = np.zeros(m, np.int64)
                for i in huff:
                    r0 = first_row[i]
                    r1 = r0 + 1
                    while r1 < nrows and rows[r1][0] == i:
                        r1 += 1
                    mstart[midx[i]] = row_starts[r0]
                    mtotal[midx[i]] = row_starts[r1] - row_starts[r0]
                mc = _ceil_pow2_int(int(mtotal.max()))
                j = jnp.arange(mc, dtype=jnp.int32)[None, :]
                idx = jnp.asarray(mstart.astype(np.int32))[:, None] + j
                mem = jnp.where(
                    j < jnp.asarray(mtotal.astype(np.int32))[:, None],
                    flat[jnp.minimum(idx, flat.shape[0] - 1)], 2 << 26)
                mk = (mem >> 26).astype(jnp.int8)
                mv = mem & 0x3FF
                md = (mem >> 10) & 0xFFFF
            else:
                mk, mv, md = kinds, values, dvals
            payload, lengths = inflate_ops.expand_commands(mk, mv, md, st.out_len)
            lengths = np.asarray(lengths)
            crcs = checksum.crc32_batch_device(payload, np.asarray(lengths))
            payload = np.asarray(payload)
            for row, i in enumerate(huff):
                _, _, crc, isize = metas[i]
                if int(lengths[row]) != isize or int(crcs[row]) != crc:
                    crcs_ok = False
                    break
                results[i] = payload[row, :isize].tobytes()

    if crcs_ok:
        for i, (p, _, crc, isize) in enumerate(metas):
            if p[0] != "stored":
                continue
            data = p[1]
            if len(data) != isize or gz.checksum.crc32(data) != crc:
                crcs_ok = False
                break
            results[i] = data
    if not crcs_ok or any(r is None for r in results):
        return gz.decompress(buf)  # checksum mismatch: trust serial path
    return b"".join(results)


def _ceil_pow2_int(n: int) -> int:
    p = 1
    while p < max(n, 1):
        p *= 2
    return p


def huffman_invalid() -> int:
    from ..core import huffman

    return huffman.ENTRY_INVALID


def _read_index(buf: np.ndarray) -> list[int] | None:
    """Member sizes from the first member's FEXTRA index, or None."""
    sizes, _, _ = _read_index_ex(buf)
    return sizes


def _read_index_ex(buf: np.ndarray):
    """(member sizes, per-member split triples, tb meta) from the
    FEXTRA index.

    Legacy splits (SPLIT_ID subfield) are (bit_off, cmd_idx, out_off)
    triples per interior chunk boundary.  Compact bit-stride splits
    (TBITS_ID) are returned as synthesized (bit_off, 0, 0) triples plus
    ``tb = {"bits": stride, "max_cmds": [per member]}`` — their rows
    stop by BIT position, not command count.  (None, None, None)-ish
    when the archive has no index / no split subfield.
    """
    if buf.size < 12 or buf[0] != 0x1F or buf[1] != 0x8B:
        raise gz.MalformedError("invalid header")
    if not (int(buf[3]) & gz._FEXTRA):
        return None, None, None
    xlen = int.from_bytes(buf[10:12].tobytes(), "little")
    field = buf[12 : 12 + xlen].tobytes()
    i = 0
    sizes = None
    splits = None
    tb = None
    while i + 4 <= len(field):
        sid = field[i : i + 2]
        ln = int.from_bytes(field[i + 2 : i + 4], "little")
        data = field[i + 4 : i + 4 + ln]
        if sid == TBITS_ID and len(data) >= 4:
            stride = int.from_bytes(data[:4], "little")
            rows_out = []
            maxes = []
            j = 4
            bad = stride <= 0
            while not bad and j + 4 <= len(data):
                cnt = int.from_bytes(data[j : j + 2], "little")
                maxc = int.from_bytes(data[j + 2 : j + 4], "little")
                j += 4
                if j + cnt > len(data):
                    bad = True
                    break
                rows_out.append([
                    ((k + 1) * stride - data[j + k], 0, 0)
                    for k in range(cnt)
                ])
                maxes.append(maxc)
                j += cnt
            if not bad and rows_out:
                splits = rows_out
                tb = {"bits": stride, "max_cmds": maxes}
        elif sid == INDEX_ID:
            m = int.from_bytes(data[:4], "little")
            if len(data) != 4 + 4 * m:
                return None, None, None
            sizes = [
                int.from_bytes(data[4 + 4 * k : 8 + 4 * k], "little")
                for k in range(m)
            ]
        elif sid == SPLIT_ID and len(data) >= 1:
            ns = data[0]
            rows_out = []
            j = 1
            bad = ns < 2
            while j < len(data):
                nvalid = data[j]
                j += 1
                if nvalid > ns - 1 or j + 12 * nvalid > len(data):
                    bad = True
                    break
                row = []
                for _ in range(nvalid):
                    row.append((
                        int.from_bytes(data[j : j + 4], "little"),
                        int.from_bytes(data[j + 4 : j + 8], "little"),
                        int.from_bytes(data[j + 8 : j + 12], "little"),
                    ))
                    j += 12
                rows_out.append(row)
            if not bad and rows_out:
                splits = rows_out
        i += 4 + ln
    return sizes, splits, tb


def sharded_zlib_compress(
    data,
    level: int = 6,
    *,
    member_size: int = de.SEGMENT_SIZE,
    mesh=None,
) -> bytes:
    """One zlib stream compressed data-parallel.

    Member blocks are chained with BFINAL=0 (window reset at boundaries
    is encoder-legal) and the stream Adler-32 is folded across shards
    with the associative combine — no shard ever sees the whole input.
    """
    arr = de._np_u8(data)
    if arr.size == 0:
        return zl.deflate(b"", level)
    m = max(1, (arr.size + member_size - 1) // member_size)
    final_flags = np.zeros(m, bool)
    final_flags[-1] = True
    parts, n_valid, _ = _compress_members(
        arr, level, member_size, mesh, final_flags=final_flags, want_crc=False
    )
    # stream Adler: members tile `arr` consecutively, so the in-order
    # associative fold over per-member adlers equals ONE adler of the
    # whole input — no O(members) host loop (each host process computes
    # its shard's adler once; the cross-process fold stays the combine)
    adler = checksum.adler32(arr)

    cmf = 0x78
    flg = zl._flevel(level) << 6
    rem = (cmf * 256 + flg) % 31
    if rem:
        flg += 31 - rem
    w = bitstream.BitWriter()
    w.write_bytes(bytes([cmf, flg]))
    for i, part in enumerate(parts):
        final = i == m - 1
        if part[0] == "stored":
            de._emit_stored(w, part[1], final=final)
        else:
            w.write_packed(part[1], part[2])
            if not final:
                # Z_SYNC_FLUSH: empty stored block realigns to a byte
                # boundary so the next member's bits concatenate cleanly
                w.write(0, 3)
                w.align_to_byte()
                w.write(0, 16)
                w.write(0xFFFF, 16)
    out = w.getvalue()
    return out + int(adler).to_bytes(4, "big")


# ---------------------------------------------------------------------------
# shard_map step with explicit collectives (the dryrun/multi-chip path).
# ---------------------------------------------------------------------------


def compress_step_sharded(mesh, data, n_valid, hist_len, bfinal, *, level=6, seg_len=4096):
    """One sharded compression step with explicit collectives.

    shard_map over the ``dp`` axis: each shard runs the full on-device
    fixed-Huffman deflate for its members, then sizes are all-gathered
    (the order-preserving gather's size exchange) and total output bits
    are psum'd (scaling stats).  Returns (words, sizes_all, total_bits).
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from jax import shard_map

    from ..ops import pipeline

    def step(d, nv, hl, bf):
        words, totals = pipeline.fixed_deflate_segments(
            d, nv, hl, bf, level=level, seg_len=seg_len
        )
        sizes_all = jax.lax.all_gather(totals, "dp")  # [ndev, m_local]
        total_bits = jax.lax.psum(jnp.sum(totals), "dp")
        return words, sizes_all, total_bits

    specs = P("dp")
    fn = shard_map(
        step, mesh=mesh,
        in_specs=(P("dp", None), specs, specs, specs),
        out_specs=(P("dp", None), P(None, "dp"), P()),
    )
    return jax.jit(fn)(data, n_valid, hist_len, bfinal)
