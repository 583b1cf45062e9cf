"""LZO1X block codec.

Capability parity with the reference `Lzo` module (lib/lzo.ml):
``uncompress`` (lzo.ml:395–403), ``uncompress_with_buffer``
(growable-output variant), ``compress`` (lzo.ml:652–656) and
``make_wrkmem`` (lzo.ml:624–630).  The opcode grammar implemented here
is the classic LZO1X instruction set (reference `fiber`,
lzo.ml:315–393): first-byte literal runs, M1/M2/M3/M4 matches with
2-bit trailing-literal state carry, 255-run extended lengths, and the
M4 dist==16384 end marker.

Device/host split: match *finding* reuses the vectorized device LZ77
kernel (ops/lz77.py) — LZO and DEFLATE share the match finder exactly
as the reference shares `De.Lz77`-style matching across codecs — while
the byte-oriented opcode emission/decoding is host code (it is
inherently serial and tiny next to match finding).
"""

from __future__ import annotations

import numpy as np

from . import de


class LzoError(ValueError):
    """Typed LZO data errors (reference polymorphic variants, lzo.ml:4–5)."""


M4_MAX_DIST = 49151


class WrkMem:
    """Opaque work memory for compress (reference `make_wrkmem`,
    lzo.ml:624–630).  Holds reusable scratch for the host emitter."""

    def __init__(self) -> None:
        self.scratch = bytearray(0x4000)


def make_wrkmem() -> WrkMem:
    return WrkMem()


# ---------------------------------------------------------------------------
# Decoder (host reference; the device batch decoder reuses this grammar).
# ---------------------------------------------------------------------------


def _read_extended(buf: np.ndarray, ip: int, base: int) -> tuple[int, int]:
    """255-run extended length (reference `count` zero-run, lzo.ml:218–234)."""
    t = 0
    n = buf.size
    while ip < n and buf[ip] == 0:
        t += 255
        ip += 1
        if t > 2**24:
            raise LzoError("invalid extended length")
    if ip >= n:
        raise LzoError("unexpected end of input")
    t += base + int(buf[ip])
    return t, ip + 1


def uncompress(data, output: bytearray | None = None, *, max_size: int | None = None) -> bytes:
    """Decode one LZO1X block.

    Mirrors `Lzo.uncompress` semantics: raises :class:`LzoError` on
    malformed input (`Invalid_argument`/`Malformed` variants,
    lzo.ml:4–5).  Uses the native decoder when available (the Python
    state machine below is the reference fallback and documents the
    opcode grammar).
    """
    if output is None:
        try:
            from . import native

            if native.available():
                cap = max_size if max_size is not None else max(64, len(bytes(data)) * 64)
                try:
                    return native.lzo1x_decompress(data, cap)
                except native.LzoNativeError as e:
                    if "-2" in str(e) and max_size is None:
                        # output larger than the heuristic cap: retry big
                        return native.lzo1x_decompress(data, 1 << 30)
                    raise LzoError(str(e)) from e
        except ImportError:  # pragma: no cover
            pass
    return _uncompress_python(data, output, max_size=max_size)


def _uncompress_python(data, output: bytearray | None = None, *,
                       max_size: int | None = None) -> bytes:
    buf = de._np_u8(data)
    n = buf.size
    out = bytearray() if output is None else output
    if n == 0:
        raise LzoError("unexpected end of input")
    ip = 0
    state = 0

    first = int(buf[ip])
    if first > 17:
        ip += 1
        t = first - 17
        if ip + t > n:
            raise LzoError("unexpected end of input")
        if max_size is not None and t > max_size:
            raise LzoError("output too large")
        out += buf[ip : ip + t].tobytes()
        ip += t
        state = 4 if t >= 4 else t

    while True:
        if ip >= n:
            raise LzoError("unexpected end of input")
        t = int(buf[ip])
        ip += 1
        if t < 16:
            if state == 0:
                # literal run
                if t == 0:
                    length, ip = _read_extended(buf, ip, 15)
                else:
                    length = t
                length += 3
                if ip + length > n:
                    raise LzoError("unexpected end of input")
                if max_size is not None and len(out) + length > max_size:
                    raise LzoError("output too large")
                out += buf[ip : ip + length].tobytes()
                ip += length
                state = 4
                continue
            if ip >= n:
                raise LzoError("unexpected end of input")
            nxt = int(buf[ip])
            ip += 1
            if state in (1, 2, 3):
                # M1: 2-byte match, short distance
                dist = (t >> 2) + (nxt << 2) + 1
                length = 2
            else:  # state == 4: M0 short match after literal run
                dist = (t >> 2) + (nxt << 2) + 2049
                length = 3
            s = t & 3
        elif t < 32:
            # M4: long-distance match / end marker
            length = t & 7
            if length == 0:
                length, ip = _read_extended(buf, ip, 7)
            length += 2
            if ip + 2 > n:
                raise LzoError("unexpected end of input")
            le16 = int(buf[ip]) | (int(buf[ip + 1]) << 8)
            ip += 2
            dist = 16384 + ((t & 8) << 11) + (le16 >> 2)
            s = le16 & 3
            if dist == 16384:
                break  # end marker
        elif t < 64:
            # M3
            length = t & 31
            if length == 0:
                length, ip = _read_extended(buf, ip, 31)
            length += 2
            if ip + 2 > n:
                raise LzoError("unexpected end of input")
            le16 = int(buf[ip]) | (int(buf[ip + 1]) << 8)
            ip += 2
            dist = (le16 >> 2) + 1
            s = le16 & 3
        else:
            # M2
            length = (t >> 5) + 1
            if ip >= n:
                raise LzoError("unexpected end of input")
            dist = ((t >> 2) & 7) + (int(buf[ip]) << 3) + 1
            ip += 1
            s = t & 3

        if dist > len(out):
            raise LzoError("out of bound")
        if max_size is not None and len(out) + length > max_size:
            raise LzoError("output too large")
        src = len(out) - dist
        if dist >= length:
            out += out[src : src + length]
        else:
            chunk = bytes(out[src:])
            while len(chunk) < length:
                chunk = chunk + chunk
            out += chunk[:length]
        if s:
            if ip + s > n:
                raise LzoError("unexpected end of input")
            if max_size is not None and len(out) + s > max_size:
                raise LzoError("output too large")
            out += buf[ip : ip + s].tobytes()
            ip += s
        # after a match: state = trailing-literal count (1..3) or 0;
        # state 4 only ever follows a standalone literal run
        state = s

    if ip != n:
        raise LzoError("trailing bytes after end marker")
    return bytes(out)


def uncompress_into(data, output: np.ndarray) -> int:
    """Decode into a caller-owned buffer; returns the byte count
    (reference `uncompress : bigstring -> bigstring -> (int, error)
    result` signature, lzo.mli:9–45)."""
    out = uncompress(data, max_size=int(output.size))
    output[: len(out)] = np.frombuffer(out, np.uint8)
    return len(out)


def uncompress_with_buffer(data) -> bytes:
    """Growable-output variant (reference Buffer interpreter,
    lzo.ml:199–216)."""
    return _uncompress_python(data, bytearray())


# ---------------------------------------------------------------------------
# Encoder: device match finding + host opcode emission.
# ---------------------------------------------------------------------------


def _emit_run(out: bytearray, arr: np.ndarray, lo: int, hi: int, first: bool) -> None:
    """Standalone literal run (legal at decoder state 0 / stream start)."""
    run = hi - lo
    if run == 0:
        return
    if first and run <= 238:
        out.append(run + 17)
    elif run < 4:
        raise AssertionError("short literal run mid-stream")  # by construction
    elif run <= 18:
        out.append(run - 3)
    else:
        out.append(0)
        rem = run - 18
        while rem > 255:
            out.append(0)
            rem -= 255
        out.append(rem)
    out += arr[lo:hi].tobytes()


def _emit_match(out: bytearray, arr: np.ndarray, dist: int, length: int,
                s: int, s_lo: int) -> None:
    """One M2/M3/M4 instruction with ``s`` (0..3) trailing literals."""
    if dist <= 2048 and 3 <= length <= 8:
        t = ((length - 1) << 5) | (((dist - 1) & 7) << 2) | s
        out.append(t)
        out.append((dist - 1) >> 3)
    elif dist <= 16384:
        base = length - 2
        if base < 32:
            out.append(32 | base)
        else:
            out.append(32)
            rem = base - 31
            while rem > 255:
                out.append(0)
                rem -= 255
            out.append(rem)
        le16 = ((dist - 1) << 2) | s
        out += bytes((le16 & 0xFF, le16 >> 8))
    else:
        d = dist - 16384
        base = length - 2
        t = 16 | ((d >> 11) & 8)
        if base < 8:
            out.append(t | base)
        else:
            out.append(t)
            rem = base - 7
            while rem > 255:
                out.append(0)
                rem -= 255
            out.append(rem)
        le16 = ((d & 0x3FFF) << 2) | s
        out += bytes((le16 & 0xFF, le16 >> 8))
    if s:
        out += arr[s_lo : s_lo + s].tobytes()


def compress(data, wrkmem: WrkMem | None = None, *, level: int = 6) -> bytes:
    """LZO1X compress (reference `Lzo.compress`, lzo.ml:652–656).

    Match finding runs on device (shared with DEFLATE); opcode
    emission is host-side.  Output decodes with any LZO1X decoder.

    Emission invariants: a literal run of 1..3 only appears at stream
    start (first-byte form) or riding a match's 2 trailing-literal
    bits; standalone runs are always >= 4 and only occur at decoder
    state 0 (after a match with s == 0 or at stream start).
    """
    arr = de._np_u8(data)
    n = arr.size
    out = bytearray()
    if n == 0:
        out += bytes((0x11, 0x00, 0x00))  # just the end marker
        return bytes(out)

    on_path, is_match, length, dist = _analyze(arr, level)

    match_pos = np.flatnonzero(is_match & on_path)
    lit_start = 0
    first = True
    i = 0
    nm = match_pos.size
    while i < nm:
        p = int(match_pos[i])
        ln = int(length[p])
        dd = int(dist[p])
        run = p - lit_start
        if run > 0:
            _emit_run(out, arr, lit_start, p, first)
            first = False
        first = False
        # trailing literals: gap to the next match (or EOF), if 1..3
        q = p + ln
        nxt = int(match_pos[i + 1]) if i + 1 < nm else n
        tail = nxt - q
        s = tail if 0 < tail < 4 else 0
        _emit_match(out, arr, dd, ln, s, q)
        lit_start = q + s
        i += 1
    if lit_start < n:
        _emit_run(out, arr, lit_start, n, first)
    out += bytes((0x11, 0x00, 0x00))
    return bytes(out)


def _analyze(arr: np.ndarray, level: int):
    """Device match finding for LZO: one batched call per 128 KiB chunk
    batch, same kernel as DEFLATE (matches: len>=3, dist<=32768)."""
    import jax.numpy as jnp

    from .ops import lz77 as lz77_ops

    n = arr.size
    seg = de.SEGMENT_SIZE
    nseg = (n + seg - 1) // seg
    on_path = np.zeros(n, bool)
    is_match = np.zeros(n, bool)
    length = np.zeros(n, np.int32)
    dist = np.zeros(n, np.int32)
    for lo_seg in range(0, nseg, de.MAX_DEVICE_BATCH):
        hi_seg = min(lo_seg + de.MAX_DEVICE_BATCH, nseg)
        b = hi_seg - lo_seg
        b_pad = de.MAX_DEVICE_BATCH if b == de.MAX_DEVICE_BATCH else 1 << (b - 1).bit_length()
        data = np.zeros((b_pad, lz77_ops.HIST + seg), dtype=np.uint8)
        n_valid = np.zeros(b_pad, dtype=np.int32)
        hist_len = np.zeros(b_pad, dtype=np.int32)
        for i, s in enumerate(range(lo_seg, hi_seg)):
            start = s * seg
            stop = min(start + seg, n)
            n_valid[i] = stop - start
            hl = min(lz77_ops.HIST, start)
            hist_len[i] = hl
            data[i, lz77_ops.HIST - hl : lz77_ops.HIST] = arr[start - hl : start]
            data[i, lz77_ops.HIST : lz77_ops.HIST + stop - start] = arr[start:stop]
        res = lz77_ops.analyze(
            jnp.asarray(data), jnp.asarray(n_valid), jnp.asarray(hist_len),
            level=level, seg_len=seg,
        )
        for i, s in enumerate(range(lo_seg, hi_seg)):
            start = s * seg
            stop = min(start + seg, n)
            sl = slice(start, stop)
            m = stop - start
            on_path[sl] = np.asarray(res["on_path"])[i, :m]
            is_match[sl] = np.asarray(res["is_match"])[i, :m]
            length[sl] = np.asarray(res["length"])[i, :m]
            dist[sl] = np.asarray(res["dist"])[i, :m]
    return on_path, is_match, length, dist
