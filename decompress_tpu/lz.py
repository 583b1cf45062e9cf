"""Standalone LZ77 compressor package (reference `Lz`, lib/lz.ml).

The reference ships `decompress.lz` as an independent rolling-hash
matcher kept for compatibility (SURVEY §2 #14): a 3-byte rolling hash
(`update_hash` lz.ml:149–155, `insert_string` lz.ml:308–315) over a
head table, greedy emission into a `De.Queue` (levels 0–4 collapse to
one configuration, lz.ml:530–541).  This module is the same kind of
beast — a self-contained HOST matcher, deliberately not the device
kernel — so the two can cross-check each other:

* :func:`compress_into` / :class:`State` — rolling-hash greedy matcher
  (head + bounded chain walk, byte-exact extension); distinct
  algorithm and code path from ops/lz77.py.
* ``device=True`` routes through the shared device match finder
  instead (the device default elsewhere in the package).

Both emit the same Queue int packing, so `de.encode_commands` /
`streaming.Def` encode either.
"""

from __future__ import annotations

from collections import deque

from . import de
from .streaming import Queue

__all__ = ["Queue", "State", "compress_into", "make_window"]

_MIN = 3
_MAX = 258
_WSIZE = 32768


def make_window(bits: int = 15) -> int:
    """Window size for a given bit width (make_window parity,
    de.ml:331–333); the host matcher carries no buffer state."""
    if not 8 <= bits <= 15:
        raise ValueError("window bits must be in 8..15")
    return 1 << bits


class _MatchState:
    """Greedy rolling-hash matcher whose window SURVIVES across feeds.

    The reference carries its hash chains and the last window of bytes
    across `src` calls (lz.ml:308–352), so a match in feed N can copy
    from feed N-1.  This is the same design in host Python: positions
    are absolute stream offsets, `hist` retains the last `max_dist`
    (plus slack) bytes, and the head/prev tables hold absolute
    positions pruned with the window.

    Head-table + short chain walk, exact byte extension — the
    reference Lz design (single configuration; levels collapse,
    lz.ml:530–541)."""

    def __init__(self, max_dist: int = _WSIZE, chain: int = 8):
        self.max_dist = max_dist
        self.chain = chain
        self.hist = bytearray()
        self.base = 0  # absolute stream offset of hist[0]
        self.head: dict[int, int] = {}  # 3-byte key -> newest abs pos
        self.prev: dict[int, int] = {}  # abs pos -> previous same-key pos
        self.done = 0  # absolute offset of the first unprocessed byte
        # sparse in-match insertions clamped off because their 3 bytes
        # ran past the feed's end (k+2 >= end); inserted at the next
        # feed once the bytes exist, keeping chunked output command-
        # identical to one-shot (at most one per feed: the insertion
        # stride is 4 and the clamp window is 2 positions wide)
        self.pending_ins: list[int] = []

    def _trim(self) -> None:
        keep_from = self.done - self.max_dist
        if keep_from - self.base >= 3 * self.max_dist:
            del self.hist[: keep_from - self.base]
            self.base = keep_from
            self.head = {k: v for k, v in self.head.items() if v >= keep_from}
            self.prev = {k: v for k, v in self.prev.items()
                         if k >= keep_from and v >= keep_from}

    def feed(self, data: bytes, final: bool):
        """Append ``data`` and yield packed Queue commands.

        Unless ``final``, a MAX_MATCH lookahead tail is retained
        unprocessed so no match is ever truncated by a feed boundary."""
        self.hist += data
        hist, base = self.hist, self.base
        end = base + len(hist)
        stop = end if final else max(self.done, end - _MAX)
        head, prev = self.head, self.prev
        if self.pending_ins:
            # replay insertions the previous feed clamped off, in
            # position order, exactly as the one-shot loop would have
            still = []
            for k in self.pending_ins:
                if k + _MIN <= end:
                    kp = k - base
                    k_key = (hist[kp] | (hist[kp + 1] << 8)
                             | (hist[kp + 2] << 16))
                    prev[k] = head.get(k_key, -1)
                    head[k_key] = k
                else:
                    still.append(k)
            self.pending_ins = still
        max_dist, chain = self.max_dist, self.chain
        i = self.done
        while i < stop and i + _MIN <= end:
            p = i - base
            key = hist[p] | (hist[p + 1] << 8) | (hist[p + 2] << 16)
            j = head.get(key, -1)
            best_len = 0
            best_dist = 0
            depth = 0
            jj = j
            limit = min(_MAX, end - i)
            while jj >= base and i - jj <= max_dist and depth < chain:
                q = jj - base
                l = 0
                while l < limit and hist[q + l] == hist[p + l]:
                    l += 1
                if l > best_len:
                    best_len = l
                    best_dist = i - jj
                    if l >= limit:
                        break
                jj = prev.get(jj, -1)
                depth += 1
            prev[i] = j
            head[key] = i
            if best_len >= _MIN:
                yield de.cmd_copy(best_dist, best_len)
                # insert sparse hashes inside the match (every 4th
                # position keeps the table useful at a fraction of the
                # cost)
                ins_stop = min(i + best_len, end - _MIN + 1)
                for k in range(i + 1, ins_stop, 4):
                    kp = k - base
                    k_key = (hist[kp] | (hist[kp + 1] << 8)
                             | (hist[kp + 2] << 16))
                    prev[k] = head.get(k_key, -1)
                    head[k_key] = k
                if not final and ins_stop < i + best_len:
                    # positions in the stride whose 3 bytes run past
                    # this feed's end: defer to the next feed
                    first = i + 1 + ((ins_stop - i - 1 + 3) // 4) * 4
                    self.pending_ins.extend(
                        range(first, i + best_len, 4))
                i += best_len
            else:
                yield de.cmd_literal(hist[p])
                i += 1
        if final:
            while i < end:
                yield de.cmd_literal(hist[i - base])
                i += 1
        self.done = i
        self._trim()


def _matcher(data: bytes, max_dist: int = _WSIZE, chain: int = 8):
    """One-shot matcher over ``data``: yields packed Queue commands."""
    return _MatchState(max_dist, chain).feed(bytes(data), final=True)


class State:
    """Streaming matcher state (`Lz.state` parity, lz.ml:316–352):
    ``src`` feeds input, ``compress`` drains commands into the queue
    with "await"/"flush"/"end" tokens.  The match window and hash
    chains persist across feeds, so copies reference earlier feeds
    exactly like the reference's sliding window."""

    def __init__(self, q: Queue, level: int = 6, *, max_dist: int = _WSIZE):
        self.q = q
        self.level = level
        self.max_dist = max_dist
        self._m = _MatchState(max_dist=max_dist)
        self._pending: deque[int] = deque()
        self._eoi = False
        self._ended = False

    def src(self, data) -> None:
        data = bytes(data)
        if not data:
            if not self._eoi:
                self._eoi = True
                self._pending.extend(self._m.feed(b"", final=True))
        elif self._eoi:
            raise ValueError("src after end of input")
        else:
            self._pending.extend(self._m.feed(data, final=False))

    def compress(self) -> str:
        if self._ended:
            return "end"
        while self._pending:
            if self.q.is_full():
                return "flush"
            self.q.push_exn(self._pending.popleft())
        if not self._eoi:
            return "await"
        if self.q.is_full():
            return "flush"
        self.q.end_with_eob()
        self._ended = True
        return "end"


def compress_into(q: Queue, data: bytes, level: int = 6, *,
                  eob: bool = True, device: bool = False) -> None:
    """One-shot: match-find ``data`` and push commands into ``q``.

    ``device=True`` uses the shared device match finder (ops/lz77.py)
    instead of the host rolling-hash matcher.
    """
    data = bytes(data)
    if device:
        q.push_array(de.match_commands(data, b"", level))
    else:
        for c in _matcher(data):
            q.push_exn(c)
    if eob:
        q.end_with_eob()
