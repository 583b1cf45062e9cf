"""Device LZ77 match finder + fully parallel parse.

Data-parallel re-design of the reference's hash-chain matcher
(`De.Lz77`, de.ml:4013–4515: hash4 de.ml:4055–4071, `longest_match`
de.ml:4110–4174, lazy matching de.ml:4351–4410) and of `De.Def.Ns`'s
libdeflate-style matchfinder (de.ml:3111–3124, 3775–3826).  Nothing is
byte-serial:

* **hash4 of every position at once** — one vectorized multiply/shift.
* **candidates via sorted buckets** — sorting ``(hash, pos)`` makes each
  position's K most recent same-hash predecessors its K sorted
  neighbours: the candidate set of a depth-K hash chain, found with
  shifts instead of pointer chasing.
* **fingerprint pyramid** — rolling fingerprints of 4/8/16/…/256-byte
  spans built gather-free by doubling (``F_2L[i] = mix(F_L[i],
  F_L[i+L])``).  Candidates are scored with two probes (exact 4-byte
  word + 16-byte fingerprint) and the winner's length is resolved by a
  doubling LCP descent — O(log MAX_MATCH) probes instead of a linear
  byte scan.
* **exact verification pass** — fingerprints can (rarely) overestimate
  a length; a single vectorized pass re-checks every *selected* match
  byte-exactly (compare each covered byte against its source via one
  gather), and the whole segment falls back to the exact slow config if
  anything fails, so emitted streams are always byte-correct.
* **small-distance candidates via associative scans** — run lengths of
  ``data[i] == data[i-d]`` for d ∈ {1,2,3,4} give exact lengths for
  RLE-like matches with no gathers (the reference's `fill2` dist-1
  fast path, de.ml:186–205).
* **greedy+lazy parse by a gather-only segment-tree walk** over a
  payload-sized power-of-two domain — O(log n) rounds of pure gathers,
  no scatters, no sequential walk.

The 32 KiB history prefix of each segment carries cross-segment match
context (window parity with the reference's sliding window,
de.ml:4268–4342) while keeping segments embarrassingly parallel.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..core import tables
from . import codes

HIST = 32768          # history prefix per segment (DEFLATE window)
MIN_MATCH = 3
MAX_MATCH = 258
TOO_FAR = 4096        # don't take length-3 matches farther than this (de.ml:4054)
HASH_BITS = 15


@dataclass(frozen=True)
class LevelConfig:
    """Per-level tuning, the analogue of de.ml:4021–4049's configuration."""

    k_candidates: int   # sorted-bucket candidates (hash-chain depth)
    lazy: bool          # one-step lazy matching
    exact: bool = False  # exact linear extension (fallback / max quality)
    two_round: bool = False  # cost-aware re-parse with round-A code lengths
    full_ladder: bool = True  # 13-probe length-floor grading (speed knob)
    runs: bool = True    # exact small-distance (RLE) candidates
    top2: bool = False   # descend the two best candidates, pick by length
    mine: bool = True    # round-B hot-stride mining (two_round only)
    hash3: bool = False  # 3-byte-hash pass for pure len-3 matches
    # (only worth it with the two-round exact-cost parse: the greedy
    # parse overpays for len-3 matches on text)


#: Per-level candidate depth (de.ml:4021–4049's configuration ladder).
#: Rank-space probing makes K cheap, so depths run much deeper than
#: classic zlib chains.
LEVELS: dict[int, LevelConfig] = {
    1: LevelConfig(4, False, full_ladder=False),
    2: LevelConfig(6, False, full_ladder=False),
    3: LevelConfig(8, False, full_ladder=False),
    4: LevelConfig(8, True, full_ladder=False),
    # the DEFAULT level gets the two-round exact-cost re-parse, and
    # with exact costs the hash3 len-3 pass pays at level 6 too (greedy
    # overpays for len-3 on text): level-6 aggregate 1.0062x -> 0.9995x
    # zlib-6 over the corpus (scripts/level6_ratio.py)
    5: LevelConfig(12, True, two_round=True),
    6: LevelConfig(16, True, two_round=True, hash3=True),
    7: LevelConfig(24, True, two_round=True, top2=True, hash3=True),
    8: LevelConfig(32, True, two_round=True, top2=True, hash3=True),
    # level 9 relies on the same fingerprint descent (the verification
    # pass makes it exact regardless); deeper candidate search instead
    # of the 2x-slower linear extension
    9: LevelConfig(64, True, two_round=True, top2=True, hash3=True),
    # levels 10–12: the reference Ns level table accepts them
    # (de.ml:3929–3943, near_optimal slots; its lazy path is a stub) —
    # here they map onto deeper candidate search, which rank-space
    # probing makes nearly free
    10: LevelConfig(64, True, two_round=True, top2=True, hash3=True),
    11: LevelConfig(96, True, two_round=True, top2=True, hash3=True),
    12: LevelConfig(128, True, two_round=True, top2=True, hash3=True),
    # strategy slots (zlib parity beyond the reference): Z_RLE-style
    # (distance<=4 matches only) and Z_HUFFMAN_ONLY (no matches at all)
    100: LevelConfig(0, False, full_ladder=False),            # rle
    101: LevelConfig(0, False, full_ladder=False, runs=False),  # huffman-only
}


def _descent_mode() -> str:
    """LCP-descent strategy: "rec" (DEFAULT — one exact 64-byte tail
    compare per candidate via a [T,16] record row gather; collision-free
    past the floor), "compact" (fingerprint span rounds over the
    compacted floor>=16 subset) or "full" (span rounds over every
    payload position).  compact/full are bit-identical; rec differs
    from them only where a descent fingerprint would have collided
    (the exact compare then yields the true length directly).  Read at
    trace time — sweep across processes via DECOMPRESS_TPU_DESCENT."""
    import os

    return os.environ.get("DECOMPRESS_TPU_DESCENT", "rec")


def _ceil_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _u32_words(b: jnp.ndarray) -> jnp.ndarray:
    """4-byte little-endian word starting at every position (wraps at end;
    the wrap region is masked out by validity clamps downstream)."""
    b = b.astype(jnp.uint32)
    return (
        b
        | jnp.roll(b, -1) << 8
        | jnp.roll(b, -2) << 16
        | jnp.roll(b, -3) << 24
    )


def _prefix_bytes_equal(x: jnp.ndarray) -> jnp.ndarray:
    """Number of equal low-order bytes given xor of two 4-byte words (0..4)."""
    return (
        (x == 0).astype(jnp.int32) * 4
        + ((x != 0) & ((x & 0xFF) == 0)).astype(jnp.int32)
        + ((x != 0) & ((x & 0xFFFF) == 0)).astype(jnp.int32)
        + ((x != 0) & ((x & 0xFFFFFF) == 0)).astype(jnp.int32)
    )


def _mix(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Combine two span fingerprints into the double-span fingerprint."""
    h = a ^ ((b << 13) | (b >> 19))
    return h * jnp.uint32(2654435761)


#: fingerprint span lengths (powers of two up to MAX_MATCH)
_FP_SPANS = (4, 8, 16, 32, 64, 128, 256)


def _fingerprints(w: jnp.ndarray) -> dict[int, jnp.ndarray]:
    """F[L][i] = fingerprint of bytes [i, i+L); F[4] is the exact word.

    Built by doubling with static rolls only — no gathers.

    The doubling chain starts from a MULTIPLIED copy of the word, not
    the raw word: ``_mix(a, b) = (a ^ rotl13(b)) * M`` over raw words
    cancels whenever two single-byte diffs sit exactly 13 bit positions
    apart (measured in the wild: "C-33…%N 9" vs "C-23…%N 1" collided at
    span 32 — '3'^'2'=0x01 at +1 byte, '9'^'1'=0x08 at +7, and
    rotl13(0x08000000) == 0x0100).  Multiplying first diffuses a byte
    diff across the high bits, restoring ~2^-32 collision odds; F[4]
    stays the exact raw word (probes and refine rely on it)."""
    fp = {4: w}
    cur = w * jnp.uint32(2246822519)
    for span in _FP_SPANS[1:]:
        cur = _mix(cur, jnp.roll(cur, -(span // 2)))
        fp[span] = cur
    return fp


def _run_length_scan(eq: jnp.ndarray) -> jnp.ndarray:
    """r[i] = length of the run of True starting at i (suffix scan)."""
    return _run_length_scan_multi(eq[None, :])[0]


def _run_length_scan_multi(eqs: jnp.ndarray) -> jnp.ndarray:
    """Batched suffix run-length scan: eqs bool[D, T] -> int32[D, T]
    where out[d, i] = length of the True run starting at i.

    Monoid over original order (A before B): run(AB) = A.full ?
    A.run + B.run : A.run; one reverse associative scan over the last
    axis, no materialized array flips.
    """
    x = eqs.astype(jnp.int32)

    def combine(a, b):
        # reverse=True flips the sequence, so `b` is the segment that
        # comes FIRST in original order
        run_a, full_a = a
        run_b, full_b = b
        return run_b + jnp.where(full_b, run_a, 0), full_a & full_b

    run, _ = jax.lax.associative_scan(combine, (x, eqs), axis=1, reverse=True)
    return run


def _shift_prev(a: jnp.ndarray, k: int, fill) -> jnp.ndarray:
    """a shifted right by k along axis 0 (previous-rank neighbour)."""
    return jnp.concatenate([jnp.full(k, fill, a.dtype), a[: a.shape[0] - k]])


def _match_candidates(data_u8, valid_lo, valid_hi, cfg: LevelConfig,
                      max_dist: int = tables.WINDOW_SIZE, hist: int = HIST):
    """Best match (length, dist) at every *payload* position of one
    segment.

    data_u8: uint8[T] (T = HIST + seg_len); valid data occupies
    [valid_lo, valid_hi).  Returns (length int32[seg_len], dist
    int32[seg_len]) covering positions [HIST, T); length < MIN_MATCH
    means no match.  Lengths from fingerprint descent may overestimate
    on fingerprint collision — callers run the exact verification pass.

    Candidate probing happens in **rank space**: after sorting
    ``(hash, pos)``, a position's K most recent same-hash predecessors
    are its K previous sorted rows, so the probe values (exact 4-byte
    word, second word, 16-byte fingerprint) are *static shifts* of the
    three sorted probe arrays — three [T] gathers total instead of
    three [T, K] gathers (the dominant gather volume of the analyze
    graph).  Only the per-position winner is scattered back to
    position space.
    """
    t = data_u8.shape[0]
    seg_len = t - hist
    w = _u32_words(data_u8)
    fp = _fingerprints(w)

    h = ((w * jnp.uint32(2654435761)) >> jnp.uint32(32 - HASH_BITS)).astype(jnp.int32)

    # ---- sorted-bucket candidates (depth-K hash chain equivalent) ----
    pos = jnp.arange(t, dtype=jnp.int32)
    if t <= 1 << 17 and HASH_BITS + 17 <= 32:
        # hash and position pack into ONE uint32 key (h:15 | pos:17) —
        # a single-operand sort is measurably cheaper than the 2-key
        # form, and order is identical (equal hash -> ascending pos)
        packed_key = (h.astype(jnp.uint32) << 17) | pos.astype(jnp.uint32)
        skey = jax.lax.sort(packed_key)
        sp = (skey & ((1 << 17) - 1)).astype(jnp.int32)
        sh = (skey >> 17).astype(jnp.int32)
    else:
        sh, sp = jax.lax.sort((h, pos), num_keys=2)
    # rank-space probe values: offset fingerprints (span S at byte
    # offset O probes bytes [O, O+S)) refine the grade ladder between
    # the power-of-two spans.  All probe fields are fetched by ONE
    # row gather of a [T, R] record instead of one gather per field.
    if cfg.full_ladder:
        # ladder probes are pure equality tests, so pack PAIRS as
        # 16-bit hashes in one uint32: halves the record width for a
        # 1.5e-5 collision rate that the exact verification pass
        # already covers
        def h16(x):
            return (x * jnp.uint32(2654435761)) >> jnp.uint32(16)

        def pack2(a, b):
            return (h16(a) << 16) | h16(b)

        # hi half of p6: bytes [192, 224) — the 224 rung caps the
        # ladder's top inter-rung gap at 34, so the descent needs no
        # 64-span; lo half: bytes [128, 192)
        fields = (
            w, jnp.roll(w, -4), fp[16],
            pack2(jnp.roll(w, -6), jnp.roll(fp[8], -4)),
            pack2(jnp.roll(w, -10), jnp.roll(w, -16)),
            pack2(jnp.roll(fp[16], -8), fp[32]),
            pack2(jnp.roll(fp[16], -32), fp[64]),
            pack2(jnp.roll(fp[32], -64), fp[128]),
            pack2(jnp.roll(fp[32], -192), jnp.roll(fp[64], -128)),
        )
    else:
        # short ladder (fast levels): exact words + one 16 and one
        # 64-byte fingerprint
        fields = (w, jnp.roll(w, -4), fp[16], fp[64])
    rec_s = jnp.stack(fields, axis=1)[sp]      # [t, R]: ONE row gather
    cols = tuple(rec_s[:, i] for i in range(len(fields)))
    w_s, w4_s, f16_s = cols[:3]
    extra_probes = cols[3:]
    if cfg.full_ladder:
        p1, p2, p3, p4, p5, p6 = extra_probes
    else:
        (f64_s,) = extra_probes

    sp_ok = sp < valid_hi
    neg_inf = jnp.int32(-(1 << 30))
    kmax = cfg.k_candidates
    # pad every probe array with kmax leading fill values so the k-shift
    # becomes a dynamic slice; the probe loop is a lax.scan over k, so
    # the traced body is emitted ONCE (compile time independent of K —
    # the unrolled form took >14 min to compile at K=16 with the full
    # grade ladder)
    probes = (w_s, w4_s, f16_s) + extra_probes
    probes_pad = tuple(
        jnp.concatenate([jnp.zeros(kmax, jnp.uint32), a]) for a in probes
    )
    sp_pad = jnp.concatenate([jnp.full(kmax, -1, jnp.int32), sp])
    sh_pad = jnp.concatenate([jnp.full(kmax, -1, jnp.int32), sh])

    def probe_step(carry, k):
        if cfg.top2:
            best_score, best_cand, best_p4, score2, cand2, p42 = carry
        else:
            best_score, best_cand, best_p4 = carry

        def shifted(a_pad):
            return jax.lax.dynamic_slice(a_pad, (kmax - k,), (t,))

        cand_p = shifted(sp_pad)
        cand_h = shifted(sh_pad)
        shifted_probes = [shifted(a) for a in probes_pad]
        w_k, w4_k, f16_k = shifted_probes[:3]
        dist = sp - cand_p
        ok = (
            (cand_p >= 0)
            & (cand_h == sh)
            & (dist <= max_dist)
            & (cand_p >= valid_lo)
            & (cand_p < valid_hi)
            & sp_ok
        )
        x4 = w_k ^ w_s
        plen4 = _prefix_bytes_equal(x4)
        len4 = (x4 == 0) & ok
        # second exact word: precise grading over the 4..8-byte range
        # where most text matches live
        x8 = w4_k ^ w4_s
        plen8 = jnp.where(len4, _prefix_bytes_equal(x8), 0)
        len8 = len4 & (x8 == 0)
        if cfg.full_ladder:
            # length-floor ladder: chained power-of-two and offset
            # fingerprints give fine resolution where matches are
            # common (8..32) and coarser beyond; weights are floor
            # deltas, so the grade stays a monotone proxy of the
            # guaranteed match length.  Probe pairs live in 16-bit
            # halves of the packed arrays.
            p1_k, p2_k, p3_k, p4_k, p5_k, p6_k = shifted_probes[3:]
            hi = jnp.uint32(0xFFFF0000)
            lo = jnp.uint32(0x0000FFFF)
            eq10 = (((p1_k ^ p1) & hi) == 0) & len8
            eq12 = (((p1_k ^ p1) & lo) == 0) & eq10
            eq14 = (((p2_k ^ p2) & hi) == 0) & eq12
            eq16 = (f16_k == f16_s) & eq14
            eq20 = (((p2_k ^ p2) & lo) == 0) & eq16
            eq24 = (((p3_k ^ p3) & hi) == 0) & eq20
            eq32 = (((p3_k ^ p3) & lo) == 0) & eq24
            eq48 = (((p4_k ^ p4) & hi) == 0) & eq32
            eq64 = (((p4_k ^ p4) & lo) == 0) & eq48
            eq96 = (((p5_k ^ p5) & hi) == 0) & eq64
            eq128 = (((p5_k ^ p5) & lo) == 0) & eq96
            eq192 = (((p6_k ^ p6) & lo) == 0) & eq128
            eq224 = (((p6_k ^ p6) & hi) == 0) & eq192
            grade = (
                jnp.where(ok, plen4, 0)
                + plen8
                + jnp.where(eq10, 2, 0)
                + jnp.where(eq12, 2, 0)
                + jnp.where(eq14, 2, 0)
                + jnp.where(eq16, 2, 0)
                + jnp.where(eq20, 4, 0)
                + jnp.where(eq24, 4, 0)
                + jnp.where(eq32, 8, 0)
                + jnp.where(eq48, 16, 0)
                + jnp.where(eq64, 16, 0)
                + jnp.where(eq96, 32, 0)
                + jnp.where(eq128, 32, 0)
                + jnp.where(eq192, 64, 0)
                + jnp.where(eq224, 32, 0)
            )
        else:
            (f64_k,) = shifted_probes[3:]
            eq16 = (f16_k == f16_s) & len8
            eq64 = (f64_k == f64_s) & eq16
            grade = (
                jnp.where(ok, plen4, 0)
                + plen8
                + jnp.where(eq16, 8, 0)
                + jnp.where(eq64, 48, 0)
            )
        usable = ok & (plen4 >= 3)
        score = jnp.where(usable, (grade << 17) - dist, neg_inf)
        better = score > best_score  # first max wins: argmax parity
        if cfg.top2:
            b2 = ~better & (score > score2)
            return (
                jnp.where(better, score, best_score),
                jnp.where(better, cand_p, best_cand),
                jnp.where(better, plen4, best_p4),
                jnp.where(better, best_score, jnp.where(b2, score, score2)),
                jnp.where(better, best_cand, jnp.where(b2, cand_p, cand2)),
                jnp.where(better, best_p4, jnp.where(b2, plen4, p42)),
            ), None
        return (
            jnp.where(better, score, best_score),
            jnp.where(better, cand_p, best_cand),
            jnp.where(better, plen4, best_p4),
        ), None

    # carry init derives from sp so it inherits the varying manual axes
    # under shard_map (cf. the parse scan)
    if cfg.top2:
        (best_score, best_cand, best_p4, score2_r, cand2_r, p42_r), _ = \
            jax.lax.scan(
                probe_step,
                (sp * 0 + neg_inf, sp * 0, sp * 0,
                 sp * 0 + neg_inf, sp * 0, sp * 0),
                jnp.arange(1, kmax + 1, dtype=jnp.int32),
            )
    else:
        (best_score, best_cand, best_p4), _ = jax.lax.scan(
            probe_step,
            (sp * 0 + neg_inf, sp * 0, sp * 0),
            jnp.arange(1, kmax + 1, dtype=jnp.int32),
        )

    # winner back to position space: one packed scatter.  The ladder
    # grade is a TRUE length floor (equal bytes imply equal
    # fingerprints, so rungs never false-negative) — pack it along so
    # the descent can START at the floor and skip the big spans.
    btier_r = jnp.where(best_p4 >= 4, 2, 1)  # 1 = exactly-3-byte candidate
    has_r = best_score > neg_inf
    # score = (grade << 17) - dist  =>  grade = (score + dist) >> 17
    grade_r = jnp.clip(
        (best_score + (sp - best_cand)) >> 17, 0, MAX_MATCH)
    floor_r = jnp.where(has_r, grade_r, 0)
    packed_r = (
        (jnp.maximum(best_cand, 0) << 12)
        | (floor_r << 3)
        | (btier_r << 1)
        | has_r.astype(jnp.int32)
    )
    packed = (
        jnp.zeros(t, jnp.int32).at[sp].set(packed_r, unique_indices=True)
    )[hist:]
    has = (packed & 1) == 1
    btier = (packed >> 1) & 3
    bfloor = (packed >> 3) & 0x1FF
    bcand = packed >> 12
    pos_pay = jnp.arange(seg_len, dtype=jnp.int32) + hist
    bdist = pos_pay - bcand
    bsafe = jnp.where(has, bcand, 0)
    if cfg.top2:
        grade2_r = jnp.clip(
            (score2_r + (sp - cand2_r)) >> 17, 0, MAX_MATCH)
        has2_r = score2_r > neg_inf
        packed2_r = (
            (jnp.maximum(cand2_r, 0) << 12)
            | (jnp.where(has2_r, grade2_r, 0) << 3)
            | (jnp.where(p42_r >= 4, 2, 1) << 1)
            | has2_r.astype(jnp.int32)
        )
        packed2 = (
            jnp.zeros(t, jnp.int32).at[sp].set(packed2_r, unique_indices=True)
        )[hist:]
        has2 = (packed2 & 1) == 1
        btier2 = (packed2 >> 1) & 3
        bfloor2 = (packed2 >> 3) & 0x1FF
        bcand2 = packed2 >> 12
        bdist2 = pos_pay - bcand2
        bsafe2 = jnp.where(has2, bcand2, 0)

    runs = None
    if cfg.runs:
        # exact small-distance (RLE-ish) run lengths via one batched
        # suffix scan over all four distances (payload only) — computed
        # before the descent so the compacted descent can exclude
        # positions the runs pass settles anyway
        small_d = (1, 2, 3, 4)
        eqs = jnp.stack(
            [(data_u8 == jnp.roll(data_u8, d))[hist:] for d in small_d]
        )
        runs = _run_length_scan_multi(eqs)

    if cfg.exact:
        # exact linear extension in 4-byte steps (level 9 / fallback)
        length = jnp.zeros(seg_len, jnp.int32)
        alive = has
        for off in range(0, MAX_MATCH + 4, 4):
            gj = w[jnp.minimum(bsafe + off, t - 1)]
            wj = w[jnp.minimum(pos_pay + off, t - 1)]
            eq = _prefix_bytes_equal(gj ^ wj)
            length = length + jnp.where(alive, eq, 0)
            alive = alive & (eq == 4)
    else:
        # doubling LCP descent over the fingerprint pyramid, STARTING
        # AT THE LADDER FLOOR: rungs never false-negative, so the
        # winner's graded floor is a guaranteed prefix and the next
        # rung a guaranteed ceiling — only the inter-rung gap needs
        # resolving.  The largest full-ladder gap is 34 (224 -> 258),
        # so spans stop at 32 (the short fast-level ladder has a
        # 64 -> 258 gap and keeps span 128).  Spans 4 and the final
        # refine are exact; larger spans are fingerprints (the exact
        # verification pass backstops collisions, as before).
        spans = (32, 16, 8, 4) if cfg.full_ladder else (128, 64, 32, 16, 8, 4)

        def _span_walk(bsafe_d, pos_d, live, length):
            for span in spans:
                idx_c = jnp.minimum(bsafe_d + length, t - 1)
                idx_i = jnp.minimum(pos_d + length, t - 1)
                f = fp[span]
                eq = (f[idx_c] == f[idx_i]) & live & (
                    length + span <= MAX_MATCH + 4)
                length = length + jnp.where(eq, span, 0)
            return length

        def _refine(bsafe_d, has_d, btier_d, length):
            # final 0..3 byte refine with the exact word
            idx_c = jnp.minimum(bsafe_d + length, t - 1)
            idx_i = jnp.minimum(pos_pay + length, t - 1)
            rem = _prefix_bytes_equal(w[idx_c] ^ w[idx_i])
            length = length + jnp.where(has_d, jnp.minimum(rem, 3), 0)
            # tier-1 candidates matched only 3 bytes
            length = jnp.where(has_d & (btier_d == 1) & (length < 3), 3, length)
            return jnp.where(has_d, length, 0)

        def descend(bsafe_d, has_d, btier_d, floor_d):
            length = jnp.where(has_d, floor_d, 0)
            if cfg.full_ladder and _descent_mode() == "rec":
                # EXACT 64-byte tail compare, one record row gather per
                # side: the full ladder's inter-rung gaps are <= 63
                # bytes (the failed next rung bounds the true length),
                # so the 16-word record starting at the floor resolves
                # the whole extension byte-exactly — no fingerprint
                # span walk, no 0..3 refine, no compaction machinery,
                # and no descent-side collision class at all: one [T,16]
                # record row gather where the span walk paid ~10
                # gathered elements.
                # Floors themselves can still overestimate on a LADDER
                # collision; the verify pass + trim loop cover that,
                # as before.
                rec64 = jnp.stack(
                    [jnp.roll(w, -(4 * j)) for j in range(16)], axis=1)
                idx_c = jnp.minimum(bsafe_d + length, t - 1)
                idx_i = jnp.minimum(pos_pay + length, t - 1)
                x = rec64[idx_c] ^ rec64[idx_i]          # [seg_len, 16]
                pb = _prefix_bytes_equal(x)              # 4 iff word equal
                miss = (x != 0).astype(jnp.int32)
                allprev = (jnp.cumsum(miss, axis=1) - miss) == 0
                lcp = jnp.sum(jnp.where(allprev, pb, 0), axis=1)
                return jnp.where(has_d, length + lcp, 0)
            if (cfg.full_ladder and seg_len >= 4096
                    and _descent_mode() == "compact"):
                # Compaction-by-floor-class, BIT-IDENTICAL to the full
                # walk: a full-ladder floor < 16 sits at most 2 below
                # its guaranteed ceiling (the 10/12/14/16 rungs are 2
                # apart and plen4+plen8 are byte-exact below 8), so the
                # 0..3-byte refine alone resolves it — the four span
                # rounds matter only for floors >= 16 (a small minority
                # on typical data: book1 0.5%, obj2 18%, trans 42%,
                # pic 77% measured).  Needy positions compact into
                # seg_len/4-slot batches via one cumsum-rank scatter; a
                # fori_loop walks ceil(count/m_cap) <= 4 batches, so
                # even all-needy segments resolve exactly (typical data
                # runs one batch; span gathers touch m_cap elements
                # instead of seg_len).  Positions whose dist-1 run
                # already spans MAX_MATCH are excluded: the runs pass
                # emits (258, 1) for them and wins (or ties with the
                # identical pair) against any descent result, so the
                # final merge is provably unchanged — this keeps
                # run-dominated inputs (pic) at one batch.
                m_cap = -(-seg_len // 4)  # ceil: 4 batches always cover
                need = has_d & (floor_d >= 16)
                if runs is not None:
                    run1_ok = (pos_pay - 1 >= valid_lo) & (pos_pay < valid_hi)
                    need = need & ~(run1_ok & (runs[0] >= MAX_MATCH))
                rank = jnp.cumsum(need.astype(jnp.int32)) - 1
                count = jnp.sum(need.astype(jnp.int32))
                # buffer padded to 4*m_cap so batch slices never clamp
                cidx_all = jnp.zeros(4 * m_cap, jnp.int32).at[
                    jnp.where(need, rank, 4 * m_cap)
                ].set(jnp.arange(seg_len, dtype=jnp.int32), mode="drop")
                nb = (count + m_cap - 1) // m_cap

                def one_batch(i, ln):
                    cidx = jax.lax.dynamic_slice(cidx_all, (i * m_cap,),
                                                 (m_cap,))
                    gslot = i * m_cap + jnp.arange(m_cap, dtype=jnp.int32)
                    cvalid = gslot < count
                    ln_c = _span_walk(bsafe_d[cidx], cidx + hist, cvalid,
                                      floor_d[cidx])
                    return ln.at[jnp.where(cvalid, cidx, seg_len)].set(
                        ln_c, mode="drop")

                length = jax.lax.fori_loop(0, nb, one_batch, length)
            else:
                length = _span_walk(bsafe_d, pos_pay, has_d, length)
            return _refine(bsafe_d, has_d, btier_d, length)

        length = descend(bsafe, has, btier, bfloor)
        if cfg.top2:
            # resolve the runner-up exactly too and keep the longer
            # (ties -> nearer): removes within-floor grade misranking
            length2 = descend(bsafe2, has2, btier2, bfloor2)
            take2 = (length2 > length) | ((length2 == length) & (bdist2 < bdist))
            length = jnp.where(take2, length2, length)
            bdist = jnp.where(take2, bdist2, bdist)

    if cfg.runs:
        # ---- merge the exact small-distance (RLE-ish) candidates
        # (runs computed above, before the descent) ----
        for di, d in enumerate(small_d):
            src_ok = (pos_pay - d >= valid_lo) & (pos_pay < valid_hi)
            len_d = jnp.where(src_ok, jnp.minimum(runs[di], MAX_MATCH), 0)
            better = (len_d > length) | ((len_d == length) & (d < bdist))
            bdist = jnp.where(better, d, bdist)
            length = jnp.where(better, len_d, length)

    if cfg.hash3:
        # ---- pure length-3 matches via a 3-byte hash (zlib's ins_h
        # covers exactly MIN_MATCH bytes, so it finds matches whose
        # 4th byte differs; the 4-byte bucket hash cannot).  The
        # nearest same-3-byte predecessor is located in rank space
        # (1 extra sort + 1 probe gather), compared EXACTLY on the low
        # 24 bits, and used only where the main search found nothing —
        # the cost-aware parse decides whether a len-3 match beats
        # three literals.  obj-class binaries are where this matters
        # (zlib-9 emits ~20x more len-3 matches there than the
        # 4-byte-hash search can see). ----
        w3 = w & jnp.uint32(0xFFFFFF)
        h3 = ((w3 * jnp.uint32(2654435761)) >>
              jnp.uint32(32 - HASH_BITS)).astype(jnp.int32)
        if t <= 1 << 17 and HASH_BITS + 17 <= 32:
            k3p = (h3.astype(jnp.uint32) << 17) | pos.astype(jnp.uint32)
            sk3 = jax.lax.sort(k3p)
            sp3 = (sk3 & ((1 << 17) - 1)).astype(jnp.int32)
            sh3 = (sk3 >> 17).astype(jnp.int32)
        else:
            sh3, sp3 = jax.lax.sort((h3, pos), num_keys=2)
        w3_s = w3[sp3]
        sp3_ok = sp3 < valid_hi
        k3 = 2
        best3 = jnp.full(t, -1, jnp.int32)
        for k in range(1, k3 + 1):
            cand_p = _shift_prev(sp3, k, -1)
            cand_h = _shift_prev(sh3, k, -1)
            cand_w = _shift_prev(w3_s, k, jnp.uint32(0))
            ok3 = (
                (cand_p >= 0) & (cand_h == sh3) & (cand_w == w3_s)
                & (sp3 - cand_p <= min(TOO_FAR, max_dist))
                & (cand_p >= valid_lo) & (cand_p < valid_hi) & sp3_ok
            )
            best3 = jnp.where(ok3 & (best3 < 0), cand_p, best3)
        cand3 = (
            jnp.full(t, -1, jnp.int32).at[sp3].set(best3, unique_indices=True)
        )[hist:]
        use3 = (length < MIN_MATCH) & (cand3 >= 0)
        d3 = pos_pay - cand3
        length = jnp.where(use3, MIN_MATCH, length)
        bdist = jnp.where(use3, d3, bdist)

    # clamp to data end and legality
    length = jnp.minimum(length, MAX_MATCH)
    length = jnp.minimum(length, jnp.maximum(valid_hi - pos_pay, 0))
    too_far = (length == MIN_MATCH) & (bdist > TOO_FAR)
    length = jnp.where(too_far, 0, length)
    length = jnp.where(length >= MIN_MATCH, length, 0)
    return length, bdist


def _mark_path(g: jnp.ndarray, levels: int) -> jnp.ndarray:
    """Positions visited by iterating the strictly increasing jump ``g``
    from 0: gather-only exit/entry tables over 2^k blocks.

    g: int32[P] with P = 2^levels, i < g[i] <= P.  Returns bool[P].
    The value P ("walked off the end") is a natural fixed point of every
    pass (every gather is index-clamped behind a >=-block-end guard), so
    the domain only needs to cover the positions themselves, not the
    maximum jump overshoot.
    """
    p = g.shape[0]
    idx = jnp.arange(p, dtype=jnp.int32)
    exits = [g]
    for k in range(1, levels + 1):
        prev = exits[-1]
        end_k = ((idx >> k) + 1) << k
        e1 = prev
        exits.append(jnp.where(e1 >= end_k, e1, prev[jnp.minimum(e1, p - 1)]))
    # top-down entry values: first walk value >= start of i's level-k block
    entry = jnp.zeros(p, jnp.int32)
    for k in range(levels - 1, -1, -1):
        blk = idx >> k
        is_right = (blk & 1) == 1
        mid = blk << k  # start of i's own level-k block
        stepped = exits[k][jnp.minimum(entry, p - 1)]
        entry = jnp.where(is_right & (entry < mid), stepped, entry)
    return entry == idx


#: exact-distance histogram width for hot-stride mining (round B)
HOT_DIST_BINS = 4096
#: strided-run candidates mined per segment in round B
HOT_DISTS = 8

#: hybrid-parse block size exponent (block = 2**_PARSE_C positions):
#: every level below the scan saves two full-domain gather passes, at
#: the price of a longer sequential block scan.
import os as _os

_PARSE_C = int(_os.environ.get("DECOMPRESS_TPU_PARSE_C", "4"))


def _mark_path_hybrid(g: jnp.ndarray, levels: int, c: int = _PARSE_C) -> jnp.ndarray:
    """Same result as :func:`_mark_path`, with fewer gather passes.

    Pointer-doubling exit tables are built only up to 2^c-sized blocks
    (``c`` full-domain gather passes instead of ``levels``); the walk
    across blocks is then resolved by one `lax.scan` over P/2^c blocks
    (a single dynamic gather per step — sequential but tiny), and the
    per-position entry refinement runs top-down only over the ``c``
    fine levels.  Full-domain gather passes drop from 2*levels to ~2*c.
    """
    if levels <= c:
        return _mark_path(g, levels)
    p = g.shape[0]
    cs = 1 << c
    nblocks = p >> c
    idx = jnp.arange(p, dtype=jnp.int32)
    exits = [g]
    for k in range(1, c + 1):
        prev = exits[-1]
        end_k = ((idx >> k) + 1) << k
        e1 = prev
        exits.append(jnp.where(e1 >= end_k, e1, prev[jnp.minimum(e1, p - 1)]))
    exit_c = exits[c]

    # coarse walk over 2^c blocks: carry = first walk value >= block start
    def blk_step(w, j):
        entry_j = w
        in_blk = w < (j + 1) << c
        w = jnp.where(in_blk, exit_c[jnp.minimum(w, p - 1)], w)
        return w, entry_j

    # carry init derives from g so it inherits g's varying manual axes
    # (plain jnp.int32(0) breaks lax.scan under shard_map)
    _, block_entry = jax.lax.scan(
        blk_step, g[0] * 0, jnp.arange(nblocks, dtype=jnp.int32)
    )

    # fine top-down refinement within each 2^c block
    entry = block_entry[idx >> c]
    for k in range(c - 1, -1, -1):
        blk = idx >> k
        is_right = (blk & 1) == 1
        mid = blk << k
        stepped = exits[k][jnp.minimum(entry, p - 1)]
        entry = jnp.where(is_right & (entry < mid), stepped, entry)
    return entry == idx


def _verify_matches(data_u8, on_path, is_match, length, dist, seg_len, n,
                    hist: int = HIST):
    """Exact check of every selected match: each covered byte must equal
    its source byte.  Returns True iff the whole segment is exact.

    Interval trick: matches never overlap (the parse is a partition),
    so the covering match of payload position j is the one whose start
    is the running maximum of match starts at or before j.  The match's
    (length, dist) ride along INSIDE the cummax words (start in the
    high bits dominates the ordering), so no full-domain gather is
    needed to fetch them — only the one unavoidable source-byte gather.
    """
    posn = jnp.arange(seg_len, dtype=jnp.int32)
    if seg_len <= 1 << 17:
        # (start+1) << 9 | length fits uint32 for seg_len <= 2^17
        # (start+1 <= 2^17, length <= 258 < 2^9); zero = "no match yet".
        c1 = jax.lax.cummax(
            jnp.where(is_match, ((posn + 1) << 9) | length, 0)
            .astype(jnp.uint32)
        ).astype(jnp.int32)
        cov_start = (c1 >> 9) - 1
        cov_len = c1 & 0x1FF
        # start << 15 | (dist-1): same running-max selection (start
        # dominates); dist-1 <= 32767 in 15 bits keeps start's 17 bits.
        c2 = jax.lax.cummax(
            jnp.where(is_match, (posn << 15) | (dist - 1), 0)
            .astype(jnp.uint32)
        ).astype(jnp.int32)
        cov_dist = (c2 & 0x7FFF) + 1
        covered = (c1 > 0) & (posn < cov_start + cov_len) & (posn < n)
    else:
        # larger segments: the packed words overflow 32 bits — fetch
        # (length, dist) with one full-domain gather instead
        start = jnp.where(is_match, posn, -1)
        cov_start = jax.lax.cummax(start)
        safe_start = jnp.maximum(cov_start, 0)
        cov = ((length << 16) | dist)[safe_start]
        cov_len = cov >> 16
        cov_dist = cov & 0xFFFF
        covered = (cov_start >= 0) & (posn < safe_start + cov_len) & (posn < n)
    payload = data_u8[hist : hist + seg_len]
    src_idx = jnp.maximum(hist + posn - cov_dist, 0)
    eq = payload == data_u8[src_idx]
    return jnp.all(jnp.where(covered, eq, True))


@functools.partial(jax.jit, static_argnames=("seg_len", "hist"))
def lz77_trim_candidates(data, is_match, length, dist, cand_length, cand_dist,
                         n_valid, *, seg_len: int, hist: int = HIST):
    """Surgically trim candidates the verification pass caught
    overestimating, instead of re-running the whole analysis with exact
    extension (which costs ~65 full-domain gather pairs).

    The covering-match machinery is :func:`_verify_matches`'s; here the
    per-position compare feeds a suffix-min of mismatch positions, so
    each SELECTED match learns its first mismatched byte and the
    candidate at its start is trimmed to the proven-equal prefix
    (bytes [s, fm) verified equal at the selected distance — the trim
    is exact by construction, never another fingerprint guess).
    Candidates falling under MIN_MATCH (or into the len-3 TOO_FAR rule)
    are dropped.  Only selected matches are checked, so callers loop
    trim -> re-parse until the verify passes (inexact candidates that
    were never selected cost nothing until a parse picks them)."""

    def one(seg, is_m, ln, dst, cl, cd, n):
        posn = jnp.arange(seg_len, dtype=jnp.int32)
        if seg_len <= 1 << 17:
            c1 = jax.lax.cummax(
                jnp.where(is_m, ((posn + 1) << 9) | ln, 0).astype(jnp.uint32)
            ).astype(jnp.int32)
            cov_start = (c1 >> 9) - 1
            cov_len = c1 & 0x1FF
            c2 = jax.lax.cummax(
                jnp.where(is_m, (posn << 15) | (dst - 1), 0).astype(jnp.uint32)
            ).astype(jnp.int32)
            cov_dist = (c2 & 0x7FFF) + 1
            covered = (c1 > 0) & (posn < cov_start + cov_len) & (posn < n)
        else:
            start = jnp.where(is_m, posn, -1)
            cov_start = jax.lax.cummax(start)
            safe_start = jnp.maximum(cov_start, 0)
            cov = ((ln << 16) | dst)[safe_start]
            cov_len = cov >> 16
            cov_dist = cov & 0xFFFF
            covered = (cov_start >= 0) & (posn < safe_start + cov_len) \
                & (posn < n)
        payload = seg[hist: hist + seg_len]
        src = seg[jnp.maximum(hist + posn - cov_dist, 0)]
        mism = covered & (payload != src)
        big = jnp.int32(1 << 22)
        fm = jax.lax.associative_scan(
            jnp.minimum, jnp.where(mism, posn, big), reverse=True)
        bad = is_m & (fm - posn < ln)
        cl2 = jnp.where(bad, jnp.minimum(cl, fm - posn), cl)
        cl2 = jnp.where(cl2 >= MIN_MATCH, cl2, 0)
        cl2 = jnp.where((cl2 == MIN_MATCH) & (cd > TOO_FAR), 0, cl2)
        return cl2

    return jax.vmap(one)(data, is_match, length, dist, cand_length,
                         cand_dist, n_valid)


@functools.partial(jax.jit, static_argnames=("seg_len", "hist", "lazy",
                                             "two_round"))
def lz77_reparse_greedy(data, cand_length, cand_dist, n_valid, *,
                        seg_len: int, hist: int = HIST, lazy: bool = True,
                        two_round: bool = False):
    """Greedy/lazy take-defer + parse over GIVEN candidates — the tail
    of :func:`lz77_analyze` without the match finding, for the
    trim-and-reparse retry loop."""
    p = _ceil_pow2(seg_len)
    levels = p.bit_length() - 1

    def one_pre(length, n):
        pay_idx = jnp.arange(seg_len, dtype=jnp.int32)
        length = jnp.where(pay_idx < n, length, 0)
        if lazy:
            nxt_len = jnp.concatenate([length[1:], jnp.zeros(1, jnp.int32)])
            defer = nxt_len > length
        else:
            defer = jnp.zeros(seg_len, bool)
        take = (length >= MIN_MATCH) & ~defer
        return take, length

    take, length = jax.vmap(one_pre)(cand_length, n_valid)
    on_path_full = _mark_batched(take, length, seg_len, p, levels)
    out = _summarize_batch(data, n_valid, take, length, cand_dist,
                           on_path_full, seg_len, hist)
    out["cand_length"] = length
    out["cand_dist"] = cand_dist
    if two_round:
        out["dist_counts"] = _dist_counts_batch(out["is_match"], out["dist"])
    return out


#: trim-and-reparse attempts before the force_exact sledgehammer
_TRIM_RETRIES = 3


def analyze(data, n_valid, hist_len, *, level: int, seg_len: int,
            window_bits: int = 15, hist: int = HIST):
    """Host wrapper around :func:`lz77_analyze` that repairs fingerprint
    overestimates (the verification pass reports them) with the cheap
    trim-and-reparse loop, falling back to the exact-extension re-run
    only if trims keep surfacing new collisions; results are therefore
    always byte-exact.

    ``window_bits`` (8..15) restricts match distances for small
    user-provided windows (make_window ~bits, de.ml:331-333)."""
    res = lz77_analyze(data, n_valid, hist_len, level=level, seg_len=seg_len,
                       window_bits=window_bits, hist=hist)
    cfg = LEVELS[level]
    if cfg.exact or bool(np.asarray(res["exact"]).all()):
        return res
    cl, cd = res["cand_length"], res["cand_dist"]
    for _ in range(_TRIM_RETRIES):
        cl = lz77_trim_candidates(data, res["is_match"], res["length"],
                                  res["dist"], cl, cd, n_valid,
                                  seg_len=seg_len, hist=hist)
        res = lz77_reparse_greedy(data, cl, cd, n_valid, seg_len=seg_len,
                                  hist=hist, lazy=cfg.lazy,
                                  two_round=cfg.two_round)
        if bool(np.asarray(res["exact"]).all()):
            return res
    return lz77_analyze(
        data, n_valid, hist_len, level=level, seg_len=seg_len,
        force_exact=True, window_bits=window_bits, hist=hist,
    )


@functools.partial(jax.jit, static_argnames=("level", "seg_len", "force_exact",
                                             "window_bits", "hist"))
def lz77_analyze(data, n_valid, hist_len, *, level: int, seg_len: int,
                 force_exact: bool = False, window_bits: int = 15,
                 hist: int = HIST):
    """Match-find + parse a batch of segments.

    data: uint8[B, HIST + seg_len] — 32 KiB history prefix then payload
    (zero padded); n_valid: int32[B] payload bytes; hist_len: int32[B]
    valid history bytes.
    Returns per-position arrays over the payload ([B, seg_len]):
    on_path, is_match, length, dist, histograms hist_lit[B, 286]
    (EOB not included), hist_dist[B, 30], and exact[B] (False means
    a fingerprint overestimated somewhere: re-run with the exact
    config — the de driver handles this).
    """
    cfg = LEVELS[level]
    if force_exact and not cfg.exact:
        import dataclasses

        cfg = dataclasses.replace(cfg, exact=True)
    t = hist + seg_len
    p = _ceil_pow2(seg_len)
    levels = p.bit_length() - 1

    def one_pre(seg, n, hl):
        valid_lo = hist - hl
        valid_hi = hist + n
        length, dist = _match_candidates(
            seg, valid_lo, valid_hi, cfg, max_dist=1 << window_bits,
            hist=hist,
        )

        # payload-domain arrays: position i here is absolute HIST + i
        pay_idx = jnp.arange(seg_len, dtype=jnp.int32)
        length = jnp.where(pay_idx < n, length, 0)

        if cfg.lazy:
            nxt_len = jnp.concatenate([length[1:], jnp.zeros(1, jnp.int32)])
            defer = nxt_len > length
        else:
            defer = jnp.zeros(seg_len, bool)
        take = (length >= MIN_MATCH) & ~defer
        return take, length, dist

    take, length, dist = jax.vmap(one_pre)(data, n_valid, hist_len)
    on_path_full = _mark_batched(take, length, seg_len, p, levels)
    out = _summarize_batch(data, n_valid, take, length, dist,
                           on_path_full, seg_len, hist)
    out["cand_length"] = length
    out["cand_dist"] = dist
    if cfg.two_round:
        # exact-distance histogram of the selected matches: round B
        # mines it for "hot" strided distances (structural periods
        # like image row strides) that the depth-K bucket search
        # cannot reach inside giant equal-content buckets
        out["dist_counts"] = _dist_counts_batch(out["is_match"], out["dist"])
    return out


def _dist_counts_batch(is_match, dist):
    """Per-segment exact-distance histograms of the selected matches
    (HOT_DIST_BINS bins, overflow clipped into the last one)."""

    def one(im, dd):
        md = jnp.where(im, dd, 0)
        return (
            jnp.zeros(HOT_DIST_BINS, jnp.int32)
            .at[jnp.clip(md, 0, HOT_DIST_BINS - 1)]
            .add(im.astype(jnp.int32), mode="drop")
        )

    return jax.vmap(one)(is_match, dist)


def _mark_batched(take, plen, seg_len, p, levels):
    """Batched jump-build + mark-path over [B, seg_len] take/step
    arrays -> on_path bool[B, P].

    The parse runs over the payload-only domain [0, P).  Jump values
    may reach P ("walked off the end") — match lengths are clamped to
    the valid payload upstream, so no target exceeds seg_len and the
    domain needs no MAX_MATCH overshoot padding (P = 2^17, not 2^18,
    for the production 128 KiB segments: half the full-domain gather
    volume)."""
    b = take.shape[0]
    step = jnp.where(take, plen, 1)
    gseg = jnp.minimum(jnp.arange(seg_len, dtype=jnp.int32)[None, :] + step, p)
    if p > seg_len:
        tail = jnp.minimum(
            jnp.arange(seg_len, p, dtype=jnp.int32) + 1, p)
        g2 = jnp.concatenate(
            [gseg, jnp.broadcast_to(tail[None, :], (b, p - seg_len))], axis=1)
    else:
        g2 = gseg
    return jax.vmap(lambda g: _mark_path_hybrid(g, levels))(g2)


def _summarize_one(seg, on_path_full, take, plen, dist, n, seg_len, hist):
    """Per-segment tail of the analyze passes: exact verification and
    symbol histograms over the marked parse."""
    t = hist + seg_len
    pay_idx = jnp.arange(seg_len, dtype=jnp.int32)
    on_path = on_path_full[:seg_len] & (pay_idx < n)
    is_match = on_path & take
    mlen = jnp.where(is_match, plen, 0)
    mdist = jnp.where(is_match, dist, 0)

    exact = _verify_matches(seg, on_path, is_match, mlen, mdist, seg_len, n,
                            hist=hist)

    lcode = codes.length_code(mlen)
    lit = seg[hist:t].astype(jnp.int32)
    sym = jnp.where(is_match, 257 + lcode, lit)
    emit = on_path.astype(jnp.int32)
    hist_lit = jnp.zeros(286, jnp.int32).at[sym].add(emit, mode="drop")
    dsym = codes.dist_code(mdist)
    hist_dist = (
        jnp.zeros(30, jnp.int32)
        .at[dsym]
        .add(is_match.astype(jnp.int32), mode="drop")
    )
    return dict(
        on_path=on_path,
        is_match=is_match,
        length=mlen,
        dist=mdist,
        hist_lit=hist_lit,
        hist_dist=hist_dist,
        exact=exact,
    )


def _summarize_batch(data, n_valid, take, plen, dist, on_path_full,
                     seg_len, hist):
    """Batched :func:`_summarize_one`."""
    return jax.vmap(
        lambda seg, n, t_, ln, dd, opf: _summarize_one(
            seg, opf, t_, ln, dd, n, seg_len, hist)
    )(data, n_valid, take, plen, dist, on_path_full)


def _hot_lane(seg, length, dist, n, hl, hot, match_gain, *,
              seg_len: int, hist: int, max_dist: int):
    """Exact strided-run candidates at the mined hot distances: run
    lengths of data[i] == data[i-d] by one batched suffix scan; the
    longest run (ties -> nearer) competes with the round-A candidate
    by bit gain.  Lanes merge by RUN LENGTH first and only the merged
    winner gets a bit-cost evaluation: hot distances are frequent by
    construction, so their dist codes cost within a bit or two of each
    other and the longest run is the gain winner in all but
    pathological ties — while per-lane match_gain would cost 4
    full-domain gathers x HOT_DISTS.
    Reaches structural periods (image row strides) the depth-K bucket
    search cannot see inside giant equal-content buckets."""
    pay_idx = jnp.arange(seg_len, dtype=jnp.int32)
    abs_idx = pay_idx + hist
    srcs = jnp.stack([
        seg[jnp.maximum(abs_idx - hot[j], 0)] for j in range(HOT_DISTS)
    ])
    eqs = srcs == seg[hist:][None, :]
    runs = _run_length_scan_multi(eqs)
    hot_len = jnp.zeros(seg_len, jnp.int32)
    hot_d = jnp.zeros(seg_len, jnp.int32)
    for j in range(HOT_DISTS):
        d_j = hot[j]
        ok_j = (abs_idx - d_j >= hist - hl) & (pay_idx < n) \
            & (d_j >= 1) & (d_j <= max_dist)
        len_j = jnp.where(ok_j, jnp.minimum(runs[j], MAX_MATCH), 0)
        len_j = jnp.minimum(len_j, jnp.maximum(n - pay_idx, 0))
        better = (len_j > hot_len) | ((len_j == hot_len) & (d_j < hot_d))
        hot_len = jnp.where(better, len_j, hot_len)
        hot_d = jnp.where(better, d_j, hot_d)
    g0 = match_gain(length, dist)
    g_hot = match_gain(hot_len, hot_d)
    better = g_hot > g0
    return (jnp.where(better, hot_len, length),
            jnp.where(better, hot_d, dist))


#: gain of a non-match (below MIN_MATCH): never taken
NO_GAIN = -1e9


def _bit_costs(lit, lcost, dcost):
    """Round-B bit costs of one segment.

    lit int32[T] payload bytes; lcost float32[286], dcost float32[30]
    code lengths.  Returns (litbits float32[T], match_gain) where
    ``match_gain(length, dist)`` is the bits a match saves over coding
    the bytes it covers as literals (``NO_GAIN`` below MIN_MATCH).  All
    terms are small integers, so the float32 sums are exact.
    """
    t = lit.shape[0]
    pay_idx = jnp.arange(t, dtype=jnp.int32)
    litbits = lcost[lit]
    pref = jnp.concatenate([jnp.zeros(1, jnp.float32), jnp.cumsum(litbits)])

    def match_cost(length_, dist_):
        # code indices AND their extra-bit counts are elementwise
        # arithmetic (ops/codes.py) — only the per-segment cost tables
        # are real gathers
        lcode_, lex_, _ = codes.length_code_parts(length_)
        dsym_, dex_, _ = codes.dist_code_parts(dist_)
        return (
            lcost[jnp.clip(257 + lcode_, 0, 285)]
            + lex_.astype(jnp.float32)
            + dcost[jnp.clip(dsym_, 0, 29)]
            + dex_.astype(jnp.float32)
        )

    def match_gain(length_, dist_):
        span_ = pref[jnp.minimum(pay_idx + length_, t)] - pref[pay_idx]
        return jnp.where(length_ >= MIN_MATCH,
                         span_ - match_cost(length_, dist_),
                         jnp.float32(NO_GAIN))

    return litbits, match_gain


@functools.partial(jax.jit, static_argnames=("seg_len", "hist", "lazy"))
def lz77_parse_cost(data, cand_length, cand_dist, n_valid, lit_cost, dist_cost,
                    hist_len=None, hot_dists=None,
                    *, seg_len: int, hist: int = HIST, lazy: bool = True,
                    window_bits: int = 15):
    """Cost-aware re-parse (round B of the two-round analysis).

    Round A's greedy parse fixes a symbol distribution; its canonical
    code lengths become *bit-cost tables* (lit_cost float32[B, 286],
    dist_cost float32[B, 30]) and the take/defer decisions re-run with
    exact costs: a match is taken only when its coded bits undercut the
    literal run it covers (literal-run cost from a prefix sum of
    per-byte code lengths — exact, not an entropy estimate), and lazy
    deferral compares bit GAINS rather than raw lengths.  The
    candidates (cand_length/cand_dist from round A) are reused, so the
    expensive match-finding never re-runs.  This plays the role of the
    reference Ns encoder's cost-model block decisions (de.ml:3620–3692)
    extended to the parse itself.
    """
    p = _ceil_pow2(seg_len)
    levels = p.bit_length() - 1

    max_dist = 1 << window_bits

    def one(seg, length, dist, n, lcost, dcost, hl, hot):
        pay_idx = jnp.arange(seg_len, dtype=jnp.int32)
        length = jnp.where(pay_idx < n, length, 0)
        # restricted windows (window_bits < 15): defensively drop any
        # candidate beyond the negotiated distance — and gate the
        # hot-stride lane below the same way (its mined periods come
        # from the raw histogram and can exceed the window)
        length = jnp.where(dist <= max_dist, length, 0)
        litbits, match_gain = _bit_costs(seg[hist:].astype(jnp.int32),
                                         lcost, dcost)

        if hot is not None:
            length, dist = _hot_lane(
                seg, length, dist, n, hl, hot, match_gain,
                seg_len=seg_len, hist=hist, max_dist=max_dist)
        gain = match_gain(length, dist)
        if lazy:
            nxt_gain = jnp.concatenate(
                [gain[1:], jnp.full(1, NO_GAIN, jnp.float32)]
            )
            defer = nxt_gain - litbits > gain
        else:
            defer = jnp.zeros(seg_len, bool)
        take = (length >= MIN_MATCH) & (gain > 0) & ~defer
        return take, length, dist

    if hist_len is None:
        hist_len = n_valid * 0
    if hot_dists is None:
        take, length, dist = jax.vmap(
            lambda a, b, c, d, e, f, g: one(a, b, c, d, e, f, g, None)
        )(data, cand_length, cand_dist, n_valid, lit_cost, dist_cost, hist_len)
    else:
        take, length, dist = jax.vmap(one)(
            data, cand_length, cand_dist, n_valid, lit_cost, dist_cost,
            hist_len, hot_dists)
    on_path_full = _mark_batched(take, length, seg_len, p, levels)
    return _summarize_batch(data, n_valid, take, length, dist,
                            on_path_full, seg_len, hist)


def _hot_dists_host(dist_counts):
    """Top strided distances per segment from the round-A exact-distance
    histogram (host).  Distances <= 4 are covered by the always-on run
    scan; low-count strides are not worth a candidate lane."""
    b = dist_counts.shape[0]
    hot = np.zeros((b, HOT_DISTS), np.int32)
    for i in range(b):
        c = dist_counts[i].copy()
        c[:5] = 0
        # the histogram clips distances >= HOT_DIST_BINS into the last
        # bin — it is an overflow counter, not a real stride
        c[HOT_DIST_BINS - 1] = 0
        top = np.argpartition(c, -HOT_DISTS)[-HOT_DISTS:]
        top = top[np.argsort(-c[top])]
        for j, d in enumerate(top):
            if c[d] >= 64:
                hot[i, j] = d
    return hot


def _cost_tables_host(hist_lit, hist_dist):
    """Round-A histograms -> float32 bit-cost tables (host).

    Canonical code lengths from the round-A distribution; symbols the
    round-A parse never produced get a pessimistic-but-usable default
    so round B may still introduce them when clearly profitable.
    """
    from ..core import huffman

    b = hist_lit.shape[0]
    lit_cost = np.full((b, 286), 13.0, np.float32)
    dist_cost = np.full((b, 30), 13.0, np.float32)
    for i in range(b):
        hl = hist_lit[i].astype(np.int64)
        hl[tables.EOB] += 1
        ll = huffman.code_lengths_from_frequencies(hl)
        dl = huffman.code_lengths_from_frequencies(hist_dist[i].astype(np.int64))
        lit_cost[i, : ll.size] = np.where(ll > 0, ll, 13.0)
        dist_cost[i, : dl.size] = np.where(dl > 0, dl, 13.0)
    return lit_cost, dist_cost


def analyze2_start(data, n_valid, hist_len, *, level: int, seg_len: int,
                   window_bits: int = 15, hist: int = HIST):
    """Dispatch round A asynchronously (no host sync).  Pair with
    :func:`analyze2_finish`; callers with many batches dispatch all
    starts first so device work pipelines ahead of the host fetches
    (the look-ahead the de driver already does for packing)."""
    return lz77_analyze(data, n_valid, hist_len, level=level,
                        seg_len=seg_len, window_bits=window_bits, hist=hist)


def analyze2(data, n_valid, hist_len, *, level: int, seg_len: int,
             window_bits: int = 15, hist: int = HIST):
    """Full per-level analysis: round A (greedy+lazy) plus, for
    two_round levels, the cost-aware round-B re-parse; fingerprint
    overestimates retry with the exact-extension candidates, so the
    result is always byte-exact."""
    res = analyze2_start(data, n_valid, hist_len, level=level,
                         seg_len=seg_len, window_bits=window_bits, hist=hist)
    return analyze2_finish(res, data, n_valid, hist_len, level=level,
                           seg_len=seg_len, window_bits=window_bits, hist=hist)


def analyze2_finish(res, data, n_valid, hist_len, *, level: int, seg_len: int,
                    window_bits: int = 15, hist: int = HIST):
    cfg = LEVELS[level]
    cl, cd = res["cand_length"], res["cand_dist"]
    exact_a = cfg.exact or bool(np.asarray(res["exact"]).all())
    if not exact_a:
        # a selected round-A match overestimated: trim it exactly.
        # Round A's histograms still feed the cost tables unrepaired —
        # they are a heuristic distribution either way.
        cl = lz77_trim_candidates(data, res["is_match"], res["length"],
                                  res["dist"], cl, cd, n_valid,
                                  seg_len=seg_len, hist=hist)
    if not cfg.two_round:
        if exact_a:
            return res
        for _ in range(_TRIM_RETRIES):
            res = lz77_reparse_greedy(data, cl, cd, n_valid, seg_len=seg_len,
                                      hist=hist, lazy=cfg.lazy)
            if bool(np.asarray(res["exact"]).all()):
                return res
            cl = lz77_trim_candidates(data, res["is_match"], res["length"],
                                      res["dist"], cl, cd, n_valid,
                                      seg_len=seg_len, hist=hist)
        return lz77_analyze(data, n_valid, hist_len, level=level,
                            seg_len=seg_len, force_exact=True,
                            window_bits=window_bits, hist=hist)
    lit_cost, dist_cost = _cost_tables_host(
        np.asarray(res["hist_lit"]), np.asarray(res["hist_dist"])
    )
    import jax.numpy as _jnp

    hot = None
    if cfg.mine:
        hot_np = _hot_dists_host(np.asarray(res["dist_counts"]))
        if hot_np.any():  # all-zero rows: skip the 8-lane mining pass
            hot = _jnp.asarray(hot_np)
    lc, dc = _jnp.asarray(lit_cost), _jnp.asarray(dist_cost)
    for _ in range(_TRIM_RETRIES):
        res2 = lz77_parse_cost(
            data, cl, cd, n_valid, lc, dc, hist_len, hot,
            seg_len=seg_len, hist=hist, lazy=cfg.lazy,
            window_bits=window_bits,
        )
        if bool(np.asarray(res2["exact"]).all()):
            return res2
        cl = lz77_trim_candidates(data, res2["is_match"], res2["length"],
                                  res2["dist"], cl, cd, n_valid,
                                  seg_len=seg_len, hist=hist)
    # trims keep surfacing collisions: exact-extension sledgehammer
    resx = lz77_analyze(data, n_valid, hist_len, level=level,
                        seg_len=seg_len, force_exact=True,
                        window_bits=window_bits, hist=hist)
    return lz77_parse_cost(
        data, resx["cand_length"], resx["cand_dist"], n_valid, lc, dc,
        hist_len, hot,
        seg_len=seg_len, hist=hist, lazy=cfg.lazy, window_bits=window_bits,
    )
