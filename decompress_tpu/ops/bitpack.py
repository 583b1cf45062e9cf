"""Device bit packer: the DEFLATE entropy-emission hot loop, data-parallel.

The reference emits bits symbol-by-symbol through a 16-bit hold
(`c_bits`/`write`, de.ml:2529–2541, 2708–2897).  On the device the job is
a *two-pass data-parallel* transform (SURVEY §3 "bit packer becomes a
two-pass emit"):

  1. every element's bit length → exclusive scan → absolute bit offset;
  2. each element's masked code lands in at most two 32-bit words, and
     contributions are bit-disjoint by construction, so per-word sums
     equal per-word ORs.

The word assembly INVERTS the scatter: within-word contributions are
bit-disjoint, so their true sum fits 32 bits and each output word is a
difference of a running (mod 2^32) prefix sum of element
contributions — out[w] = E[F[w+1]] - E[F[w]], where F (the first
element landing at or beyond each word) comes from one scatter-min +
reverse cummin over the monotone word indices.  That is one
scatter-min pass instead of the two scatter-OR passes of the direct
form: scatters cost more than cumsums per element.

Elements with ``nbits == 0`` are no-ops, which lets callers keep dense
masked command arrays (no compaction needed).  Little-endian uint32
words viewed as bytes are exactly the LSB-first DEFLATE bit stream
(the reference's c_bits/write hold, de.ml:2529–2541, emitted here as
one data-parallel transform).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _mask_vals(v, nb):
    return v.astype(jnp.uint32) & (
        (jnp.uint32(1) << nb.astype(jnp.uint32)) - jnp.uint32(1))


def _invert_offsets(widx: jnp.ndarray, out_words: int) -> jnp.ndarray:
    """F[w] = first element index whose (monotone) word index reaches w,
    for w in [0, out_words]; elements past the last word clamp into
    F[out_words].  One scatter-min + reverse cummin."""
    n = widx.shape[0]
    f0 = jnp.full(out_words + 1, n, jnp.int32).at[
        jnp.minimum(widx, out_words)
    ].min(jnp.arange(n, dtype=jnp.int32))
    return jax.lax.cummin(f0, reverse=True)


def _plane_words(masked, offsets, out_words: int):
    """Word image of one monotone plane: pre-masked values at absolute
    bit offsets, assembled by prefix-sum differences (bit-disjoint
    within each word, so the mod-2^32 sums are exact per word)."""
    r = (offsets & 31).astype(jnp.uint32)
    lo = masked << r
    # (masked >> (32-r)) with the r==0 case masked out (shift-by-32 UB)
    hi = jnp.where(r == jnp.uint32(0), jnp.uint32(0),
                   masked >> ((jnp.uint32(32) - r) & jnp.uint32(31)))
    f = _invert_offsets(offsets >> 5, out_words)
    el = jnp.concatenate([jnp.zeros(1, jnp.uint32), jnp.cumsum(lo)])
    eh = jnp.concatenate([jnp.zeros(1, jnp.uint32), jnp.cumsum(hi)])
    gl, gh = el[f], eh[f]  # one boundary gather per prefix array
    out_lo = gl[1:] - gl[:-1]
    dh = gh[1:] - gh[:-1]
    # hi parts land one word later: word w collects hi of widx == w-1
    return out_lo + jnp.concatenate([jnp.zeros(1, jnp.uint32), dh[:-1]])


def _scatter_tiny(masked, offsets, out_words: int):
    """Direct two-word scatter-OR for a TINY plane (headers/EOB):
    cheaper than the prefix machinery when the element count is O(10)."""
    widx = offsets >> 5
    r = (offsets & 31).astype(jnp.uint32)
    lo = masked << r
    hi = jnp.where(r == jnp.uint32(0), jnp.uint32(0),
                   masked >> ((jnp.uint32(32) - r) & jnp.uint32(31)))
    w = jnp.zeros(out_words, jnp.uint32)
    return w.at[widx].add(lo, mode="drop").at[widx + 1].add(hi, mode="drop")


def _invert_offsets_b(widx: jnp.ndarray, out_words: int) -> jnp.ndarray:
    """Batched :func:`_invert_offsets`: widx int32[B, N] (monotone per
    row) -> F int32[B, out_words+1].  The scatter-min runs over a
    manually flattened index space — a vmapped scatter lowers to a
    batched scatter XLA handles far worse than one flat pass."""
    b, n = widx.shape
    stride = out_words + 1
    flat_idx = (jnp.minimum(widx, out_words)
                + (jnp.arange(b, dtype=jnp.int32) * stride)[:, None]).reshape(-1)
    ranks = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[None, :],
                             (b, n)).reshape(-1)
    f0 = jnp.full(b * stride, n, jnp.int32).at[flat_idx].min(ranks)
    return jax.lax.cummin(f0.reshape(b, stride), axis=1, reverse=True)


def _plane_words_b(masked, offsets, out_words: int):
    """Batched :func:`_plane_words` ([B, N] in, [B, out_words] out).

    The running sums use int32 (two's-complement wraparound is
    bit-identical to uint32 mod-2^32 arithmetic, and int32 scans are
    the fast path)."""
    r = (offsets & 31).astype(jnp.uint32)
    lo = (masked << r).astype(jnp.int32)
    hi = jnp.where(r == jnp.uint32(0), jnp.uint32(0),
                   masked >> ((jnp.uint32(32) - r) & jnp.uint32(31))
                   ).astype(jnp.int32)
    b = masked.shape[0]
    f = _invert_offsets_b(offsets >> 5, out_words)
    z = jnp.zeros((b, 1), jnp.int32)
    el = jnp.concatenate([z, jnp.cumsum(lo, axis=1)], axis=1)
    eh = jnp.concatenate([z, jnp.cumsum(hi, axis=1)], axis=1)

    # one gather of el/eh at every F boundary (W+1 points), then
    # adjacent differences — half the take volume of gathering the
    # f[1:] and f[:-1] boundary sets separately
    gl = jnp.take_along_axis(el, f, axis=1)
    gh = jnp.take_along_axis(eh, f, axis=1)
    out_lo = gl[:, 1:] - gl[:, :-1]
    dh = gh[:, 1:] - gh[:, :-1]
    out_hi = jnp.concatenate([z, dh[:, :-1]], axis=1)
    return (out_lo + out_hi).astype(jnp.uint32)


@functools.partial(jax.jit, static_argnames=("out_words",))
def pack_slot_planes(v0, n0, v1, n1, hdr_vals, hdr_bits, eob_vals, eob_bits,
                     out_words: int):
    """Pack per-position slot PAIRS — slot 0 then slot 1 at every
    position — after the header bits, with the EOB code appended, while
    keeping the two slot planes separate end to end (no interleave
    relayout: the [B, T, 2] -> [B, 2T] reshape the merged form needs is
    a strided relayout XLA pays real time for).

    v0/n0/v1/n1: uint32/int32[B, T]; hdr_vals/hdr_bits [B, H];
    eob_vals/eob_bits [B, 1].  Returns (words uint32[B, out_words],
    total_bits int32[B], off0 int32[B, T], posbits int32[B, T]) — off0
    and posbits are the per-position first-slot bit offset and total
    bit count, which the split-point writer reuses.
    """

    hdr_off = jnp.cumsum(hdr_bits, axis=1) - hdr_bits
    hdr_total = hdr_off[:, -1:] + hdr_bits[:, -1:]
    posbits = n0 + n1
    base = hdr_total + jnp.cumsum(posbits, axis=1) - posbits
    off0 = base
    off1 = base + n0
    eob_off = base[:, -1:] + posbits[:, -1:]
    total = (eob_off + eob_bits)[:, 0]
    words = _plane_words_b(_mask_vals(v0, n0), off0, out_words)
    words = words + _plane_words_b(_mask_vals(v1, n1), off1, out_words)
    tv = jnp.concatenate([hdr_vals, eob_vals], axis=1)
    tn = jnp.concatenate([hdr_bits, eob_bits], axis=1)
    toff = jnp.concatenate([hdr_off, eob_off], axis=1)
    words = words + jax.vmap(
        lambda tv_, tn_, to_: _scatter_tiny(_mask_vals(tv_, tn_), to_,
                                            out_words)
    )(tv, tn, toff)
    return words, total, off0, posbits


@functools.partial(jax.jit, static_argnames=("out_words",))
def pack_bits_device(values: jnp.ndarray, nbits: jnp.ndarray, out_words: int):
    """Pack ``values`` (low ``nbits`` each, 0..31) LSB-first.

    values: uint32[..., N]; nbits: int32[..., N].  Returns
    ``(words uint32[..., out_words], total_bits int32[...])``.  Any
    element of <= 31 bits at offset r spans at most two 32-bit words
    (r%32 + 31 < 64), so the disjoint two-word scatter-OR covers all
    cases.  Elements whose cumulative offset exceeds ``32*out_words``
    are dropped (callers size ``out_words`` so this only happens when a
    stored block would win anyway).  Batched dims map over leading axes.
    """

    def one(v, nb):
        offsets = jnp.cumsum(nb) - nb
        total = offsets[-1] + nb[-1]
        return _plane_words(_mask_vals(v, nb), offsets, out_words), total

    fn = one
    for _ in range(values.ndim - 1):
        fn = jax.vmap(fn)
    return fn(values, nbits)


def words_to_bytes(words, total_bits: int) -> bytes:
    """uint32 words -> the first ceil(total_bits/8) stream bytes (host)."""
    import numpy as np

    b = np.asarray(words, dtype="<u4").view(np.uint8)
    return b[: (int(total_bits) + 7) // 8].tobytes()
