"""Device checksum kernels: Adler-32 and CRC-32, data-parallel.

The reference delegates checksums to checkseum's C implementations
(SURVEY §2 #25; used at de.ml:443–455, zl.ml:236–241, gz.ml:503–513,
gz.ml:682).  Here both checksums are *data-parallel device reductions*:

* **Adler-32** — ``A = 1 + Σ b_i``, ``B = N + Σ (N-i)·b_i`` (mod 65521):
  per-chunk byte sums and position-weighted sums computed vectorized,
  then an associative per-chunk combine (the affine recurrence
  ``s2' = s2 + L·s1 + W`` unrolled into a weighted reduction).

* **CRC-32** — the CRC register is linear over GF(2) in the message
  bits, so a whole chunk's register contribution is one matrix product:
  ``reg = H_L @ bits(chunk) (mod 2)`` with a precomputed 32×8L matrix —
  an int8 matmul.  Cross-chunk combine uses the "advance by k zero
  bytes" operators ``M^(2^k)`` (the zlib crc32_combine algebra), also
  as GF(2) matmuls.

Both kernels exploit *front zero padding*: leading zero bytes are
no-ops for a zero-initialised CRC register and contribute nothing to
Adler sums (up to one scalar correction), so arbitrary lengths map to
static shapes for free.

Host-side scalar combines (`crc32_combine`, `adler32_combine`) serve
the multi-host gather (SURVEY §2 parallelism table: "checksum combine").
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

ADLER_MOD = 65521
CRC_POLY = 0xEDB88320  # reflected CRC-32 (IEEE), as used by gzip/zlib

# ---------------------------------------------------------------------------
# Host-side GF(2) machinery (numpy, precomputes the device constants).
# ---------------------------------------------------------------------------


@functools.cache
def _crc_byte_table() -> np.ndarray:
    """Classic 256-entry CRC table: T[b] = register after byte b from 0."""
    t = np.zeros(256, dtype=np.uint64)
    for b in range(256):
        c = b
        for _ in range(8):
            c = (c >> 1) ^ (CRC_POLY if (c & 1) else 0)
        t[b] = c
    return t.astype(np.uint32)


def _gf2_matvec(mat: np.ndarray, v: int) -> int:
    """mat: uint32[32], mat[j] = image of basis bit j. Returns mat·v."""
    r = 0
    j = 0
    while v:
        if v & 1:
            r ^= int(mat[j])
        v >>= 1
        j += 1
    return r


def _gf2_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(a·b)[j] = a · (b[j])."""
    return np.array([_gf2_matvec(a, int(col)) for col in b], dtype=np.uint32)


@functools.cache
def _crc_shift_one_byte() -> np.ndarray:
    """M1: register advance by one zero byte, v -> (v>>8) ^ T[v & 0xFF]."""
    t = _crc_byte_table()
    cols = []
    for j in range(32):
        v = 1 << j
        cols.append(((v >> 8) ^ int(t[v & 0xFF])) & 0xFFFFFFFF)
    return np.array(cols, dtype=np.uint32)


@functools.cache
def _crc_shift_pow2(k: int) -> np.ndarray:
    """M1^(2^k): register advance by 2^k zero bytes."""
    if k == 0:
        return _crc_shift_one_byte()
    m = _crc_shift_pow2(k - 1)
    return _gf2_matmul(m, m)


def crc_advance(crc_reg: int, nbytes: int) -> int:
    """Advance a raw CRC register by ``nbytes`` zero bytes (host scalar)."""
    k = 0
    while nbytes:
        if nbytes & 1:
            crc_reg = _gf2_matvec(_crc_shift_pow2(k), crc_reg)
        nbytes >>= 1
        k += 1
    return crc_reg


def crc_advance_batch(regs: np.ndarray, nbytes: np.ndarray) -> np.ndarray:
    """Vectorized :func:`crc_advance`: row i's register advanced by
    ``nbytes[i]`` zero bytes.  Each length bit applies one 32x32 GF(2)
    matrix to every selected row as 32 masked-XOR numpy vector ops —
    O(32·log n) vector ops total, independent of the row count (no
    O(members) Python/GF(2) work in the sharded trailer paths)."""
    regs = np.asarray(regs, np.uint64).copy()
    nbytes = np.asarray(nbytes, np.int64)
    if regs.size == 0:
        return regs.astype(np.uint32)
    maxn = int(nbytes.max())
    k = 0
    while (1 << k) <= maxn:
        if int(((nbytes >> k) & 1).max()):
            mat = _crc_shift_pow2(k).astype(np.uint64)
            out = np.zeros_like(regs)
            for j in range(32):
                out ^= np.where((regs >> np.uint64(j)) & np.uint64(1),
                                mat[j], np.uint64(0))
            regs = np.where((nbytes >> k) & 1 == 1, out, regs)
        k += 1
    return regs.astype(np.uint32)


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """CRC of the concatenation from the CRCs of the halves.

    Because init == xorout == 0xFFFFFFFF, the affine terms cancel and the
    combine is exactly ``M^len2 · crc1 ⊕ crc2`` (zlib crc32_combine math).
    Host scalar; the device analogue is the per-chunk combine tree.
    """
    return crc_advance(crc1, len2) ^ crc2


def adler32_combine(a1: int, a2: int, len2: int) -> int:
    """Adler-32 of a concatenation from the halves' checksums."""
    s1_1, s2_1 = a1 & 0xFFFF, (a1 >> 16) & 0xFFFF
    s1_2, s2_2 = a2 & 0xFFFF, (a2 >> 16) & 0xFFFF
    s1 = (s1_1 + s1_2 - 1) % ADLER_MOD
    s2 = (s2_1 + s2_2 + (s1_1 - 1) * (len2 % ADLER_MOD) - 0) % ADLER_MOD
    return ((s2 % ADLER_MOD) << 16) | s1


# ---------------------------------------------------------------------------
# Device constants.
# ---------------------------------------------------------------------------

CRC_CHUNK = 256  # bytes per CRC matmul chunk


@functools.cache
def _crc_chunk_matrix(chunk: int = CRC_CHUNK) -> np.ndarray:
    """H: int8[8*chunk, 32]; register contribution of a zero-init chunk is
    bits(chunk_bytes) @ H (mod 2), bit j of byte i at row 8*i+j."""
    t = _crc_byte_table()
    h = np.zeros((8 * chunk, 32), dtype=np.int8)
    # contribution of byte i, bit j: advance T[1<<j] by (chunk-1-i) zero bytes
    for i in range(chunk):
        adv = crc_advance  # closure
        for j in range(8):
            reg = int(t[1 << j])
            reg = adv(reg, chunk - 1 - i)
            h[8 * i + j] = (reg >> np.arange(32)) & 1
    return h


@functools.cache
def _crc_level_matrix(level: int, chunk: int = CRC_CHUNK) -> np.ndarray:
    """Bit matrix (int8[32,32]) advancing a register by chunk·2^level zero
    bytes: row j = bits of M^(chunk·2^level) e_j."""
    n = chunk << level
    cols = np.array([crc_advance(1 << j, n) for j in range(32)], dtype=np.uint64)
    return ((cols[:, None] >> np.arange(32, dtype=np.uint64)[None, :]) & 1).astype(np.int8)


# ---------------------------------------------------------------------------
# Device kernels.
# ---------------------------------------------------------------------------


def _ceil_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@jax.jit
def _crc32_register_padded(data_padded: jnp.ndarray) -> jnp.ndarray:
    """Raw zero-init CRC register of the *back-aligned* padded buffer.

    ``data_padded``: uint8[P] with the true message in the LAST bytes
    and zeros in front (leading zeros are no-ops from a zero register).
    P must be a power-of-two multiple of CRC_CHUNK.
    """
    p = data_padded.shape[0]
    assert p % CRC_CHUNK == 0
    nchunks = p // CRC_CHUNK
    h = jnp.asarray(_crc_chunk_matrix())
    chunks = data_padded.reshape(nchunks, CRC_CHUNK).astype(jnp.int32)
    # unpack bits LSB-first: [nchunks, CRC_CHUNK, 8] -> [nchunks, 8*CRC_CHUNK]
    bits = (chunks[:, :, None] >> jnp.arange(8, dtype=jnp.int32)[None, None, :]) & 1
    bits = bits.reshape(nchunks, 8 * CRC_CHUNK)
    # GF(2) matmul = integer matmul then parity.  int8 operands with an
    # int32 accumulator keep the count (<= 8*CRC_CHUNK) exact on every
    # backend, with no reliance on a float format's mantissa.
    partial = jax.lax.dot_general(
        bits.astype(jnp.int8), h,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    ) & 1  # [nchunks, 32] register bits
    # combine tree: fold chunk pairs; left half advanced by the right
    # half's byte count (a per-level constant matrix).
    level = 0
    while partial.shape[0] > 1:
        m = jnp.asarray(_crc_level_matrix(level))  # int8[32, 32]
        left = partial[0::2].astype(jnp.int8)
        right = partial[1::2]
        adv = jax.lax.dot_general(
            left, m, dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        ) & 1
        partial = adv ^ right
        level += 1
    reg_bits = partial[0].astype(jnp.uint32)
    return jnp.sum(reg_bits << jnp.arange(32, dtype=jnp.uint32), dtype=jnp.uint32)


def crc32(data, value: int = 0) -> int:
    """CRC-32 of ``data`` on device; drop-in for ``zlib.crc32``."""
    arr = np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) else np.asarray(data, dtype=np.uint8)
    n = arr.size
    if n == 0:
        return value
    p = _ceil_pow2(max((n + CRC_CHUNK - 1) // CRC_CHUNK, 1)) * CRC_CHUNK
    padded = np.zeros(p, dtype=np.uint8)
    padded[p - n :] = arr
    reg = int(_crc32_register_padded(jnp.asarray(padded)))
    # fold in init/xorout (and a previous running crc as initial register)
    init = (value ^ 0xFFFFFFFF) & 0xFFFFFFFF
    return (crc_advance(init, n) ^ reg ^ 0xFFFFFFFF) & 0xFFFFFFFF


_CRC_BATCH_JIT = None


def crc32_batch(data_2d: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """CRC-32 of each row's first ``lengths[i]`` bytes, batched on device.

    The register computation is length-independent (back-aligned rows);
    only the init-register advance differs per row, a cheap host GF(2)
    matvec.  Used for per-member gzip trailers in the sharded path.
    """
    global _CRC_BATCH_JIT
    m, l = data_2d.shape
    p = _ceil_pow2(max((l + CRC_CHUNK - 1) // CRC_CHUNK, 1)) * CRC_CHUNK
    padded = np.zeros((m, p), dtype=np.uint8)
    for i in range(m):
        n = int(lengths[i])
        padded[i, p - n :] = data_2d[i, :n] if n else 0
    if _CRC_BATCH_JIT is None:
        _CRC_BATCH_JIT = jax.jit(jax.vmap(_crc32_register_padded))
    regs = np.asarray(_CRC_BATCH_JIT(jnp.asarray(padded))).astype(np.uint64)
    lens = np.asarray(lengths, np.int64)
    init = crc_advance_batch(np.full(m, 0xFFFFFFFF, np.uint64), lens)
    out = (init.astype(np.uint64) ^ regs ^ np.uint64(0xFFFFFFFF)) & np.uint64(0xFFFFFFFF)
    return np.where(lens == 0, 0, out).astype(np.uint32)


_CRC_DEV_JIT = None


def crc32_batch_device(data_2d, lengths) -> np.ndarray:
    """Like :func:`crc32_batch` but for a device-resident uint8[M, L]
    (avoids re-uploading payloads over slow links).  Rows are
    back-aligned on device with per-row rolls; bytes at and beyond
    ``lengths[i]`` MUST be zero (they wrap to the zero-prefix region,
    which the register computation ignores only if they are zero) —
    the sharded-member buffers satisfy this by construction."""
    global _CRC_DEV_JIT
    m, l = data_2d.shape
    p = _ceil_pow2(max((l + CRC_CHUNK - 1) // CRC_CHUNK, 1)) * CRC_CHUNK
    if _CRC_DEV_JIT is None:
        @functools.partial(jax.jit, static_argnames=("pad_to",))
        def dev(d2, lens, pad_to):
            mm, ll = d2.shape
            padded = jnp.zeros((mm, pad_to), jnp.uint8).at[:, pad_to - ll :].set(d2)
            rolled = jax.vmap(lambda row, k: jnp.roll(row, k))(padded, ll - lens)
            return jax.vmap(_crc32_register_padded)(rolled)

        _CRC_DEV_JIT = dev
    regs = np.asarray(_CRC_DEV_JIT(data_2d, jnp.asarray(lengths), p)).astype(np.uint64)
    lens = np.asarray(lengths, np.int64)
    init = crc_advance_batch(np.full(m, 0xFFFFFFFF, np.uint64), lens)
    out = (init.astype(np.uint64) ^ regs ^ np.uint64(0xFFFFFFFF)) & np.uint64(0xFFFFFFFF)
    return np.where(lens == 0, 0, out).astype(np.uint32)


ADLER_CHUNK = 512


@functools.partial(jax.jit, static_argnames=())
def _adler_partials(chunks: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """chunks: int32[n, L]. Returns per-chunk (S, W) mod ADLER_MOD where
    S = Σ b and W = Σ (L-i)·b_i."""
    l = chunks.shape[1]
    weights = (l - jnp.arange(l, dtype=jnp.int32))[None, :]
    s = jnp.sum(chunks, axis=1) % ADLER_MOD
    w = jnp.sum(chunks * weights, axis=1) % ADLER_MOD
    return s, w


def _mod_tree_sum(x: jnp.ndarray, mod: int) -> jnp.ndarray:
    """Sum int32 values each < mod without overflow (mod every 2^14 terms)."""
    while x.shape[0] > 1:
        n = x.shape[0]
        take = min(n, 16384)
        pad = -n % take
        if pad:
            x = jnp.concatenate([x, jnp.zeros(pad, dtype=x.dtype)])
        x = jnp.sum(x.reshape(-1, take), axis=1) % mod
    return x[0]


@jax.jit
def _adler32_padded(data_padded: jnp.ndarray, length) -> jnp.ndarray:
    """Adler-32 of a back-aligned zero-front-padded buffer.

    Leading zeros leave A unchanged and inflate B by exactly ``pad``
    (weight of a position shifts with the pad), corrected at the end.
    """
    p = data_padded.shape[0]
    nchunks = p // ADLER_CHUNK
    chunks = data_padded.reshape(nchunks, ADLER_CHUNK).astype(jnp.int32)
    s, w = _adler_partials(chunks)  # each < ADLER_MOD
    # B(padded) = P + Σ_j W_j + L·Σ_j (n-1-j)·S_j  (mod m); A = 1 + Σ S_j
    jidx = jnp.arange(nchunks, dtype=jnp.int32)
    coeff = (nchunks - 1 - jidx) % ADLER_MOD
    weighted = (coeff.astype(jnp.uint32) * s.astype(jnp.uint32)) % ADLER_MOD
    sum_s = _mod_tree_sum(s, ADLER_MOD)
    sum_w = _mod_tree_sum(w, ADLER_MOD)
    sum_ws = _mod_tree_sum(weighted.astype(jnp.int32), ADLER_MOD)
    a = (1 + sum_s) % ADLER_MOD
    pad = jnp.int32(p) - length
    b = (p % ADLER_MOD + sum_w + (ADLER_CHUNK % ADLER_MOD) * sum_ws) % ADLER_MOD
    b = (b - pad % ADLER_MOD + ADLER_MOD) % ADLER_MOD
    return (b.astype(jnp.uint32) << 16) | a.astype(jnp.uint32)


def adler32(data, value: int = 1) -> int:
    """Adler-32 of ``data`` on device; drop-in for ``zlib.adler32``."""
    arr = np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) else np.asarray(data, dtype=np.uint8)
    n = arr.size
    if n == 0:
        return value
    # power-of-two chunk counts bound the number of compiled variants;
    # length itself is a traced scalar (no per-length recompiles)
    p = _ceil_pow2(max((n + ADLER_CHUNK - 1) // ADLER_CHUNK, 1)) * ADLER_CHUNK
    padded = np.zeros(p, dtype=np.uint8)
    padded[p - n :] = arr
    fresh = int(_adler32_padded(jnp.asarray(padded), jnp.int32(n)))
    if value == 1:
        return fresh
    return adler32_combine(value, fresh, n)
