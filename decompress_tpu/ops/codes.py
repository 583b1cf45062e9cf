"""Elementwise DEFLATE length/distance code arithmetic (device side).

The RFC 1951 §3.2.5 code tables (`core/tables.py`, the analogue of the
reference's `_length`/`_distance` tables, de.ml:210–264) are small, but
*gathering* them per position costs far more than elementwise
arithmetic.  Both maps are piecewise log-structured, so the code index,
extra-bit count and extra-bit value are computable with a handful of
lane ops from the float32 exponent field — no table, no gather.

Exactness: int -> float32 is exact below 2^24 and lengths/distances are
<= 32768, so ``floor(log2 x)`` from the exponent bits is exact.  A unit
test checks every length 3..258 and distance 1..32768 against the table
maps.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

MIN_MATCH = 3


def _floor_log2(x: jnp.ndarray) -> jnp.ndarray:
    """floor(log2(x)) for int32 x in [1, 2^23] via the f32 exponent."""
    f = x.astype(jnp.float32)
    return (jax.lax.bitcast_convert_type(f, jnp.int32) >> 23) - 127


def length_code_parts(length: jnp.ndarray):
    """(code 0..28, extra_bits, extra_val) for match length 3..258.

    ``code`` is the offset from symbol 257 (i.e. `LENGTH_CODE_MAP[len-3]`).
    Out-of-range inputs are clipped; callers mask invalid lanes.
    """
    l = jnp.clip(length - MIN_MATCH, 0, 255)
    small = l < 8
    top = l >= 255  # length 258: its own zero-extra code 28
    e = jnp.maximum(_floor_log2(jnp.maximum(l, 1)) - 2, 0)
    e = jnp.where(small | top, 0, e)
    code = jnp.where(small, l, jnp.where(top, 28, 4 + 4 * e + ((l >> e) & 3)))
    val = l & ((1 << e) - 1)  # 0 whenever e == 0
    return code, e, val


def dist_code_parts(dist: jnp.ndarray):
    """(code 0..29, extra_bits, extra_val) for distance 1..32768."""
    m = jnp.clip(dist - 1, 0, (1 << 15) - 1)
    small = m < 4
    e = jnp.where(small, 0, jnp.maximum(_floor_log2(jnp.maximum(m, 1)) - 1, 0))
    code = jnp.where(small, m, 2 + 2 * e + ((m >> e) & 1))
    val = m & ((1 << e) - 1)
    return code, e, val


def length_code(length: jnp.ndarray) -> jnp.ndarray:
    """`LENGTH_CODE_MAP[clip(length-3)]` without the gather."""
    return length_code_parts(length)[0]


def dist_code(dist: jnp.ndarray) -> jnp.ndarray:
    """`DIST_CODE_MAP` lookup (two-branch gather) without the gather."""
    return dist_code_parts(dist)[0]
