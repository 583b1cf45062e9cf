"""Smoke test of the gzip codec's main path on an NVIDIA GPU.

Drives the public entry points once at production sizes and checks
every result against the stdlib zlib/gzip oracle:

  0. the card: name and power limit, JAX version, device kind;
  1. ``sharded_gzip_compress``: level 6 on 64 MiB of the replicated
     corpus, levels 1 and 9 on 16 MiB;
  2. the same 4 MiB compressed on the GPU and on the CPU: the archives
     must be byte-identical;
  3. ``sharded_gzip_decompress`` of the level-6 archive on the device,
     with the serial host fallback poisoned;
  4. the symbol decoders (XLA loop and the Triton kernel) on the staged
     rows of that archive, alone and end to end: same commands;
  5. one-shot ``zl`` and ``gz`` framing of ``book1``;
  6. device CRC-32 and Adler-32 of 64 MiB;
  7. compiled memory analysis of the analyze, pack and decode jits.

With ``--cards 4`` it runs only the sharded compress over a 1-card and
a 4-card ``dp`` mesh (default and shared-tree mode) and checks that the
archives are identical and that the member batch spans all four cards.

The last line of standard output is one JSON object, printed only when
every phase passed.  Without a GPU the script exits non-zero at once.

Usage: python chip_smoke.py [--cards 4]
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import json
import pathlib
import statistics
import subprocess
import sys
import time
import zlib

ROOT = pathlib.Path(__file__).resolve().parent
MIB = 1 << 20


def log(msg: str) -> None:
    print(msg, flush=True)


def corpus_bytes(n: int) -> bytes:
    """``n`` bytes of the test corpus, replicated."""
    base = b"".join(p.read_bytes()
                    for p in sorted((ROOT / "tests" / "corpus").iterdir()))
    return (base * -(-n // len(base)))[:n]


def timed(fn, reps: int = 1):
    """(result, first-call seconds, [warm seconds]) of ``fn()``."""
    t0 = time.perf_counter()
    out = fn()
    first = time.perf_counter() - t0
    warm = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        warm.append(time.perf_counter() - t0)
    return out, first, warm


def median_s(fn, reps: int = 5) -> float:
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


@contextlib.contextmanager
def no_serial_fallback():
    """Make the serial host decode raise, so the device path must
    decode every member of the archive itself."""
    from decompress_tpu import gz

    real = gz.decompress

    def poisoned(_buf):
        raise AssertionError("serial host fallback taken")

    gz.decompress = poisoned
    try:
        yield
    finally:
        gz.decompress = real


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Checks shared with the GPU-marked tests.
# ---------------------------------------------------------------------------


def command_stream(st, out):
    """The real commands of decoded rows, in archive order, as packed
    words: the stream the host expansion consumes, without NOP slots."""
    import jax.numpy as jnp
    import numpy as np

    from decompress_tpu.ops import inflate as inflate_ops

    kinds, values, dists, _ok = out
    stops = jnp.asarray(st.stops[:kinds.shape[0]])
    spans = (inflate_ops.slot_counts_bits(kinds, stops) if st.bit_mode
             else inflate_ops.slot_counts(kinds, stops))
    spans = np.array(spans)
    spans[st.nrows:] = 0
    packed = (kinds.astype(jnp.int32) << 26) | (dists << 10) | values
    total = int(spans.sum())
    flat = np.asarray(inflate_ops.compact_commands(
        packed, jnp.asarray(spans), max(total, 1)))[:total]
    return flat[(flat >> 26) != inflate_ops.KIND_NOP]


def check_decoders(st, reps: int = 5) -> dict:
    """Run both symbol decoders on staged rows (inputs already on the
    device, table builds included); both must decode every row and
    yield the same command stream.  Returns their median seconds."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from decompress_tpu.ops import inflate as inflate_ops
    from decompress_tpu.ops import inflate_triton

    words = jnp.asarray(st.words)
    start = jnp.asarray(st.start_bits)
    stops = jnp.asarray(st.stops)
    members = jnp.asarray(st.row_members)
    lit = jnp.asarray(st.lit_lens)
    dist = jnp.asarray(st.dist_lens)

    def xla():
        lt, dt = inflate_ops.build_fused_tables(lit, dist)
        return jax.block_until_ready(inflate_ops.decode_symbols(
            words, start, lt, dt, max_cmds=st.xla_slots(),
            stop_bits=stops if st.bit_mode else None, row_members=members))

    def triton():
        return jax.block_until_ready(inflate_triton.decode_symbols(
            words, start, lit, dist, max_cmds=st.triton_slots(),
            stop_bits=stops, row_members=members))

    outs, times = {}, {}
    for name, fn in (("xla", xla), ("triton", triton)):
        outs[name] = fn()
        if not bool(np.asarray(outs[name][3])[:st.nrows].all()):
            raise AssertionError(f"{name} decoder: a row is not ok")
        times[name] = median_s(fn, reps)
    a, b = (command_stream(st, outs[k]) for k in ("xla", "triton"))
    if not np.array_equal(a, b):
        raise AssertionError("the decoders' command streams differ")
    return times


# ---------------------------------------------------------------------------
# Phases.
# ---------------------------------------------------------------------------


def phase_card(jax) -> None:
    log(f"card: {card_line()}")
    dev = jax.devices()[0]
    log(f"jax {jax.__version__}; device_kind {dev.device_kind}; "
        f"{len(jax.devices())} device(s)")


def phase_compress(state) -> None:
    from decompress_tpu.parallel import sharded_gzip_compress

    for level, size in ((6, 64 * MIB), (1, 16 * MIB), (9, 16 * MIB)):
        data = corpus_bytes(size)
        arch, first, warm = timed(
            lambda: sharded_gzip_compress(data, level))
        if gzip.decompress(arch) != data:
            raise AssertionError(f"level {level}: gzip round trip differs")
        log(f"compress level {level}, {size // MIB} MiB: first call "
            f"{first:.3f} s (with compile), warm {warm[0]:.3f} s "
            f"= {size / warm[0] / 1e6:.2f} MB/s, ratio "
            f"{len(arch) / size:.4f}")
        if level == 6:
            state["data"], state["archive"] = data, arch


def phase_cpu_bytes(jax) -> None:
    from decompress_tpu.parallel import sharded_gzip_compress

    data = corpus_bytes(4 * MIB)
    gpu = sharded_gzip_compress(data, 6)
    with jax.default_device(jax.devices("cpu")[0]):
        t0 = time.perf_counter()
        cpu = sharded_gzip_compress(data, 6)
        t_cpu = time.perf_counter() - t0
    if gpu != cpu:
        raise AssertionError(
            f"GPU and CPU archives differ ({len(gpu)} vs {len(cpu)} bytes)")
    log(f"4 MiB level 6: GPU archive == CPU archive ({len(gpu)} bytes; "
        f"CPU run {t_cpu:.1f} s)")


def phase_decompress(state) -> None:
    from decompress_tpu.parallel import sharded_gzip_decompress

    data, arch = state["data"], state["archive"]
    with no_serial_fallback():
        for expand in ("auto", "device"):
            out, first, warm = timed(
                lambda: sharded_gzip_decompress(arch, expand=expand))
            if out != data:
                raise AssertionError(f"expand={expand}: output differs")
            log(f"decompress 64 MiB expand={expand}: first {first:.3f} s, "
                f"warm {warm[0]:.3f} s = {len(data) / warm[0] / 1e6:.1f} MB/s")


def phase_decoders(state) -> None:
    import numpy as np

    from decompress_tpu.parallel import sharded

    data, arch = state["data"], state["archive"]
    buf = np.frombuffer(arch, np.uint8)
    st = sharded._stage_rows(buf)
    times = check_decoders(st)
    log(f"symbol decode, {st.nrows} rows: XLA loop "
        f"{times['xla'] * 1e3:.3f} ms, Triton kernel "
        f"{times['triton'] * 1e3:.3f} ms (medians of 5, same commands)")
    # end to end, in turns: xla, triton, triton, xla, ...
    e2e = {"xla": [], "triton": []}
    with no_serial_fallback():
        for k in range(10):
            dec = ("xla", "triton", "triton", "xla")[k % 4]
            t0 = time.perf_counter()
            out = sharded._decompress(buf, "auto", dec)
            e2e[dec].append(time.perf_counter() - t0)
            if out != data:
                raise AssertionError(f"{dec} decoder: output differs")
    log("sharded_gzip_decompress 64 MiB end to end: XLA decoder "
        f"{statistics.median(e2e['xla']):.4f} s, Triton decoder "
        f"{statistics.median(e2e['triton']):.4f} s (medians of 5, "
        "interleaved; runs "
        + ", ".join(f"{k}={[round(t, 4) for t in v]}" for k, v in e2e.items())
        + ")")


def phase_framing() -> None:
    from decompress_tpu import gz, zl

    book1 = (ROOT / "tests" / "corpus" / "book1").read_bytes()
    z = zl.deflate(book1, 6)
    if zlib.decompress(z) != book1 or zl.inflate(zlib.compress(book1, 6)) != book1:
        raise AssertionError("zl round trip against zlib differs")
    g = gz.compress(book1, 6)
    if gzip.decompress(g) != book1 or gz.decompress(gzip.compress(book1, 6)) != book1:
        raise AssertionError("gz round trip against gzip differs")
    log(f"book1 level 6: zl {len(z)} bytes, gz {len(g)} bytes, both "
        "agree with stdlib")


def phase_checksums() -> None:
    import jax.numpy as jnp
    import numpy as np

    from decompress_tpu.ops import checksum

    data = corpus_bytes(64 * MIB)
    if checksum.crc32(data) != zlib.crc32(data):
        raise AssertionError("device crc32 differs from zlib")
    if checksum.adler32(data) != zlib.adler32(data):
        raise AssertionError("device adler32 differs from zlib")
    rows = np.frombuffer(data, np.uint8).reshape(512, -1)
    lens = np.full(512, rows.shape[1], np.int32)
    lens[1::2] -= 1000
    rows = rows.copy()
    rows[1::2, -1000:] = 0  # bytes past a row's length must be zero
    got = checksum.crc32_batch_device(jnp.asarray(rows), lens)
    want = [zlib.crc32(rows[i, : lens[i]].tobytes()) for i in range(512)]
    if list(got) != want:
        raise AssertionError("device crc32_batch differs from zlib")
    log("64 MiB: device crc32, adler32 and 512-row crc32_batch_device "
        "equal zlib")


def phase_memory(state, jax) -> None:
    import jax.numpy as jnp
    import numpy as np

    from decompress_tpu import de
    from decompress_tpu.ops import inflate_triton, lz77
    from decompress_tpu.parallel import sharded

    b, seg = de.MAX_DEVICE_BATCH, de.SEGMENT_SIZE
    data = jnp.asarray(np.frombuffer(state["data"][: b * seg], np.uint8)
                       .reshape(b, seg))
    nv = jnp.full(b, seg, jnp.int32)
    hl = jnp.zeros(b, jnp.int32)

    def show(name, lowered):
        ma = lowered.compile().memory_analysis()
        log(f"memory {name}: arguments {ma.argument_size_in_bytes}, "
            f"outputs {ma.output_size_in_bytes}, temporaries "
            f"{ma.temp_size_in_bytes}, code {ma.generated_code_size_in_bytes}"
            " bytes")

    show(f"lz77_analyze [{b}, {seg}] level 6", lz77.lz77_analyze.lower(
        data, nv, hl, level=6, seg_len=seg, hist=0))
    res = lz77.lz77_analyze(data, nv, hl, level=6, seg_len=seg, hist=0)
    (hv, hb), tabs, _kinds = de.plan_blocks(
        np.asarray(res["hist_lit"]), np.asarray(res["hist_dist"]),
        np.full(b, seg, np.int32), np.ones(b, bool), pad_to=b)
    show(f"pack [{b}, {seg}]", de._get_pack_jit().lower(
        res["on_path"], res["is_match"], res["length"], res["dist"], data,
        *[jnp.asarray(t) for t in (hv, hb, *tabs)],
        out_words=(9 * seg) // 32 + 2 * de._HDR_PAD,
        n_splits=sharded.N_SPLITS, split_stride=sharded.SPLIT_STRIDE,
        split_bits=sharded.SPLIT_BITS))
    st = sharded._stage_rows(np.frombuffer(state["archive"], np.uint8))
    tabs, _ok = inflate_triton.build_member_tables(
        jnp.asarray(st.lit_lens), jnp.asarray(st.dist_lens))
    show(f"Triton decode [{st.start_bits.size} rows]",
         inflate_triton._decode.lower(
             jnp.asarray(st.words), tabs, jnp.asarray(st.start_bits),
             jnp.asarray(st.stops), jnp.asarray(st.row_members),
             n_slots=st.triton_slots()))
    peak = jax.devices()[0].memory_stats().get("peak_bytes_in_use")
    log(f"device peak_bytes_in_use over the run: {peak}")


def phase_cards(n: int, jax) -> None:
    """Sharded compress on 1 card and on ``n`` cards: identical
    archives, and the member batch spread over all ``n``."""
    from decompress_tpu.parallel import sharded

    data = corpus_bytes(64 * MIB)
    real_shard = sharded._shard_batch
    seen: list = []

    def recording(x, mesh):
        out = real_shard(x, mesh)
        seen.append(frozenset(out.sharding.device_set))
        return out

    for shared in (False, True):
        archs = {}
        for cards in (1, n):
            mesh = sharded.make_mesh(cards)
            seen.clear()
            sharded._shard_batch = recording
            try:
                # shared-tree mode reuses the default mode's compiled
                # shapes, so its first call is already warm
                arch, first, warm = timed(
                    lambda: sharded.sharded_gzip_compress(
                        data, 6, mesh=mesh, shared_tree=shared),
                    reps=0 if shared else 1)
            finally:
                sharded._shard_batch = real_shard
            if gzip.decompress(arch) != data:
                raise AssertionError(f"{cards} cards: gzip round trip differs")
            spans = {len(s) for s in seen}
            if spans != {cards}:
                raise AssertionError(
                    f"{cards}-card mesh: inputs placed on {spans} devices")
            archs[cards] = arch
            t = warm[0] if warm else first
            log(f"compress 64 MiB level 6 on {cards} card(s), shared_tree="
                f"{shared}: first {first:.3f} s, warm {t:.3f} s = "
                f"{len(data) / t / 1e6:.2f} MB/s")
        if archs[1] != archs[n]:
            raise AssertionError(
                f"shared_tree={shared}: 1-card and {n}-card archives differ")
        log(f"shared_tree={shared}: 1-card and {n}-card archives identical "
            f"({len(archs[1])} bytes)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1,
                    help="run only the sharded compress on this many cards")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"no GPU: JAX's default device is {devs[0]}", file=sys.stderr)
        return 2
    if len(devs) < args.cards:
        print(f"--cards {args.cards}: only {len(devs)} GPU(s)",
              file=sys.stderr)
        return 2

    phase_card(jax)
    state: dict = {}
    if args.cards > 1:
        phases = [("cards", lambda: phase_cards(args.cards, jax))]
    else:
        phases = [
            ("compress", lambda: phase_compress(state)),
            ("cpu_bytes", lambda: phase_cpu_bytes(jax)),
            ("decompress", lambda: phase_decompress(state)),
            ("decoders", lambda: phase_decoders(state)),
            ("framing", phase_framing),
            ("checksums", phase_checksums),
            ("memory", lambda: phase_memory(state, jax)),
        ]
    for name, fn in phases:
        t0 = time.perf_counter()
        fn()
        log(f"phase {name}: passed in {time.perf_counter() - t0:.1f} s")
    count = args.cards if args.cards > 1 else len(devs)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
