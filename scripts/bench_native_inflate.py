"""Host-only micro-bench of the native C++ inflater (no JAX device).

Measures raw-DEFLATE decode MB/s over zlib-compressed corpus data, and
the same via gz.decompress (adds CRC). Compares with Python zlib as the
speed-of-light reference for this machine.
"""
import os
import pathlib
import time
import zlib

os.environ.setdefault("JAX_PLATFORMS", "cpu")


def main():
    corpus = pathlib.Path(__file__).parent.parent / "tests" / "corpus"
    raw = b"".join(p.read_bytes() for p in sorted(corpus.iterdir()))
    raw = raw * 8  # ~26 MB
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    comp = c.compress(raw) + c.flush()

    from decompress_tpu import de, native

    assert native.available()

    # warm + correctness
    out = de.inflate(comp)
    assert out == raw

    def med(f, n=5):
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            f()
            ts.append(time.perf_counter() - t0)
        return sorted(ts)[n // 2]

    t_ours = med(lambda: de.inflate(comp))
    t_zlib = med(lambda: zlib.decompress(comp, -15))
    mb = len(raw) / 1e6
    print(f"input {len(comp)/1e6:.1f} MB -> output {mb:.1f} MB")
    print(f"native de.inflate : {mb/t_ours:8.1f} MB/s")
    print(f"python zlib       : {mb/t_zlib:8.1f} MB/s  (C zlib reference)")
    print(f"ratio ours/zlib   : {t_zlib/t_ours:.3f}")


if __name__ == "__main__":
    main()
