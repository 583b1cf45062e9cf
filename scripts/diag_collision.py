"""Locate the fingerprint overestimate in segment 0 of the bench corpus
(round-A exact[0] = False): which position, what span, which rung/pass.

Runs on CPU (exactness is platform-independent).
    JAX_PLATFORMS=cpu python scripts/diag_collision.py
"""
import os
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp

from decompress_tpu import de
from decompress_tpu.ops import lz77


def main():
    seg = de.SEGMENT_SIZE
    corpus = pathlib.Path(__file__).parent.parent / "tests" / "corpus"
    raw = b"".join(p.read_bytes() for p in sorted(corpus.iterdir()))
    data = np.frombuffer(raw[:seg], np.uint8).reshape(1, seg)
    d = jnp.asarray(data)
    nv = jnp.asarray(np.full(1, seg, np.int32))
    hl = jnp.asarray(np.zeros(1, np.int32))

    res = lz77.lz77_analyze(d, nv, hl, level=6, seg_len=seg, hist=0)
    print("exact:", np.asarray(res["exact"]))
    is_m = np.asarray(res["is_match"])[0]
    ln = np.asarray(res["length"])[0]
    dist = np.asarray(res["dist"])[0]
    buf = data[0]
    bad = 0
    for s in np.nonzero(is_m)[0]:
        L, D = int(ln[s]), int(dist[s])
        src = buf[s - D : s - D + L]
        dst = buf[s : s + L]
        if not np.array_equal(src, dst):
            neq = np.nonzero(src != dst)[0]
            true_len = int(neq[0]) if neq.size else L
            print(f"OVERESTIMATE at pos {s}: len {L} dist {D} "
                  f"true_len {true_len}")
            print("  dst:", bytes(buf[s : s + min(L, 48)]))
            print("  src:", bytes(buf[s - D : s - D + min(L, 48)]))
            bad += 1
            if bad > 5:
                break
    print("total overestimates:", bad)


if __name__ == "__main__":
    main()
