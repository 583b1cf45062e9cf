"""Level-6 ratio experiment: does the two-round
exact-cost parse (and the hash3 len-3 pass it enables) close the
level-6 gap vs zlib-6?

Adds trial level slots:
  60 = level-6 config + two_round
  61 = level-6 config + two_round + hash3
  62 = level-6 config + two_round + hash3 + top2
and prints per-file sizes vs level 6 and C zlib-6.  Ratios are
platform-independent (run on CPU).

Run: JAX_PLATFORMS=cpu python scripts/level6_ratio.py
"""

import pathlib
import sys
import zlib

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

from decompress_tpu import zl
from decompress_tpu.ops import lz77


def main() -> None:
    lz77.LEVELS[60] = lz77.LevelConfig(16, True, two_round=True)
    lz77.LEVELS[61] = lz77.LevelConfig(16, True, two_round=True, hash3=True)
    lz77.LEVELS[62] = lz77.LevelConfig(16, True, two_round=True, hash3=True,
                                       top2=True)
    corpus = sorted(
        (pathlib.Path(__file__).parent.parent / "tests" / "corpus").iterdir())
    cols = [6, 60, 61, 62]
    print(f"{'file':<14} {'size':>8} " + " ".join(f"{c:>8}" for c in cols)
          + f" {'zlib6':>8}  ratios-to-zlib", flush=True)
    tot = {c: 0 for c in cols}
    tot_z = tot_in = 0
    for p in corpus:
        data = p.read_bytes()
        sizes = {}
        for c in cols:
            out = zl.deflate(data, c)  # zlib-framed stream
            assert zlib.decompress(bytes(out)) == data
            sizes[c] = len(out)
            tot[c] += len(out)
        z = len(zlib.compress(data, 6))
        tot_z += z
        tot_in += len(data)
        print(f"{p.name:<14} {len(data):>8} "
              + " ".join(f"{sizes[c]:>8}" for c in cols)
              + f" {z:>8}  "
              + " ".join(f"{sizes[c]/z:6.4f}" for c in cols), flush=True)
    print(f"{'TOTAL':<14} {tot_in:>8} "
          + " ".join(f"{tot[c]:>8}" for c in cols)
          + f" {tot_z:>8}  "
          + " ".join(f"{tot[c]/tot_z:6.4f}" for c in cols), flush=True)


if __name__ == "__main__":
    main()
