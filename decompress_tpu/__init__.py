"""decompress_tpu — a device-parallel DEFLATE-family codec framework.

Brand-new implementation (JAX/XLA/Pallas on the compute path, C++ for the
native runtime pieces) with the full capability surface of the reference
OCaml library mirage/decompress: raw DEFLATE (`de`), zlib (`zl`), gzip
(`gz`), LZO1X (`lzo`), a standalone LZ77 (`lz`), streaming and one-shot
APIs, a CLI, and multi-chip/multi-host sharded compression (`parallel`).

Layer map (device-first re-design of SURVEY.md §1):

    cli / bench                    parallel/ (mesh-sharded members)
        │                               │
    gz ── zl ── de ── lzo          ops/ (device kernels: lz77, bitpack,
        │        │                       inflate, checksum — XLA; the GPU
        │        │                       symbol decoder — Pallas/Triton)
        └── core/ (tables, canonical Huffman, bit I/O)
             └── native/ (C++: serial inflate fallback, checksum scalars,
                          LZO oracle)
"""

__version__ = "0.1.0"

from . import core  # noqa: F401


def __getattr__(name):
    # `rfc1951` is an alias of `de`, mirroring the reference's dune copy
    # rule that ships de.ml twice (lib/dune:21–25, rfc1951.opam).
    if name == "rfc1951":
        from . import de

        return de
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
