"""Multi-chip / multi-host sharded compression (SURVEY §2.11, §5.8).

The reference is single-threaded; this package is the from-scratch
parallel layer this build adds: device meshes, data-parallel member
sharding, order-preserving gather, and associative checksum combine.
"""

from .sharded import (  # noqa: F401
    make_mesh,
    sharded_gzip_compress,
    sharded_gzip_decompress,
    sharded_zlib_compress,
    compress_step_sharded,
)
