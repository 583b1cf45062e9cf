"""Framework configuration (SURVEY §5.6 parity).

The reference exposes every knob as a function argument (level 0–9
de.ml:4462–4477, window bits 8–15 de.ml:331–333, queue size
de.ml:2286–2295, io_buffer_size de.ml:207, gzip metadata gz.ml:859–870,
zlib ``~dynamic`` zl.ml:560).  This dataclass mirrors those knobs and
adds the device ones (segment/batch geometry, mesh axes, archive
indexing), so large deployments can carry one config object instead of
threading arguments.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class CodecConfig:
    # reference-parity knobs
    level: int = 6                 # 0 stored … 9 max effort (de.ml:4462)
    window_bits: int = 15          # 8..15 (de.ml:331–333)
    queue_capacity: int = 4096     # command ring size (de.ml:2286)
    io_buffer_size: int = 65536    # de.ml:207
    dynamic_blocks: bool = True    # zl.ml:560 ``~dynamic``

    # device knobs
    segment_size: int | None = None   # device segment payload (de.SEGMENT_SIZE)
    device_batch: int | None = None   # segments per device call
    member_size: int | None = None    # sharded gzip member payload
    write_index: bool = True          # FEXTRA member index for parallel decode
    shared_tree: bool = False         # all-reduced-frequencies shared tree
    mesh_axis: str = "dp"
    platform: str | None = None       # override jax platform selection

    def validate(self) -> "CodecConfig":
        if not 0 <= self.level <= 12:
            raise ValueError("level must be in 0..12")
        if not 8 <= self.window_bits <= 15:
            raise ValueError("window bits must be in 8..15")
        if self.queue_capacity & (self.queue_capacity - 1):
            raise ValueError("queue capacity must be a power of two")
        return self


DEFAULT_CONFIG = CodecConfig()
