"""Multi-host bring-up and archive assembly (SURVEY §2.11, §5.8).

The reference has no distributed runtime; this module supplies the
multi-controller layer this build adds:

* :func:`initialize` — `jax.distributed` bring-up (same program on
  every host; the global mesh then spans every card of every host).
* :func:`sharded_gzip_compress_multihost` — each host compresses the
  members of its local shard (device-parallel within the host via
  parallel.sharded), then per-member byte sizes and payloads are
  exchanged with a process-level all-gather and the archive is
  assembled **by global member index** — deterministic bytes for any
  host count, never arrival order.

Single-host degenerates to the plain sharded path, so this module is
exercised by the normal test suite; the process-gather branch follows
`jax.experimental.multihost_utils` and activates when
``jax.process_count() > 1``.
"""

from __future__ import annotations

import numpy as np

from .. import de
from ..gz import _FEXTRA
from . import sharded


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Bring up the JAX multi-controller runtime (idempotent)."""
    import jax

    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    # NOTE: do not touch jax.process_count()/devices() first — that
    # initializes the local backend and makes distributed.initialize
    # fail afterwards.
    try:
        jax.distributed.initialize(**kwargs)
    except (RuntimeError, ValueError) as e:
        if "already" not in str(e).lower() and coordinator_address is not None:
            raise  # real multi-host bring-up failure: surface it
        # single-process environments (tests, one-host runs)


def _local_member_range(total_members: int) -> tuple[int, int]:
    """Contiguous member range owned by this process (block layout)."""
    import jax

    p = jax.process_count()
    i = jax.process_index()
    per = -(-total_members // p)
    lo = min(i * per, total_members)
    hi = min(lo + per, total_members)
    return lo, hi


def sharded_gzip_compress_multihost(
    data,
    level: int = 6,
    *,
    member_size: int = de.SEGMENT_SIZE,
    mesh=None,
) -> bytes:
    """Whole-archive gzip compress across all hosts.

    ``data`` is the full input on every host (or the local shard plus
    identical metadata — the member range owned by each host is a pure
    function of process index).  Returns the complete archive on every
    host, byte-identical everywhere.
    """
    import jax

    arr = de._np_u8(data)
    if arr.size == 0 or jax.process_count() == 1:
        return sharded.sharded_gzip_compress(
            arr, level, member_size=member_size, mesh=mesh
        )

    from jax.experimental import multihost_utils

    total = max(1, (arr.size + member_size - 1) // member_size)
    lo, hi = _local_member_range(total)
    local = arr[lo * member_size : hi * member_size]
    if local.size:
        (local_arch, local_sizes, local_splits,
         local_ncmds) = sharded.sharded_gzip_compress(
            local, level, member_size=member_size, mesh=mesh,
            index=False, return_meta=True,
        )
    else:
        local_arch, local_sizes, local_splits, local_ncmds = b"", [], [], []

    # order-preserving process gather: fixed-width buffers keyed by
    # process index; sizes first, then padded payloads
    size = np.array([len(local_arch)], np.int64)
    all_sizes = multihost_utils.process_allgather(size)
    cap = int(all_sizes.max())
    buf = np.zeros(cap, np.uint8)
    buf[: len(local_arch)] = np.frombuffer(local_arch, np.uint8)
    gathered = multihost_utils.process_allgather(buf)
    parts = [
        gathered[p, : int(all_sizes[p, 0])].tobytes()
        for p in range(jax.process_count())
    ]
    archive = b"".join(parts)  # by process index == by member range

    # Gather per-member metadata and rebuild the SAME FEXTRA member
    # index the single-host path writes, so archive bytes are identical
    # for any host count (and parallel decode keeps working).
    per = -(-total // jax.process_count())
    width = 2 + 3 * (sharded.N_SPLITS - 1)
    meta = np.zeros((per, width), np.int64)
    for j, s in enumerate(local_sizes):
        meta[j, 0] = s
        meta[j, 1] = local_ncmds[j]
        meta[j, 2:] = [v for tri in local_splits[j] for v in tri]
    all_meta = multihost_utils.process_allgather(meta)  # [P, per, width]
    sizes, split_rows, ncmds = [], [], []
    for p in range(jax.process_count()):
        plo = min(p * per, total)
        phi = min(plo + per, total)
        for j in range(phi - plo):
            sizes.append(int(all_meta[p, j, 0]))
            ncmds.append(int(all_meta[p, j, 1]))
            row = all_meta[p, j, 2:].reshape(-1, 3)
            split_rows.append([tuple(int(v) for v in t) for t in row])
    xt = sharded._build_index(total, sizes, split_rows, ncmds)
    if xt is not None:
        head0 = bytearray(archive[:10])
        head0[3] |= _FEXTRA
        archive = bytes(head0) + xt + archive[10:]
    return archive
