"""Multi-chip sharding tests on the virtual 8-device CPU mesh.

The tier the reference lacks entirely (SURVEY §4 implication): the
sharded pipeline must produce byte-identical archives for every mesh
size, and collectives must compile+run.
"""

import gzip
import zlib

import numpy as np
import pytest

from decompress_tpu import parallel
from decompress_tpu.ops import lz77

MEMBER = 4096


@pytest.fixture(scope="module")
def payload():
    rng = np.random.default_rng(42)
    text = (b"sharded gzip member payload -- " * 2000)[:30000]
    noise = rng.integers(0, 256, 10000, dtype=np.uint8).tobytes()
    return text + noise + text[:5000]


def test_sharded_gzip_roundtrip_and_determinism(payload):
    outs = {}
    for n in (1, 2, 8):
        mesh = parallel.make_mesh(n)
        comp = parallel.sharded_gzip_compress(payload, 6, member_size=MEMBER, mesh=mesh)
        assert gzip.decompress(comp) == payload
        outs[n] = comp
    # order-preserving gather → byte-identical archive at any mesh size
    assert outs[1] == outs[2] == outs[8]


def test_sharded_gzip_no_mesh_equals_mesh(payload):
    comp0 = parallel.sharded_gzip_compress(payload, 6, member_size=MEMBER)
    comp8 = parallel.sharded_gzip_compress(
        payload, 6, member_size=MEMBER, mesh=parallel.make_mesh(8)
    )
    assert comp0 == comp8


def test_sharded_zlib_single_stream(payload):
    """One zlib stream with combined Adler-32, window reset per shard."""
    mesh = parallel.make_mesh(8)
    comp = parallel.sharded_zlib_compress(payload, 6, member_size=MEMBER, mesh=mesh)
    assert zlib.decompress(comp) == payload
    comp1 = parallel.sharded_zlib_compress(payload, 6, member_size=MEMBER,
                                           mesh=parallel.make_mesh(1))
    assert comp == comp1


def test_compress_step_collectives():
    """shard_map step: all-gathered sizes + psum'd totals."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = parallel.make_mesh(8)
    m, seg = 8, 1024
    rng = np.random.default_rng(0)
    data = np.zeros((m, lz77.HIST + seg), np.uint8)
    data[:, lz77.HIST :] = rng.integers(0, 32, (m, seg), np.uint8)
    d = lambda x, spec: jax.device_put(x, NamedSharding(mesh, spec))
    words, sizes_all, total_bits = parallel.compress_step_sharded(
        mesh,
        d(data, P("dp", None)),
        d(np.full(m, seg, np.int32), P("dp")),
        d(np.zeros(m, np.int32), P("dp")),
        d(np.ones(m, np.int32), P("dp")),
        level=6,
        seg_len=seg,
    )
    # [ndev_gathered, ndev_sharded]: column d = device d's gathered copy
    sizes = np.asarray(sizes_all)
    assert int(total_bits) == int(sizes[:, 0].sum())
    assert (sizes[:, 0] > 0).all()
    # every device gathered the same size vector
    assert (sizes == sizes[:, :1]).all()


def test_make_mesh_raises_on_too_few_devices():
    import jax

    n = len(jax.devices())
    assert parallel.make_mesh(n).devices.size == n
    with pytest.raises(ValueError, match=f"need {n + 1} cpu devices"):
        parallel.make_mesh(n + 1)


def test_graft_entry_api():
    import jax

    import __graft_entry__ as ge

    fn, args = ge.entry()
    words, totals = jax.jit(fn)(*args)
    assert (np.asarray(totals) > 0).all()
    ge.dryrun_multichip(8)


def test_multihost_index_assembly_matches_single_host():
    """The multihost assembly path rebuilds the FEXTRA index from
    gathered metadata; its building blocks must reproduce the
    single-host indexed archive byte-for-byte."""
    import numpy as np

    from decompress_tpu import gz
    from decompress_tpu.parallel import sharded

    data = (b"multihost index determinism " * 3000)[:60000]
    indexed = sharded.sharded_gzip_compress(data, 6, member_size=16384)
    plain, sizes, split_rows, ncmds = sharded.sharded_gzip_compress(
        data, 6, member_size=16384, index=False, return_meta=True)
    m = len(sizes)
    xt = sharded._build_index(m, sizes, split_rows, ncmds)
    assert xt is not None
    head0 = bytearray(plain[:10])
    head0[3] |= gz._FEXTRA
    rebuilt = bytes(head0) + xt + plain[10:]
    assert rebuilt == indexed
    assert sharded.sharded_gzip_decompress(rebuilt) == data


def test_shared_tree_mode():
    """All-reduced-frequencies shared dynamic tree (SURVEY §2
    parallelism table): one tree for all members, byte-identical
    across mesh sizes, oracle-decodable."""
    import gzip

    from decompress_tpu.parallel import sharded

    data = (b"shared tree determinism " * 4000)[:90000]
    archives = {}
    for nd in (1, 2, 8):
        mesh = sharded.make_mesh(nd)
        archives[nd] = sharded.sharded_gzip_compress(
            data, 6, member_size=16384, mesh=mesh, shared_tree=True)
    assert archives[1] == archives[2] == archives[8]
    assert gzip.decompress(archives[1]) == data
    assert sharded.sharded_gzip_decompress(archives[1]) == data
    # the shared header appears in every dynamic member: the tree is
    # genuinely shared (compare against per-member-tree archive)
    per_member = sharded.sharded_gzip_compress(data, 6, member_size=16384)
    assert archives[1] != per_member


def test_codec_config_wiring():
    """CodecConfig is consumed by the public entry points."""
    import zlib

    from decompress_tpu import de
    from decompress_tpu.parallel import sharded
    from decompress_tpu.utils.config import CodecConfig

    data = b"config object threading " * 500
    cfg = CodecConfig(level=6, segment_size=4096, window_bits=12)
    comp = de.deflate(data, config=cfg)
    assert zlib.decompressobj(-12).decompress(comp) == data  # window honored

    acfg = CodecConfig(level=6, member_size=4096, shared_tree=True)
    arch = sharded.sharded_gzip_compress(data, config=acfg)
    import gzip

    assert gzip.decompress(arch) == data
    with pytest.raises(ValueError):
        de.deflate(data, config=CodecConfig(level=99))
