"""Device kernels: checksums, LZ77, bit packing, inflate.

Plain jnp/XLA graphs, plus one hand-written kernel: the GPU symbol
decoder (inflate_triton.py, Pallas on the Triton route), whose tests run
it in interpret mode on the CPU."""

from ..utils import enable_compile_cache as _enable_cache

_enable_cache()

from . import checksum  # noqa: F401,E402
