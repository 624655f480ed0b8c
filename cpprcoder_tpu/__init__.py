"""cpprcoder_tpu — a lossless compression codec framework on accelerators.

Brand-new JAX/XLA implementation, with CUDA kernels for the GPU, of the capabilities of the reference
C++ codec suite (taqu/cpprcoder): static & adaptive byte-wise range coders,
interleaved rANS, canonical Huffman, BWT/MTF block-sort transform, ASE, and
an LZ4-format LZ77 compressor — re-designed around K-lane interleaved coder
states, shared adaptive models with batched updates, prefix-doubling sorts,
and mesh-sharded block parallelism.

Public API:
    compress(data, codec="rans", **opts) -> bytes
    decompress(blob, codec="rans", **opts) -> bytes
    get_codec(name) -> Codec
    list_codecs() -> list[str]
"""

from cpprcoder_tpu.codecs import (  # noqa: F401
    get_codec,
    list_codecs,
    compress,
    decompress,
)

__version__ = "0.1.0"
