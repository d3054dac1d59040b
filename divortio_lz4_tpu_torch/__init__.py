"""divortio_lz4_tpu_torch — the PyTorch/CUDA port of divortio_lz4_tpu's
device frame codec.

The JAX package ``divortio_lz4_tpu`` stays the reference; this package sits
beside it and is held against it byte for byte. Three engines are ported:

- ``engine="split"`` (the default) on every frame configuration: 64 KB,
  256 KB, 1 MB and 4 MB blocks, linked or independent, with or without a
  dictionary, block checksums and a content checksum. ``FrameConfig()``,
  the reference's default (4 MB linked blocks), works as is.
- ``engine="pallas"``: encode of independent frames without a dictionary
  through the reference encoder's own greedy scan (frames byte-identical
  to the host encoder's), and decode of every frame by parsing LZ4 tokens
  on the device.
- ``engine="hybrid"``: encode only. Blocks up to 64 KB (independent,
  linked or with a dictionary) go through ``build_chains`` and the
  hybrid_encode walk kernel; bigger blocks through the split engine's
  big-block route. Linked frames with block checksums raise
  NotImplementedError, and so does hybrid decode.

  compress_frame, compress_frames       split: chain build on the device
                                        (torch ops) + host serialize (and
                                        host splice over 64 KB blocks);
                                        pallas: greedy_encode kernel + host
                                        frame assembly; hybrid: chain build
                                        + hybrid_encode kernel + host frame
                                        assembly
  decompress_frame, decompress_frames   split: host record parse + one of
                                        three CUDA kernels (compact, wire,
                                        chain); pallas: token_decode or
                                        token_decode_linked kernel
  compress_frames, decompress_frames    every frame's device work queued,
                                        one device-to-host fetch per batch

Every entry point runs on the card (``device="cuda"``) unless the caller
asks for the CPU (``device="cpu"``), where the kernels' plain PyTorch
versions run; without a GPU, ``"cuda"`` raises RuntimeError. The package
carries its own host layer (``config``, ``constants``, ``utils``, ``xxh``,
and ``host``, the ctypes binding of ``csrc/host_kernels.cpp``, built with
g++ at first use) and imports neither jax nor the JAX package.
"""

from .config import DEFAULT_CONFIG, FrameConfig
from .parallel.device import (
    compress_frame,
    compress_frames,
    decompress_frame,
    decompress_frames,
)

__all__ = [
    "FrameConfig", "DEFAULT_CONFIG",
    "compress_frame", "compress_frames",
    "decompress_frame", "decompress_frames",
]
