"""divortio_lz4_tpu_torch — the PyTorch/CUDA port of divortio_lz4_tpu's
device frame codec.

The JAX package ``divortio_lz4_tpu`` stays the reference; this package sits
beside it and is held against it byte for byte. It covers the split engine
on frames of independent blocks of up to 64 KB:

  compress_frame, compress_frames       chain build on the device (torch
                                        ops) + native host serialize
  decompress_frame, decompress_frames   native host record parse + the
                                        CUDA compact decode kernel

Every entry takes an explicit ``device`` ("cpu" or "cuda"); on the CPU the
kernel's plain PyTorch version runs. Configurations are the JAX package's
``FrameConfig``; linked frames, larger blocks and other engines raise
NotImplementedError. The package imports the JAX package's host modules
(config, constants, utils, xxh, native) and never imports jax.
"""

from divortio_lz4_tpu.config import DEFAULT_CONFIG, FrameConfig

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
