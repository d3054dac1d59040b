"""divortio_lz4_tpu_torch — the PyTorch/CUDA port of divortio_lz4_tpu's
device frame codec.

The JAX package ``divortio_lz4_tpu`` stays the reference; this package sits
beside it and is held against it byte for byte. It covers the split engine
on every frame configuration: 64 KB, 256 KB, 1 MB and 4 MB blocks, linked
or independent, with or without a dictionary, block checksums and a content
checksum. ``FrameConfig()``, the reference's default (4 MB linked blocks),
works as is.

  compress_frame, compress_frames       chain build on the device (torch
                                        ops) + native host serialize (and
                                        host splice over 64 KB blocks)
  decompress_frame, decompress_frames   native host record parse + one of
                                        three CUDA kernels: compact (<= 64
                                        KB independent), wire (256 KB
                                        independent), chain (linked, 1-4 MB)

Every entry takes an explicit ``device`` ("cpu" or "cuda"); on the CPU the
kernels' plain PyTorch versions run. Configurations are the JAX package's
``FrameConfig``; engines other than "split" raise NotImplementedError. The
package imports the JAX package's host modules (config, constants, utils,
xxh, native) and never imports jax.
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
