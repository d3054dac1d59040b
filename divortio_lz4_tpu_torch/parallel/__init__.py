"""Device-parallel frame codecs: ``ShardedCodec`` over a list of torch
devices (``sharding.py``), ``MultiHostCodec`` across processes through
``torch.distributed`` (``multihost.py``); the single-device frame codec is
``device.py``, whose JAX-named entry points and block-table scan the
package exports as the JAX package does."""

from .device import (
    device_compress_frame,
    device_decompress_frame,
    parse_block_index,
)
from .multihost import MultiHostCodec
from .sharding import ShardedCodec, make_mesh

__all__ = [
    "device_compress_frame",
    "device_decompress_frame",
    "parse_block_index",
    "MultiHostCodec",
    "ShardedCodec",
    "make_mesh",
]
