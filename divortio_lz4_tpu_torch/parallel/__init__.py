"""Device-parallel frame codecs: ``ShardedCodec`` over a list of torch
devices (``sharding.py``), ``MultiHostCodec`` across processes through
``torch.distributed`` (``multihost.py``); the single-device frame codec is
``device.py``."""

from .multihost import MultiHostCodec
from .sharding import ShardedCodec, make_mesh

__all__ = ["MultiHostCodec", "ShardedCodec", "make_mesh"]
