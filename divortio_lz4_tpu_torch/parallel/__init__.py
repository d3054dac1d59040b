"""Device-parallel frame codecs: ``ShardedCodec`` over a list of torch
devices (``sharding.py``); the single-device frame codec is ``device.py``."""

from .sharding import ShardedCodec, make_mesh

__all__ = ["ShardedCodec", "make_mesh"]
