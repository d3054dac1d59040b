"""Block-level codecs of the port: the scalar Python oracle
(``block_ref``), the CUDA kernels' wrappers with their plain PyTorch
versions, and the XLA engine's torch ops. As in the JAX package, the
package exports the oracle's two block functions."""

from .block_ref import compress_block_ref, decompress_block_ref

__all__ = ["compress_block_ref", "decompress_block_ref"]
