"""divortio_lz4_tpu_torch — the PyTorch/CUDA port of divortio_lz4_tpu.

The JAX package ``divortio_lz4_tpu`` stays the reference; this package sits
beside it and is held against it byte for byte. Every engine of the JAX
device codec is ported, with every route it takes:

- ``engine="split"`` (the port's default) on every frame configuration:
  64 KB, 256 KB, 1 MB and 4 MB blocks, linked or independent, with or
  without a dictionary, block checksums and a content checksum.
  ``FrameConfig()``, the reference's default (4 MB linked blocks), works
  as is.
- ``engine="pallas"``: encode of independent frames without a dictionary
  through the reference encoder's own greedy scan (frames byte-identical
  to the host encoder's; linked frames and dictionaries go to the XLA
  encoder, as in JAX), and decode of every frame by parsing LZ4 tokens on
  the device.
- ``engine="hybrid"``: blocks up to 64 KB encode through ``build_chains``
  and the hybrid_encode walk kernel, bigger ones through the split
  engine's big-block route; decode is the XLA decode, as in JAX.
- ``engine="xla"`` (the JAX package's single-frame default): the
  sort-based encoder and the two-phase decoder, torch ops on the device.

Linked frames with block checksums encode on the host (``frame.py``) on
every engine but split up to 64 KB, as in JAX.

  compress_frame, compress_frames       split: chain build on the device
                                        (torch ops) + host serialize (and
                                        host splice over 64 KB blocks);
                                        pallas: greedy_encode kernel + host
                                        frame assembly; hybrid: chain build
                                        + hybrid_encode kernel + host frame
                                        assembly; xla: torch ops + host or
                                        device assembly
  decompress_frame, decompress_frames   split: host record parse + one of
                                        three CUDA kernels (compact, wire,
                                        chain); pallas: token_decode or
                                        token_decode_linked kernel; xla and
                                        hybrid: torch ops
  compress_frames, decompress_frames    every frame's device work queued,
                                        one device-to-host fetch per batch
  LZ4Encoder, LZ4Decoder, CompressStream, DecompressStream,
  create_compress_stream, create_decompress_stream, compress_file,
  decompress_file                       streaming (``stream.py``): bursts
                                        of >= 4 full blocks on the device
                                        (chain builder + host serialize;
                                        compact or wire kernel), the rest
                                        on the host block codec
  parallel.ShardedCodec, parallel.make_mesh
                                        a frame's blocks sharded over a
                                        list of torch devices

Every device entry point runs on the card (``device="cuda"``) unless the
caller asks for the CPU (``device="cpu"``), where the kernels' plain
PyTorch versions run; without a GPU, ``"cuda"`` raises RuntimeError. The
streams default to ``backend="device"`` (JAX's default is its host codec;
pass ``"native"`` or ``"python"`` for the host codecs), and
``ShardedCodec`` to every CUDA device (``make_mesh()``; pass
``["cpu"] * n`` for the CPU).

Host and device names. Every name of the JAX package's facade resolves
here. The host names run on the CPU and need no device:

  compress, decompress                  the host frame codec
                                        (``frame.compress_frame`` /
                                        ``frame.decompress_frame``), JAX's
                                        ``compress`` / ``decompress``
  compress_raw, decompress_raw          one headerless block (``raw.py``)
  compress_string, decompress_string,
  compress_object, decompress_object    UTF-8 text and JSON (``types.py``)
  LZ4Worker buffer tasks (compress, decompress, map_compress)
  ensure_buffer, xxhash32, XXHash32, available_backends, get_backend,
  NATIVE_AVAILABLE                      (True once the host library
                                        builds; computed at first access)

The device names take ``device``: ``compress_frame(s)`` /
``decompress_frame(s)`` (the device codec, unlike JAX, whose top-level
``compress_frame`` is its host codec and whose device codec is
``device_compress_frame``), the streams, the async streams and
``compress_async`` / ``decompress_async`` (``aio.py``; JAX's signatures
plus ``device``), ``LZ4Worker``'s stream tasks, ``parallel.ShardedCodec``
and ``parallel.MultiHostCodec`` (``torch.distributed`` over gloo). The
CLI is ``python -m divortio_lz4_tpu_torch`` (``__main__.py``).

The package carries its own host layer (``config``, ``constants``,
``utils``, ``xxh``, ``frame`` and ``host``, the ctypes binding of
``csrc/host_kernels.cpp``, built with g++ at first use, never at import)
and imports neither jax nor the JAX package.
"""

from . import parallel
from .aio import (
    AsyncCompressStream,
    AsyncDecompressStream,
    compress_async,
    create_async_compress_stream,
    create_async_decompress_stream,
    decompress_async,
)
from .backends import available_backends, get_backend
from .config import DEFAULT_CONFIG, FrameConfig
from .frame import compress_frame as compress
from .frame import decompress_frame as decompress
from .parallel.device import (
    compress_frame,
    compress_frames,
    decompress_frame,
    decompress_frames,
)
from .stream import (
    CompressStream,
    DecompressStream,
    LZ4Decoder,
    LZ4Encoder,
    compress_file,
    create_compress_stream,
    create_decompress_stream,
    decompress_file,
)
from .raw import compress_raw, decompress_raw
from .scheduler import Scheduler
from .types import (
    compress_object,
    compress_string,
    decompress_object,
    decompress_string,
)
from .utils import ensure_buffer
from .worker import LZ4Worker
from .xxh import XXHash32, xxhash32


def __getattr__(name):
    # NATIVE_AVAILABLE builds the host library, so it is computed at its
    # first access, never at import.
    if name == "NATIVE_AVAILABLE":
        from .host import _lib
        try:
            _lib()
            available = True
        except Exception:
            available = False
        globals()["NATIVE_AVAILABLE"] = available
        return available
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "FrameConfig", "DEFAULT_CONFIG",
    "compress", "decompress",
    "compress_frame", "compress_frames",
    "decompress_frame", "decompress_frames",
    "compress_raw", "decompress_raw",
    "compress_string", "decompress_string",
    "compress_object", "decompress_object",
    "LZ4Encoder", "LZ4Decoder", "CompressStream", "DecompressStream",
    "create_compress_stream", "create_decompress_stream",
    "compress_file", "decompress_file",
    "compress_async", "decompress_async",
    "create_async_compress_stream", "create_async_decompress_stream",
    "AsyncCompressStream", "AsyncDecompressStream", "Scheduler",
    "LZ4Worker", "parallel", "xxhash32", "XXHash32", "ensure_buffer",
    "available_backends", "get_backend", "NATIVE_AVAILABLE",
]
