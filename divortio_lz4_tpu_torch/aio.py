"""Async streams and one-shot async helpers.

A copy of ``divortio_lz4_tpu/aio.py``: ``AsyncCompressStream`` /
``AsyncDecompressStream`` run each chunk's work on an executor thread
through a ``Scheduler`` (the native host functions release the GIL, and a
device burst waits on the card), and ``compress_async`` /
``decompress_async`` feed a whole buffer through them in *chunk_size*
slices, yielding the event loop between chunks.

One change from JAX, as in the port's streams (``stream.py``): *backend*
defaults to ``"device"`` (bursts of full blocks on *device*, the rest on
the host block codec) where JAX passes ``None``, its host codec, through;
``"native"`` or ``"python"`` asks for a host codec. The keyword *device*
("cuda" unless the caller asks for the CPU) goes to ``LZ4Encoder`` /
``LZ4Decoder``; "cuda" without a GPU raises RuntimeError when the stream
is built.
"""

from __future__ import annotations

import asyncio
from typing import AsyncIterator, Iterable, Optional, Union

from .config import DEFAULT_CONFIG, FrameConfig
from .scheduler import Scheduler
from .stream import LZ4Decoder, LZ4Encoder
from .utils import ensure_buffer


class AsyncCompressStream:
    """Async transform stream: chunks in, frame bytes out."""

    def __init__(self, config: FrameConfig = DEFAULT_CONFIG, dictionary=None,
                 scheduler: Optional[Scheduler] = None,
                 backend: Optional[str] = "device", *, device="cuda"):
        self._enc = LZ4Encoder(config, dictionary, backend, device=device)
        self._sched = scheduler or Scheduler(1)

    async def write(self, chunk) -> bytes:
        parts = await self._sched.run(self._enc.add, chunk)
        return b"".join(parts)

    async def flush(self) -> bytes:
        parts = await self._sched.run(self._enc.finish)
        return b"".join(parts)

    async def pipe(self, chunks) -> AsyncIterator[bytes]:
        async for c in _aiter(chunks):
            out = await self.write(c)
            if out:
                yield out
        tail = await self.flush()
        if tail:
            yield tail


class AsyncDecompressStream:
    """Async transform stream: frame bytes in, plaintext chunks out."""

    def __init__(self, dictionary=None, verify_checksum: bool = True,
                 scheduler: Optional[Scheduler] = None,
                 backend: Optional[str] = "device", *, device="cuda"):
        self._dec = LZ4Decoder(dictionary, verify_checksum, backend,
                               device=device)
        self._sched = scheduler or Scheduler(1)

    async def write(self, chunk) -> bytes:
        parts = await self._sched.run(self._dec.update, chunk)
        return b"".join(bytes(p) for p in parts)

    async def flush(self) -> bytes:
        return b""  # frames self-terminate

    async def pipe(self, chunks) -> AsyncIterator[bytes]:
        async for c in _aiter(chunks):
            out = await self.write(c)
            if out:
                yield out


def create_async_compress_stream(config: FrameConfig = DEFAULT_CONFIG,
                                 dictionary=None,
                                 scheduler: Optional[Scheduler] = None,
                                 backend: Optional[str] = "device", *,
                                 device="cuda") -> AsyncCompressStream:
    return AsyncCompressStream(config, dictionary, scheduler, backend,
                               device=device)


def create_async_decompress_stream(dictionary=None,
                                   verify_checksum: bool = True,
                                   scheduler: Optional[Scheduler] = None,
                                   backend: Optional[str] = "device", *,
                                   device="cuda") -> AsyncDecompressStream:
    return AsyncDecompressStream(dictionary, verify_checksum, scheduler,
                                 backend, device=device)


async def compress_async(data, dictionary=None,
                         config: FrameConfig = DEFAULT_CONFIG,
                         chunk_size: int = 1 << 22,
                         backend: Optional[str] = "device", *,
                         device="cuda") -> bytes:
    """One-shot async compress: *data* through an AsyncCompressStream in
    *chunk_size* slices."""
    buf = ensure_buffer(data)
    stream = AsyncCompressStream(config, dictionary, backend=backend,
                                 device=device)
    parts = []
    for i in range(0, max(len(buf), 1), chunk_size):
        parts.append(await stream.write(buf[i: i + chunk_size]))
    parts.append(await stream.flush())
    return b"".join(parts)


async def decompress_async(data, dictionary=None,
                           verify_checksum: bool = True,
                           chunk_size: int = 1 << 22,
                           backend: Optional[str] = "device", *,
                           device="cuda") -> bytes:
    """One-shot async decompress: *data* through an AsyncDecompressStream
    in *chunk_size* slices."""
    buf = ensure_buffer(data)
    stream = AsyncDecompressStream(dictionary, verify_checksum,
                                   backend=backend, device=device)
    parts = []
    for i in range(0, max(len(buf), 1), chunk_size):
        parts.append(await stream.write(buf[i: i + chunk_size]))
    return b"".join(parts)


async def _aiter(it: Union[Iterable, AsyncIterator]):
    if hasattr(it, "__aiter__"):
        async for x in it:
            yield x
    else:
        for x in it:
            await asyncio.sleep(0)
            yield x
