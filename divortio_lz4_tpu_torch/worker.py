"""Worker offload: a lazy singleton pool of threads or processes.

A copy of ``divortio_lz4_tpu/worker.py``. ``LZ4Worker.compress(data)``
returns a Future; ``.result()`` joins it.

- Buffer tasks (``compress``, ``decompress``, ``map_compress``) run the
  host frame codec (``frame.compress_frame`` / ``decompress_frame``), as
  in JAX.
- Stream tasks (``compress_stream``, ``decompress_stream``) pipe an
  iterable of chunks through ``CompressStream`` / ``DecompressStream``
  on a thread, with the port streams' default ``backend="device"`` and the
  keyword *device* ("cuda" unless the caller asks for the CPU), where JAX
  passes ``None``, its host codec, through.
- The thread pool is the default: the native host functions release the
  GIL. ``LZ4Worker.configure(use_processes=True)`` runs buffer tasks in a
  process pool of the ``spawn`` context: a forked child of a process that
  has touched CUDA (or runs threads) is unusable.
"""

from __future__ import annotations

import itertools
import threading
from concurrent.futures import (Executor, Future, ProcessPoolExecutor,
                                ThreadPoolExecutor)
from typing import Iterable, Iterator, Optional

from .config import DEFAULT_CONFIG, FrameConfig
from .frame import compress_frame, decompress_frame
from .stream import CompressStream, DecompressStream


class LZ4Worker:
    """Lazy singleton worker pool with task correlation: class-level entry
    points, lazily created backing workers, monotonic task ids, errors
    raised from the caller's Future."""

    _pool: Optional[Executor] = None
    _thread_pool: Optional[ThreadPoolExecutor] = None
    _lock = threading.Lock()
    _task_ids = itertools.count(1)
    max_workers: int = 4
    use_processes: bool = False

    @classmethod
    def configure(cls, max_workers: Optional[int] = None,
                  use_processes: Optional[bool] = None) -> None:
        """Reconfigure the pool (shuts down any existing one)."""
        with cls._lock:
            if cls._pool is not None:
                cls._pool.shutdown(wait=True)
                cls._pool = None
            if cls._thread_pool is not None:
                cls._thread_pool.shutdown(wait=True)
                cls._thread_pool = None
            if max_workers is not None:
                cls.max_workers = max_workers
            if use_processes is not None:
                cls.use_processes = use_processes

    @classmethod
    def _executor(cls) -> Executor:
        if cls._pool is None:
            with cls._lock:
                if cls._pool is None:
                    if cls.use_processes:
                        # spawn, not fork: see the module docstring.
                        import multiprocessing
                        cls._pool = ProcessPoolExecutor(
                            max_workers=cls.max_workers,
                            mp_context=multiprocessing.get_context("spawn"))
                    else:
                        cls._pool = ThreadPoolExecutor(
                            max_workers=cls.max_workers,
                            thread_name_prefix="lz4-worker")
        return cls._pool

    @classmethod
    def _thread_executor(cls) -> ThreadPoolExecutor:
        """Stream tasks always run on threads (closures aren't picklable)."""
        if not cls.use_processes:
            return cls._executor()  # type: ignore[return-value]
        if cls._thread_pool is None:
            with cls._lock:
                if cls._thread_pool is None:
                    cls._thread_pool = ThreadPoolExecutor(
                        max_workers=cls.max_workers,
                        thread_name_prefix="lz4-worker")
        return cls._thread_pool

    @classmethod
    def submit(cls, fn, *args, **kw) -> Future:
        next(cls._task_ids)  # monotonic correlation id
        return cls._executor().submit(fn, *args, **kw)

    @classmethod
    def _submit_thread(cls, fn, *args, **kw) -> Future:
        next(cls._task_ids)
        return cls._thread_executor().submit(fn, *args, **kw)

    # -- one-shot buffer tasks: the host frame codec ------------------------

    @classmethod
    def compress(cls, data, dictionary=None,
                 config: FrameConfig = DEFAULT_CONFIG,
                 backend: Optional[str] = None) -> Future:
        return cls.submit(compress_frame, data, dictionary, config,
                          backend=backend)

    @classmethod
    def decompress(cls, data, dictionary=None, verify_checksum: bool = True,
                   backend: Optional[str] = None) -> Future:
        return cls.submit(decompress_frame, data, dictionary, verify_checksum,
                          backend=backend)

    # -- stream tasks (the whole pipeline runs inside the worker) -----------

    @classmethod
    def compress_stream(cls, chunks: Iterable,
                        config: FrameConfig = DEFAULT_CONFIG,
                        dictionary=None,
                        backend: Optional[str] = "device", *,
                        device="cuda") -> Future:
        """Pipe *chunks* through a compress stream inside the worker;
        resolves to the whole frame's bytes."""
        def run() -> bytes:
            s = CompressStream(config, dictionary, backend, device=device)
            return b"".join(s.pipe(chunks))
        return cls._submit_thread(run)

    @classmethod
    def decompress_stream(cls, chunks: Iterable, dictionary=None,
                          verify_checksum: bool = True,
                          backend: Optional[str] = "device", *,
                          device="cuda") -> Future:
        def run() -> bytes:
            s = DecompressStream(dictionary, verify_checksum, backend,
                                 device=device)
            return b"".join(s.pipe(chunks))
        return cls._submit_thread(run)

    # -- batch map: many payloads across the pool ---------------------------

    @classmethod
    def map_compress(cls, buffers: Iterable,
                     config: FrameConfig = DEFAULT_CONFIG,
                     backend: Optional[str] = None) -> Iterator:
        """Compress many independent payloads in parallel across the pool."""
        futs = [cls.compress(b, config=config, backend=backend)
                for b in buffers]
        return (f.result() for f in futs)

    @classmethod
    def shutdown(cls) -> None:
        with cls._lock:
            if cls._pool is not None:
                cls._pool.shutdown(wait=True)
                cls._pool = None
            if cls._thread_pool is not None:
                cls._thread_pool.shutdown(wait=True)
                cls._thread_pool = None
