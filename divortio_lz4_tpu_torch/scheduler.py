"""Concurrency-limited FIFO task scheduler.

A copy of ``divortio_lz4_tpu/scheduler.py``: at most *concurrency* tasks
run at once and waiting tasks queue in FIFO order; between chunks the
async streams yield the event loop here.
"""

from __future__ import annotations

import asyncio
from typing import Awaitable, Callable, TypeVar

T = TypeVar("T")


class Scheduler:
    def __init__(self, concurrency: int = 1):
        if concurrency < 1:
            raise ValueError("LZ4: Scheduler concurrency must be >= 1")
        self.concurrency = concurrency
        self._sem: asyncio.Semaphore | None = None

    def _semaphore(self) -> asyncio.Semaphore:
        # Bound lazily to the running loop (a Semaphore made outside a loop
        # cannot be reused across loops).
        if self._sem is None:
            self._sem = asyncio.Semaphore(self.concurrency)
        return self._sem

    async def schedule(self, task: Callable[[], Awaitable[T]]) -> T:
        """Run *task* when a slot frees up; FIFO under contention."""
        async with self._semaphore():
            return await task()

    async def run(self, fn: Callable[..., T], *args, **kw) -> T:
        """Schedule a synchronous callable onto the default executor."""
        loop = asyncio.get_running_loop()
        async with self._semaphore():
            return await loop.run_in_executor(None, lambda: fn(*args, **kw))
