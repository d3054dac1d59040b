"""Multi-process corpus codec over ``torch.distributed``.

Port of ``divortio_lz4_tpu/parallel/multihost.py``. Each process
compresses its contiguous ``shard_bounds`` slice of the corpus through a
``ShardedCodec`` on its own devices; the shards' frame sizes, then the
padded frames, are all-gathered, and rank 0 joins them in corpus order.
Every shard is an independent, self-terminating LZ4 frame, so the
concatenation decodes with any spec decoder (the port's streams and host
``decompress`` read concatenated frames). Decode splits the stream into
frames (``split_frames``), decodes each process's contiguous share of
them on its devices, and all-gathers the plaintext in order on every rank.

Differences from JAX, by design:

- The all-gathers go through ``torch.distributed`` on the **gloo** backend
  with CPU tensors, where JAX uses ``multihost_utils.process_allgather``
  on host arrays. The payloads are host bytes in both; NCCL would refuse
  two ranks on one GPU.
- ``maybe_distributed_init`` reads torch's env names (``MASTER_ADDR``,
  ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), not JAX's
  (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``).
- ``MultiHostCodec`` takes ``devices=`` (default ``make_mesh()``, every
  CUDA device the process sees, as JAX's local mesh); pass
  ``["cpu"] * n`` for the CPU.

With one process (no process group) it is the single-process path.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..config import FrameConfig
from ..constants import SKIPPABLE_MAGIC_MAX, SKIPPABLE_MAGIC_MIN
from ..utils import ensure_buffer, read_u32le
from .device import parse_block_index
from .sharding import ShardedCodec


def _group():
    """(world size, rank) of the default process group, (1, 0) without
    one."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def maybe_distributed_init() -> bool:
    """Initialize ``torch.distributed`` (gloo) when the env asks for more
    than one process.

    Reads torch's env names, not JAX's: ``WORLD_SIZE`` > 1 initialises the
    default process group with ``backend="gloo"`` from ``MASTER_ADDR``,
    ``MASTER_PORT`` and ``RANK`` (``init_method="env://"``). Returns True
    when the process group has more than one rank (also when it was
    initialised before), False otherwise. Safe to call repeatedly.
    """
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    world = int(os.environ.get("WORLD_SIZE", "1") or "1")
    if world > 1:
        dist.init_process_group("gloo", init_method="env://",
                                world_size=world,
                                rank=int(os.environ.get("RANK", "0")))
        return True
    return False


def shard_bounds(total: int, nshards: int, i: int) -> tuple[int, int]:
    """Contiguous even split of [0, total) into nshards pieces."""
    base = total // nshards
    rem = total % nshards
    start = i * base + min(i, rem)
    return start, start + base + (1 if i < rem else 0)


def split_frames(buf: np.ndarray) -> list[tuple[int, int]]:
    """Split a concatenated-frames stream into [start, end) frame spans.

    A host scan of the size words only (``parse_block_index``); skippable
    frames are skipped. The spans are the unit of cross-process decode.
    """
    frames: list[tuple[int, int]] = []
    pos = 0
    n = len(buf)
    while pos + 4 <= n:
        word = read_u32le(buf, pos)
        if SKIPPABLE_MAGIC_MIN <= word <= SKIPPABLE_MAGIC_MAX:
            if pos + 8 > n:
                raise ValueError("LZ4: Malformed Input")
            pos += 8 + read_u32le(buf, pos + 4)
            continue
        header, _, tail = parse_block_index(buf[pos:])
        end = pos + tail + (4 if header["content_checksum"] else 0)
        frames.append((pos, end))
        pos = end
    return frames


def _allgather_bytes(local: np.ndarray, nproc: int, floor: int = 0) -> list:
    """Every rank's *local* uint8 array, in rank order: the sizes, then the
    payloads padded to the largest, as CPU tensors through the default
    (gloo) process group."""
    dist = torch.distributed
    size = torch.tensor([len(local)], dtype=torch.int64)
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(nproc)]
    dist.all_gather(sizes, size)
    sizes = [int(s) for s in sizes]
    cap = max(max(sizes), floor)
    padded = torch.zeros(cap, dtype=torch.uint8)
    padded[: len(local)] = torch.from_numpy(np.ascontiguousarray(local))
    gathered = [torch.empty(cap, dtype=torch.uint8) for _ in range(nproc)]
    dist.all_gather(gathered, padded)
    return [g[:s].numpy() for g, s in zip(gathered, sizes)]


class MultiHostCodec:
    """Multi-process codec: per-process shard compression, ordered
    assembly on rank 0; per-process frame decode, gathered on every
    rank."""

    def __init__(self, config: Optional[FrameConfig] = None,
                 use_fingerprints: bool = True, *, devices=None):
        self.nproc, self.pid = _group()
        # This process's devices only (default: every CUDA device it sees),
        # on ShardedCodec's default engine, "xla", as in JAX.
        self.codec = ShardedCodec(devices, config, use_fingerprints)

    def compress_corpus(self, data) -> Optional[bytes]:
        """Compress *data* across the processes; returns the whole byte
        stream on rank 0 (None elsewhere). *data* must be the same on every
        process (e.g. a shared filesystem read)."""
        raw = ensure_buffer(data)
        start, end = shard_bounds(len(raw), self.nproc, self.pid)
        local_frame = np.asarray(self.codec.compress(raw[start:end]),
                                 dtype=np.uint8)
        if self.nproc == 1:
            return bytes(local_frame)
        parts = _allgather_bytes(local_frame, self.nproc)
        if self.pid != 0:
            return None
        return b"".join(p.tobytes() for p in parts)

    def decompress_corpus(self, stream) -> np.ndarray:
        """Decode a concatenated-frames stream across the processes: the
        frames split into contiguous shares, each process decodes its share
        on its devices (``ShardedCodec``), and the plaintext shares are
        gathered in order. Returns the whole plaintext on every rank."""
        buf = ensure_buffer(stream)
        frames = split_frames(buf)
        start, end = shard_bounds(len(frames), self.nproc, self.pid)
        local_parts = [
            np.asarray(self.codec.decompress(np.array(buf[a:b])),
                       dtype=np.uint8)
            for a, b in frames[start:end]]
        local = (np.concatenate(local_parts) if local_parts
                 else np.empty(0, np.uint8))
        if self.nproc == 1:
            return local
        return np.concatenate(_allgather_bytes(local, self.nproc, 1))
