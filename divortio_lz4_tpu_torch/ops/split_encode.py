"""Chain-direct encode: device candidate chains + host select/serialize.

Port of ``divortio_lz4_tpu/ops/split_encode.py`` (``encode_blocks_chain``,
``chain_select_serialize``, ``chain_select_serialize_meta`` and
``encode_block_split_host``; ``hybrid_max_bs`` is re-exported as there).
The device builds one u16 match distance per payload position
(``build_dist_chains``: on the card the CUDA builder, written straight
into the chain rows); the port's host library
(``csrc/host_kernels.cpp``, a copy of the JAX package's native functions)
greedy-selects, extends and serializes each block from its chain. The
packed i32 chain of ``build_chains`` (``next_pos << 16 | dist``) takes its
own serializer, as in JAX: cast to u16 it would keep only the distances,
and the u16 walk would then try every position before the next match
with that match's distance, which can find a different parse. The native
serializer is required: unlike the JAX module there is no pure-Python
fallback.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..constants import block_bound
from ..host import (chain_serialize16_meta_native, chain_serialize16_native,
                    chain_serialize_native)
from ..tracing import count, put, recording, span
from .hybrid_encode import CHAIN_CHUNK_ROWS, build_dist_chains, hybrid_max_bs

__all__ = ["encode_blocks_chain", "chain_select_serialize",
           "encode_block_split_host", "hybrid_max_bs"]


def encode_blocks_chain(work: np.ndarray, lens: np.ndarray, block_size: int,
                        hist_len: int = 0, hist_start=0, *,
                        device, exact: bool = False) -> torch.Tensor:
    """Build candidate chains for a batch of blocks on *device*.

    work: u8[nb, hist_len + block_size] ([history | payload] rows, host);
    lens: i32[nb] payload sizes; hist_start: the first valid history
    index, an int or an int[nb] per row. Returns uint16[nb, block_size] on
    *device* (match distance per payload position, 0 = none), queued
    asynchronously; fetch once and feed rows to chain_select_serialize.
    The default is the hashed production layout; ``exact=True`` gives
    exact-word chains, whose streams are byte-identical to the hybrid
    walk's (split_encode.py:58-85)."""
    nb, nw = work.shape
    if nw != hist_len + block_size or block_size % 1024:
        raise ValueError(f"work rows of {nw} bytes do not hold hist_len="
                         f"{hist_len} + block_size={block_size} "
                         "(block_size % 1024 == 0)")
    device = torch.device(device)
    with span("encode.chains"):
        hs = np.broadcast_to(np.asarray(hist_start, np.int64), (nb,)).copy()
        chains = torch.empty((nb, block_size), dtype=torch.uint16,
                             device=device)
        for i in range(0, nb, CHAIN_CHUNK_ROWS):
            rows = slice(i, min(i + CHAIN_CHUNK_ROWS, nb))
            count("hist_h2d_bytes", hist_len * (rows.stop - rows.start))
            if recording():
                count("row_pad_bytes", block_size * (rows.stop - rows.start)
                      - int(lens[rows].sum()))
            w = put(work[rows], device)
            ln = put(np.asarray(lens[rows], np.int64), device)
            h = put(hs[rows], device)
            build_dist_chains(w, ln, hist_len, h, hashed=not exact,
                              out=chains[rows])
    return chains


def chain_select_serialize(work: np.ndarray, hist_len: int, src_len: int,
                           chain: np.ndarray) -> np.ndarray:
    """Greedy-select/extend/serialize one block from its candidate chain.

    *work* = [history | payload] bytes with >= 8 readable bytes after
    hist_len + src_len. *chain* is the u16 distance form
    (``build_dist_chains``) or, any other dtype, the packed i32
    ``(next_pos << 16 | dist)`` form (``build_chains``), as in JAX.
    Returns the block's wire bytes."""
    out = np.empty(block_bound(src_len) + 16, np.uint8)
    work = np.ascontiguousarray(work, dtype=np.uint8)
    chain = np.asarray(chain)
    if chain.dtype == np.uint16:
        n = chain_serialize16_native(work, hist_len, src_len,
                                     np.ascontiguousarray(chain), out)
    else:
        n = chain_serialize_native(work, hist_len, src_len,
                                   np.ascontiguousarray(chain, np.int32), out)
    return out[:n]


def chain_select_serialize_meta(work: np.ndarray, hist_len: int,
                                src_len: int, chain: np.ndarray):
    """chain_select_serialize plus the big-block splicer's meta lanes
    (trailing-token position, trailing literal count, last-match stream
    offset or -1, last-match output anchor or -1). Returns (stream u8,
    meta i64[4])."""
    out = np.empty(block_bound(src_len) + 16, np.uint8)
    work = np.ascontiguousarray(work, dtype=np.uint8)
    dist16 = np.ascontiguousarray(chain, dtype=np.uint16)
    n, meta = chain_serialize16_meta_native(work, hist_len, src_len, dist16,
                                            out)
    return out[:n], meta


def encode_block_split_host(data, block_size=None, *, exact: bool = False,
                            device="cuda") -> np.ndarray:
    """One block in, its wire bytes out (numpy), for tests
    (split_encode.py:301-320); an empty block encodes to nothing.
    block_size defaults to len(data) rounded up to 1 KB."""
    dev = resolve_device(device)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    n = len(data)
    if n == 0:
        return np.empty(0, np.uint8)
    if block_size is None:
        block_size = -(-max(n, 1024) // 1024) * 1024
    work = np.zeros((1, block_size), np.uint8)
    work[0, :n] = data
    chains = encode_blocks_chain(work, np.array([n], np.int64), block_size,
                                 device=dev, exact=exact).cpu().numpy()
    padded = np.zeros(block_size + 8, np.uint8)
    padded[:n] = data
    return chain_select_serialize(padded, 0, n, chains[0])
