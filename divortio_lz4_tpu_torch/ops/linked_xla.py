"""Linked-block frame codec on the device: the encode as one batch of
rows, the decode as a loop over blocks carrying the 64 KB window, as torch
ops.

Port of ``divortio_lz4_tpu/ops/linked_xla.py`` (two ``lax.scan``s in the
JAX package).

``encode_linked_scan``. JAX's step i encodes ``[window_i | row_i]`` with
``hist_len = W`` and ``hist_start = W - filled_i``, then carries
``window_{i+1} = (window_i ++ row_i)[lens_i : lens_i + W]`` (the start
clamped to [0, block_size], as ``dynamic_slice`` clamps it) and
``filled_{i+1} = min(filled_i + lens_i, W)``. The carry never reads what
a step emitted, only the plaintext, so it unrolls in closed form:
``window_i`` is the last W bytes of ``init_window ++ row_0[:a_0] ++ ...
++ row_{i-1}[:a_{i-1}]`` (a the clamped lengths), and ``filled_i = S_i +
min(init_filled, W - max_{1<=k<=i} S_k)`` with S_i the sum of the first i
lengths. With every step's inputs known up front, the steps are
independent: one gather over the cumulative lengths builds every
``[window_i | row_i]`` row at JAX's width W + block_size, and one
``encode_xla.encode_blocks_batch`` call with a per-row ``hist_start``
encodes them all. Uneven and empty rows anywhere, blocks wider than the
window (only the tail of the previous row carries) and window bytes left
of ``W - init_filled`` (they shift along and never match) all follow
from that reading.

``decode_linked_scan``. Each step decodes one block with
``decode_xla.decode_blocks_batch`` against the window, or takes a stored
row as it is (``lax.cond``'s other branch: the row itself, out_len =
clen), then hands the window on as ``(window ++ out)[out_len : out_len +
64K]`` with the start clamped as ``dynamic_slice`` clamps it. Here the
carry is the decoded output, so the loop stays. The window, the lengths
and the slice start stay on the device; the stored flags are read once.
The block decode's own loops read their exit tests on the host
(``decode_blocks_batch.last_rounds``), so a block costs its orbit and
chase rounds in syncs; ``decode_linked_scan.last_syncs`` counts them.
"""

from __future__ import annotations

import torch

from ..constants import WINDOW_SIZE, block_bound
from .decode_xla import decode_blocks_batch
from .encode_xla import encode_blocks_batch

W = WINDOW_SIZE


def _window_rows(blocks: torch.Tensor, adv: torch.Tensor,
                 init_window: torch.Tensor) -> torch.Tensor:
    """u8[nb, W]: row i is the last W bytes of init_window followed by the
    first adv[j] bytes of every row j < i, gathered in one pass."""
    nb, bs = blocks.shape
    dev = blocks.device
    incl = torch.cumsum(adv, 0)
    # position p of window i is byte incl[i] - adv[i] + p of the stream
    # init_window ++ row_0[:adv_0] ++ row_1[:adv_1] ++ ...
    s = (incl - adv)[:, None] + torch.arange(W, dtype=torch.int64,
                                             device=dev)[None, :]
    r = (s - W).clamp(min=0)
    row = torch.searchsorted(incl, r, right=True).clamp(max=nb - 1)
    col = r - (incl - adv)[row]
    flat = torch.cat([init_window, blocks.reshape(-1)])
    return flat[torch.where(s < W, s, W + row * bs + col)]


def encode_linked_scan(blocks: torch.Tensor, lens: torch.Tensor,
                       init_window: torch.Tensor, init_filled,
                       block_size: int, use_fingerprints: bool = True):
    """Encode a chain of linked blocks (``encode_linked_scan``).

    blocks: int/u8[nb, block_size] plaintext rows (zero-padded); lens:
    int[nb] payload sizes (an empty row gives out_len 0); init_window:
    int/u8[W] the dictionary window, right-aligned; init_filled: how many
    of its trailing bytes are real history. Returns (outs u8[nb,
    block_bound(block_size)], out_lens i64[nb]) on blocks' device, zeros
    past each out_len: JAX's rows over [0, out_len) and its out_lens. One
    batch of [window | row] rows, not a loop (see the module docstring)."""
    nb, bs = blocks.shape
    if bs != block_size:
        raise ValueError(f"rows of {bs} bytes do not match "
                         f"block_size={block_size}")
    dev = blocks.device
    blocks = blocks.to(torch.uint8)
    window = init_window.to(device=dev, dtype=torch.uint8).reshape(-1)
    if window.numel() != W:
        raise ValueError(f"init_window must hold {W} bytes")
    lens = lens.to(device=dev, dtype=torch.int64)
    if nb == 0:
        return (torch.zeros((0, block_bound(block_size)), dtype=torch.uint8,
                            device=dev),
                torch.zeros(0, dtype=torch.int64, device=dev))
    windows = _window_rows(blocks, lens.clamp(0, block_size), window)
    # filled_i = S_i + min(init_filled, W - max_{1<=k<=i} S_k)
    incl = torch.cumsum(lens, 0)
    excl = incl - lens
    top = torch.cummax(incl, 0).values
    top = torch.cat([torch.full((1,), -(1 << 62), dtype=torch.int64,
                                device=dev), top[:-1]])
    filled = excl + torch.clamp(W - top, max=int(init_filled))
    out, out_len = encode_blocks_batch(torch.cat([windows, blocks], 1), lens,
                                       W, use_fingerprints, W - filled)
    out_len = torch.where(lens > 0, out_len, 0)
    keep = torch.arange(out.shape[1], device=dev)[None, :] < out_len[:, None]
    return torch.where(keep, out, 0), out_len


def decode_linked_scan(comp: torch.Tensor, lens: torch.Tensor,
                       stored: torch.Tensor, init_window: torch.Tensor,
                       block_size: int):
    """Decode a chain of linked blocks.

    comp: int[nb, M] rows of compressed bytes, or the raw payload where
    stored[i] is nonzero; lens: int[nb] wire sizes; init_window:
    int[WINDOW_SIZE], the dictionary right-aligned (zeros without one).
    Returns (outs u8[nb, block_size], out_lens i64[nb]) on comp's device.
    """
    nb, M = comp.shape
    dev = comp.device
    lens = lens.to(device=dev, dtype=torch.int64)
    window = init_window.to(device=dev, dtype=torch.uint8)
    outs = torch.zeros((nb, block_size), dtype=torch.uint8, device=dev)
    out_lens = torch.empty(nb, dtype=torch.int64, device=dev)
    span = torch.arange(W, dtype=torch.int64, device=dev)
    syncs = 1
    for i, is_stored in enumerate(stored.tolist()):
        if is_stored:
            k = min(M, block_size)
            outs[i, :k] = comp[i, :k]
            out_len = lens[i]
        else:
            out, ol = decode_blocks_batch(comp[i: i + 1], lens[i: i + 1],
                                          window, block_size)
            outs[i] = out[0]
            out_len = ol[0]
            syncs += decode_blocks_batch.last_rounds["syncs"]
        out_len = torch.where(lens[i] > 0, out_len, 0)
        out_lens[i] = out_len
        start = out_len.clamp(0, block_size)
        window = torch.cat([window, outs[i]])[span + start]
    decode_linked_scan.last_syncs = syncs
    return outs, out_lens


decode_linked_scan.last_syncs = None
