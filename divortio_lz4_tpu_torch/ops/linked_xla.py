"""Linked-block frame decode on the device: a loop over blocks carrying the
64 KB window, as torch ops.

Port of ``divortio_lz4_tpu/ops/linked_xla.py:decode_linked_scan`` (a
``lax.scan`` in the JAX package). Each step decodes one block with
``decode_xla.decode_blocks_batch`` against the window, or takes a stored
row as it is (``lax.cond``'s other branch: the row itself, out_len =
clen), then hands the window on as ``(window ++ out)[out_len : out_len +
64K]`` with the start clamped as ``dynamic_slice`` clamps it. The window,
the lengths and the slice start stay on the device; the stored flags are
read once. The block decode's own loops read their exit tests on the host
(``decode_blocks_batch.last_rounds``), so a block costs its orbit and
chase rounds in syncs; ``decode_linked_scan.last_syncs`` counts them.

``encode_linked_scan`` has no caller in the JAX package (the linked
encode is data-parallel, ``parallel/device.py:_compress_linked``) and is
not ported.
"""

from __future__ import annotations

import torch

from ..constants import WINDOW_SIZE
from .decode_xla import decode_blocks_batch

W = WINDOW_SIZE


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
