"""Frame assembly and block concatenation on the device, as torch ops.

Port of ``divortio_lz4_tpu/ops/assemble_xla.py`` (``assemble_blocks``,
``concat_blocks``), plain XLA in the JAX package. Both map every output
byte to its block by a zone fill: the blocks' start positions scattered
into the byte space, filled forward with a cummax, then one gather per
byte. Gathers clamp as JAX's ``mode="clip"`` and the scatters keep one
spare slot for ``mode="drop"`` (``ops/decode_xla.py``); block starts are
distinct (every kept block has bytes), so no kept slot is written twice.
"""

from __future__ import annotations

import torch

from ..constants import UNCOMPRESSED_FLAG
from .decode_xla import _slot


def _zone_fill(starts: torch.Tensor, keep: torch.Tensor, out_cap: int):
    """(block, offset in its record) of every byte of [0, out_cap): block
    -1 before the first kept start."""
    dev = starts.device
    nb = starts.shape[0]
    jW = torch.arange(out_cap, dtype=torch.int64, device=dev)
    marker = torch.full((out_cap + 1,), -1, dtype=torch.int64, device=dev)
    marker.scatter_(0, _slot(torch.where(keep, starts, out_cap), out_cap),
                    torch.arange(nb, dtype=torch.int64, device=dev))
    marker = marker[:out_cap]
    fill_pos = torch.cummax(torch.where(marker >= 0, jW, -1), 0).values
    blk = marker[fill_pos.clamp(0, out_cap - 1)]
    return jW, blk, jW - fill_pos


def assemble_blocks(outs: torch.Tensor, out_lens: torch.Tensor,
                    work: torch.Tensor, lens: torch.Tensor, out_cap: int):
    """The block section of an LZ4 frame (size words, compressed or stored
    payloads, the EndMark) on the device.

    outs: int[nb, W] compressed rows; out_lens: int[nb]; work: int[nb, BS]
    the payloads (the stored blocks' source); lens: int[nb] payload sizes
    (0 rows are skipped); out_cap: the result's capacity (>= the worst
    case + 4). Returns (bytes u8[out_cap], total i64 scalar tensor)."""
    nb, W = outs.shape
    BS = work.shape[1]
    dev = outs.device
    out_lens = out_lens.to(device=dev, dtype=torch.int64)
    lens = lens.to(device=dev, dtype=torch.int64)

    stored = (out_lens <= 0) | (out_lens >= lens)
    data_len = torch.where(lens > 0, torch.where(stored, lens, out_lens), 0)
    wire = torch.where(lens > 0, 4 + data_len, 0)
    starts = torch.cumsum(wire, 0) - wire
    total = wire.sum() + 4
    size_word = torch.where(stored, lens | UNCOMPRESSED_FLAG, out_lens) \
        & 0xFFFFFFFF

    jW, blk, r = _zone_fill(starts, lens > 0, out_cap)
    blk_c = blk.clamp(0, nb - 1)
    size_byte = (size_word[blk_c] >> (8 * r.clamp(0, 3))) & 0xFF
    comp_byte = outs[blk_c, (r - 4).clamp(0, W - 1)].long()
    raw_byte = work[blk_c, (r - 4).clamp(0, BS - 1)].long()
    data_byte = torch.where(stored[blk_c], raw_byte, comp_byte)
    byte = torch.where(r < 4, size_byte, data_byte)
    in_record = (blk >= 0) & (r < 4 + data_len[blk_c])
    byte = torch.where((jW < total - 4) & in_record, byte, 0)
    byte = torch.where(jW < total, byte, 0)
    return byte.to(torch.uint8), total


def concat_blocks(rows: torch.Tensor, row_lens: torch.Tensor, out_cap: int):
    """Padded rows into one contiguous array: rows int[nb, cap], row_lens
    int[nb]. Returns (flat u8[out_cap], total i64 scalar tensor); a row
    length past cap repeats the row's last byte, as JAX's clip does."""
    nb, cap = rows.shape
    row_lens = row_lens.to(device=rows.device, dtype=torch.int64)
    starts = torch.cumsum(row_lens, 0) - row_lens
    total = row_lens.sum()
    jW, blk, r = _zone_fill(starts, row_lens > 0, out_cap)
    byte = rows[blk.clamp(0, nb - 1), r.clamp(0, cap - 1)]
    return torch.where(jW < total, byte, 0).to(torch.uint8), total
