"""Frozen byte counts of the two decode kernels, the yardstick of their
roofline shares.

Each count is the bytes the kernel must move for one frame: every input
byte its arguments hold read once, every output byte written once, as
``chip_smoke.py:_bound_ms`` counted them when this benchmark was made.
The record format they count is the one the host parser wrote then
(``csrc/host_kernels.cpp:lz4t_parse_records2``: records of at most 128
output bytes, 8 bytes each on the compact path, 12 on the chain path).
The counts are worked out here from the frame itself, through the plain
reference's parse, so a later change to the program cannot move the
yardstick.
"""

from __future__ import annotations

import torch

SPAN = 128          # output bytes a record covers at most
CHAIN_SLACK = 256   # zero bytes after each chain's compressed image
COMPACT_MAX_BLOCK = 1 << 16


def _ceil128(x: torch.Tensor) -> torch.Tensor:
    return (x + SPAN - 1) // SPAN


def records(seq) -> torch.Tensor:
    """Records per sequence of a reference parse (``Sequences``)."""
    ll, ml, off = seq.lit_len, seq.match_len, seq.offset
    # a literal-only sequence (or a stored block): 128-byte slices
    n_last = _ceil128(ll)
    # one combined record
    one = (ll + ml <= SPAN) & (off >= ll + ml)
    # offset >= 128: literal chunks, the last absorbing the match head,
    # then the rest of the match in 128-byte slices
    chunks = torch.clamp((ll - 1) // SPAN, min=0)
    left = ll - SPAN * chunks
    take = torch.minimum(ml, SPAN - left)
    n_far = chunks + 1 + _ceil128(ml - take)
    # offset < 128: literal slices, then a doubling chain of copies, then
    # 128-byte slices
    n_near = _ceil128(ll)
    rest, d = ml.clone(), off.clone()
    for _ in range(8):
        step = (d < SPAN) & (rest > 0)
        n_near = n_near + step.long()
        rest = rest - torch.where(step, torch.minimum(rest, d), 0)
        d = torch.where(step, d * 2, d)
    n_near = n_near + _ceil128(rest)
    return torch.where(seq.last, n_last,
                       torch.where(one, 1, torch.where(off >= SPAN, n_far,
                                                       n_near)))


def records_per_block(seq, nb: int) -> torch.Tensor:
    """Records of each of *nb* blocks (int64 tensor)."""
    out = torch.zeros(nb, dtype=torch.int64, device=seq.block.device)
    return out.index_add_(0, seq.block, records(seq))


def compact_decode_bytes(sizes, n_rec: int, out_bytes: int) -> int:
    """compact_decode's bytes for one independent frame of blocks up to
    64 KB (*sizes*: its blocks' wire sizes; *n_rec*: its records): the
    blocks' wire bytes, the records (8 B), rec_off (8 B a block + 1),
    out_lens (8 B a block), and the decoded bytes."""
    nb = len(sizes)
    return sum(sizes) + 8 * n_rec + 8 * (nb + 1) + 8 * nb + out_bytes


def chain_decode_bytes(sizes, n_rec: int, out_bytes: int,
                       independent: bool) -> int:
    """chain_decode's bytes for one frame: every chain's compressed image
    with its slack, wire_off, rec_off and out_off (8 B a chain + 1 each),
    the records (12 B), and the decoded bytes. A linked frame is one
    chain, an independent frame a chain a block."""
    nc = len(sizes) if independent else 1
    return (sum(sizes) + CHAIN_SLACK * nc + 3 * 8 * (nc + 1) + 12 * n_rec
            + out_bytes)


def route(independent: bool, block_max: int) -> str:
    """The decode kernel the split engine ran, for frames without a
    dictionary, when this benchmark was made: independent frames of
    blocks up to 64 KB on compact_decode, linked frames and independent
    frames of 1-4 MB blocks on chain_decode (256 KB independent blocks
    took the wire kernel)."""
    if independent and block_max <= COMPACT_MAX_BLOCK:
        return "compact_decode"
    if independent and block_max == 1 << 18:
        return "wire_decode"
    return "chain_decode"
