"""A plain LZ4 frame decoder, written from the LZ4 frame and block format
specifications (lz4_Frame_format.md, lz4_Block_format.md).

It shares no code with the program under test and reads nothing the
program made but the frame it judges. The frame's layout is read in plain
Python; its blocks are decoded with plain PyTorch operations, so the same
code runs on the CPU in the tests and on the card after a benchmark's
window:

1. Every byte position of the blocks is read as if a sequence started
   there (token, literal length, offset, match length, where the next
   token would be). The real tokens are the positions reachable from each
   block's first byte, found by pointer doubling.
2. Literals are placed at their output positions; every match byte points
   at the byte ``offset`` before it, and pointer doubling resolves each
   byte to the literal it copies.

Besides the bytes, it reports every way in which the frame breaks the
formats: header fields, block sizes, the block format's end rules, matches
that reach before their block in an independent frame, checksums. It
decodes no dictionary frame.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from .xxh32 import xxh32

MAGIC = 0x184D2204
BLOCK_MAX = {4: 1 << 16, 5: 1 << 18, 6: 1 << 20, 7: 1 << 22}
MIN_MATCH = 4
LAST_LITERALS = 5       # the last 5 bytes of a block are literals
MFLIMIT = 12            # the last match starts 12 or more bytes before


class FrameError(ValueError):
    """The frame cannot be read at all."""


@dataclass
class Frame:
    """The layout of one frame, as read from its bytes."""
    version: int = 0
    independent: bool = False
    block_checksums: bool = False
    content_size: Optional[int] = None
    content_checksum: Optional[int] = None
    dict_id: Optional[int] = None
    block_max: int = 0
    # (offset of the block's data in the frame, size, stored)
    blocks: list = field(default_factory=list)
    faults: list = field(default_factory=list)


def _u32(buf: bytes, at: int) -> int:
    if at + 4 > len(buf):
        raise FrameError("frame ends inside a 4-byte field")
    return int.from_bytes(buf[at: at + 4], "little")


def read_frame(buf: bytes) -> Frame:
    """Read the header, the block layout and the checksums of one frame.
    Format faults that still let the blocks be read go to ``faults``;
    anything else raises FrameError."""
    fr = Frame()
    if _u32(buf, 0) != MAGIC:
        raise FrameError("bad magic number")
    if len(buf) < 7:
        raise FrameError("frame ends inside its descriptor")
    flg, bd = buf[4], buf[5]
    fr.version = flg >> 6
    if fr.version != 1:
        raise FrameError(f"version {fr.version}")
    fr.independent = bool(flg & 0x20)
    fr.block_checksums = bool(flg & 0x10)
    has_size, has_ck, has_dict = flg & 0x08, flg & 0x04, flg & 0x01
    if flg & 0x02 or bd & 0x8F:
        fr.faults.append("reserved bits set in the descriptor")
    bid = (bd >> 4) & 7
    if bid not in BLOCK_MAX:
        raise FrameError(f"block maximum size id {bid}")
    fr.block_max = BLOCK_MAX[bid]
    at = 6
    if has_size:
        if at + 8 > len(buf):
            raise FrameError("frame ends inside its content size")
        fr.content_size = int.from_bytes(buf[at: at + 8], "little")
        at += 8
    if has_dict:
        fr.dict_id = _u32(buf, at)
        at += 4
    if at >= len(buf):
        raise FrameError("frame ends before its header checksum")
    if buf[at] != (xxh32(buf[4: at]) >> 8) & 0xFF:
        fr.faults.append("header checksum")
    at += 1
    while True:
        word = _u32(buf, at)
        at += 4
        if word == 0:
            break
        size, stored = word & 0x7FFFFFFF, bool(word >> 31)
        if size > fr.block_max:
            fr.faults.append("a block larger than the block maximum size")
        if at + size > len(buf):
            raise FrameError("frame ends inside a block")
        fr.blocks.append((at, size, stored))
        at += size
        if fr.block_checksums:
            if _u32(buf, at) != xxh32(buf[at - size: at]):
                fr.faults.append("block checksum")
            at += 4
    if has_ck:
        fr.content_checksum = _u32(buf, at)
        at += 4
    if at != len(buf):
        fr.faults.append("bytes after the end of the frame")
    return fr


class Sequences(NamedTuple):
    """Every sequence of a batch of blocks, in block order (1-D tensors).
    A stored block is one literal-only sequence."""
    block: torch.Tensor       # the block each belongs to
    lit_start: torch.Tensor   # literal bytes' start in the joined blocks
    lit_len: torch.Tensor
    offset: torch.Tensor      # 0 on a literal-only sequence
    match_len: torch.Tensor   # 0 on a literal-only sequence
    last: torch.Tensor        # bool: the block's literal-only last sequence


def _run255(c: torch.Tensor, end: torch.Tensor) -> torch.Tensor:
    """For each position q, how many 0xFF bytes start at q, within q's
    block (end: the block's end, per position)."""
    n = c.numel()
    pos = torch.arange(n, device=c.device)
    cand = torch.where(c == 255, n, pos)
    nxt = torch.flip(torch.cummin(torch.flip(cand, [0]), 0).values, [0])
    return torch.minimum(nxt, end) - pos


def parse_blocks(c: torch.Tensor, starts, sizes, stored, faults: list
                 ) -> Sequences:
    """Parse the sequences of blocks laid back to back in *c* (u8): block b
    is ``c[starts[b]: starts[b] + sizes[b]]``, stored or compressed.
    Malformed streams are reported in *faults*."""
    dev = c.device
    n = c.numel()
    st = torch.tensor(starts, dtype=torch.int64, device=dev)
    sz = torch.tensor(sizes, dtype=torch.int64, device=dev)
    is_stored = torch.tensor(stored, dtype=torch.bool, device=dev)
    pos = torch.arange(n, device=dev)
    blk = torch.searchsorted(st, pos, right=True) - 1
    end = (st + sz)[blk]
    ci = c.long()
    run = _run255(ci, end)

    def at(i):
        return ci[i.clamp(0, max(n - 1, 0))]

    def ext(q):
        """(extra length, bytes used, ok) of a length field continuing at
        q: 255 * run + the byte that ends it."""
        r = run[q.clamp(0, max(n - 1, 0))]
        r = torch.where(q < end, r, 0)
        return 255 * r + at(q + r), r + 1, q + r < end

    tok = ci
    l0, m0 = tok >> 4, tok & 15
    le, lb, lok = ext(pos + 1)
    long_l = l0 == 15
    lit_len = torch.where(long_l, 15 + le, l0)
    lit_start = pos + 1 + torch.where(long_l, lb, 0)
    ok = ~long_l | lok
    lit_end = lit_start + lit_len
    last = lit_end == end
    ok &= lit_end <= end
    has_off = lit_end + 2 <= end
    offset = at(lit_end) | (at(lit_end + 1) << 8)
    me, mb, mok = ext(lit_end + 2)
    long_m = m0 == 15
    match_len = torch.where(long_m, 15 + me, m0) + MIN_MATCH
    nxt = lit_end + 2 + torch.where(long_m, mb, 0)
    ok &= last | (has_off & (~long_m | mok) & (nxt <= end))
    ends_on_match = ~last & (nxt == end)
    jump = torch.where(ok & ~last & (nxt < end), nxt, n)
    jump = torch.cat([jump, torch.tensor([n], device=dev)])

    mark = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    comp = [s for s, z, t in zip(starts, sizes, stored) if z and not t]
    if comp:
        mark[torch.tensor(comp, dtype=torch.int64, device=dev)] = 1
    longest = max([z for z, t in zip(sizes, stored) if not t], default=1)
    for _ in range(max(1, math.ceil(math.log2(longest + 1)))):
        mark = mark.scatter_reduce(0, jump, mark, "amax")
        jump = jump[jump]
    tok_pos = torch.nonzero(mark[:n]).flatten()

    t_ok, t_last, t_blk = ok[tok_pos], last[tok_pos], blk[tok_pos]
    if not bool(t_ok.all()):
        faults.append("malformed sequence")
    if bool(ends_on_match[tok_pos].any()):
        faults.append("a block ends with a match")
    # every compressed block's last token is its literal-only sequence
    final = torch.ones_like(t_last)
    if tok_pos.numel() > 1:
        final[:-1] = t_blk[1:] != t_blk[:-1]
    if not bool(torch.equal(final, t_last)):
        faults.append("a block without a literal-only last sequence")

    s_idx = torch.nonzero(is_stored & (sz > 0)).flatten()
    seq_blk = torch.cat([t_blk, s_idx])
    order = torch.argsort(seq_blk * (n + 1)
                          + torch.cat([tok_pos, st[s_idx]]))
    zero = torch.zeros_like(s_idx)
    t_off = torch.where(t_last, 0, offset[tok_pos])
    t_ml = torch.where(t_last, 0, match_len[tok_pos])
    return Sequences(
        seq_blk[order],
        torch.cat([lit_start[tok_pos], st[s_idx]])[order],
        torch.cat([lit_len[tok_pos], sz[s_idx]])[order],
        torch.cat([t_off, zero])[order],
        torch.cat([t_ml, zero])[order],
        torch.cat([t_last, torch.ones_like(s_idx, dtype=torch.bool)])[order])


def _spread(starts: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Concatenated ranges starts[i] .. starts[i] + lens[i]."""
    total = int(lens.sum())
    base = torch.repeat_interleave(starts - (torch.cumsum(lens, 0) - lens),
                                   lens, output_size=total)
    return base + torch.arange(total, device=starts.device)


def decode_blocks(c: torch.Tensor, starts, sizes, stored, independent: bool,
                  block_max: int, faults: list):
    """Decode blocks laid back to back in *c*. Returns (the output u8
    tensor, each block's output length, the Sequences). Format faults go
    to *faults*."""
    dev = c.device
    nb = len(starts)
    seq = parse_blocks(c, starts, sizes, stored, faults)
    out_len = seq.lit_len + seq.match_len
    o = torch.cumsum(out_len, 0) - out_len
    total = int(out_len.sum())
    blk_out = torch.zeros(nb, dtype=torch.int64, device=dev)
    blk_out.index_add_(0, seq.block, out_len)
    if bool((blk_out > block_max).any()):
        faults.append("a block decodes to more than the block maximum size")
    blk_base = torch.cumsum(blk_out, 0) - blk_out
    blk_end = blk_base + blk_out

    is_match = ~seq.last
    m_start = o + seq.lit_len
    lower = blk_base[seq.block] if independent else torch.zeros_like(o)
    if bool((is_match & ((seq.offset < 1)
                         | (m_start - seq.offset < lower))).any()):
        faults.append("a match reaches before its history" if not independent
                      else "a match reaches before its block")
    # the end rules, in every block with a match
    has_match = torch.zeros(nb, dtype=torch.int32, device=dev)
    has_match.index_add_(0, seq.block, is_match.int())
    last_m = torch.full((nb,), -1, dtype=torch.int64, device=dev)
    last_m.scatter_reduce_(0, seq.block, torch.where(is_match, m_start, -1),
                           "amax")
    mb = has_match[seq.block] > 0
    if bool((mb & seq.last & (seq.lit_len < LAST_LITERALS)).any()):
        faults.append("fewer than 5 literals end a block")
    if bool(((has_match > 0) & (last_m > blk_end - MFLIMIT)).any()):
        faults.append("a match starts within 12 bytes of its block's end")

    img = torch.zeros(total, dtype=torch.uint8, device=dev)
    img[_spread(o, seq.lit_len)] = c[_spread(seq.lit_start, seq.lit_len)]
    src = torch.arange(total, device=dev)
    dst = _spread(m_start[is_match], seq.match_len[is_match])
    src[dst] = (dst - torch.repeat_interleave(
        seq.offset[is_match], seq.match_len[is_match],
        output_size=dst.numel())).clamp(min=0)
    for _ in range(64):
        nxt = src[src]
        if torch.equal(nxt, src):
            break
        src = nxt
    return img[src], blk_out, seq


def frame_blocks(buf: bytes, fr: Frame, device) -> tuple:
    """The frame's blocks laid back to back on *device*, with their
    (starts, sizes, stored)."""
    sizes = [s for _, s, _ in fr.blocks]
    starts = list(np.concatenate([[0], np.cumsum(sizes)])[:-1].tolist())
    raw = np.frombuffer(buf, np.uint8)
    joined = np.concatenate([raw[o: o + s] for o, s, _ in fr.blocks]) \
        if fr.blocks else np.empty(0, np.uint8)
    c = torch.from_numpy(joined).to(device)
    return c, starts, sizes, [t for _, _, t in fr.blocks]


def decode_frame(buf, device="cpu", verify_content: bool = True):
    """Decode one frame. Returns (plaintext as a numpy u8 array or None
    when it cannot be decoded, the Frame with its faults)."""
    buf = bytes(buf)
    try:
        fr = read_frame(buf)
    except FrameError as e:
        return None, Frame(faults=[f"unreadable frame: {e}"])
    if fr.dict_id is not None:
        fr.faults.append("a dictionary frame")
        return None, fr
    c, starts, sizes, stored = frame_blocks(buf, fr, device)
    if not fr.blocks:
        out = np.empty(0, np.uint8)
    else:
        got, _, _ = decode_blocks(c, starts, sizes, stored, fr.independent,
                                  fr.block_max, fr.faults)
        out = got.cpu().numpy()
    if fr.content_size is not None and fr.content_size != len(out):
        fr.faults.append("content size")
    if (verify_content and fr.content_checksum is not None
            and fr.content_checksum != xxh32(out)):
        fr.faults.append("content checksum")
    return out, fr
