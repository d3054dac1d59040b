"""Plain-PyTorch pieces shared by the two encoders' plain versions
(``greedy_encode``'s reference scan and ``hybrid_encode``'s chain walk).

Both find their matches one batched torch step at a time, recording per
step and row a hit column ``(hit, anchor, lit_len, offset, mlen)``; then
``serialize`` writes every row's sequences in one vectorized pass, as the
CUDA kernels' shared emitter (``csrc/greedy_encode.cu``: ``emit``,
``put_ext``, ``zero_fill``) does one sequence at a time.
"""

from __future__ import annotations

import torch

from ..constants import MIN_MATCH

EXT_STEP = 256      # bytes the plain versions compare per extension step


def ext_count(v: torch.Tensor) -> torch.Tensor:
    """Bytes of the 0xFF-run length extension of a nibble value v."""
    return torch.where(v >= 15, 1 + (v - 15).clamp(min=0) // 255, 0)


def expand(n: torch.Tensor):
    """(owner, j): for each i < len(n), the pairs (i, 0..n[i]-1)."""
    owner = torch.repeat_interleave(torch.arange(len(n), device=n.device), n)
    j = torch.arange(len(owner), device=n.device) \
        - (torch.cumsum(n, 0) - n)[owner]
    return owner, j


def extend(byts: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
           limit: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Per row r of *byts* (int64[R, N]): the first k >= 0 where
    ``a[r] + k >= limit[r]`` or ``byts[r, a[r] + k] != byts[r, b[r] + k]``,
    EXT_STEP bytes a step; 0 where *active* is False."""
    rows = torch.arange(byts.shape[0], device=byts.device)[:, None]
    t = torch.arange(EXT_STEP, device=byts.device)
    top = byts.shape[1] - 1
    k = torch.zeros_like(a)
    done = ~active
    while not bool(done.all()):
        pos = (a + k)[:, None] + t
        x = byts[rows, pos.clamp(max=top)]
        y = byts[rows, ((b + k)[:, None] + t).clamp(0, top)]
        neq = (x != y) | (pos >= limit[:, None])
        first = torch.where(neq.any(1), neq.to(torch.int8).argmax(1),
                            EXT_STEP)
        k = torch.where(done, k, k + first)
        done = done | (first < EXT_STEP)
    return k


def serialize(work, src_len, hits, anchor, ow):
    """Write every row's sequences (its hits in step order, then the
    trailing literal run) into zeroed rows of width *ow*. *work* holds the
    payload rows the literals come from. Returns (out u8[nb, ow], out_lens
    i64[nb])."""
    dev = work.device
    nb = work.shape[0]

    def cols(i):
        tail = {0: src_len > 0, 1: anchor, 2: src_len - anchor}.get(
            i, torch.zeros_like(src_len))
        return torch.stack([h[i] for h in hits] + [tail], 1)

    valid = cols(0)
    has_match = valid.clone()
    has_match[:, -1] = False
    lit_start, lit, offset = cols(1), cols(2), cols(3)
    mcode = cols(4) - MIN_MATCH
    ext_l = ext_count(lit)
    ext_m = torch.where(has_match, ext_count(mcode), 0)
    size = torch.where(valid, 1 + ext_l + lit
                       + torch.where(has_match, 2 + ext_m, 0), 0)
    out_lens = size.sum(1)
    start = torch.cumsum(size, 1) - size
    row = torch.arange(nb, device=dev)[:, None].expand_as(valid)
    sel = valid
    row, start, lit, lit_start = row[sel], start[sel], lit[sel], \
        lit_start[sel]
    offset, mcode, ext_l, ext_m = offset[sel], mcode[sel], ext_l[sel], \
        ext_m[sel]
    has_match = has_match[sel]
    out = torch.zeros(nb * ow, dtype=torch.uint8, device=dev)
    base = row * ow + start
    token = (lit.clamp(max=15) << 4) \
        | torch.where(has_match, mcode.clamp(max=15), 0)
    out[base] = token.to(torch.uint8)

    def put_ext(at, v, n):
        owner, j = expand(n)
        val = torch.where(j < n[owner] - 1, 255, (v[owner] - 15) % 255)
        out[at[owner] + j] = val.to(torch.uint8)

    put_ext(base + 1, lit, ext_l)
    owner, j = expand(lit)
    out[(base + 1 + ext_l)[owner] + j] = \
        work[row[owner], lit_start[owner] + j]
    at = (base + 1 + ext_l + lit)[has_match]
    off = offset[has_match]
    out[at] = (off & 0xFF).to(torch.uint8)
    out[at + 1] = ((off >> 8) & 0xFF).to(torch.uint8)
    put_ext(at + 2, mcode[has_match], ext_m[has_match])
    return out.view(nb, ow), out_lens
