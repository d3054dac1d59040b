"""engine="xla" block decode: the two-phase data-parallel decoder as torch
ops.

Port of ``divortio_lz4_tpu/ops/decode_xla.py`` (``decode_block``,
``decode_blocks_batch``, ``decode_block_host``). In the JAX package this
decoder is plain XLA, not Pallas, so its port is torch ops: on a CUDA
tensor every step runs on the card, on a CPU tensor on the CPU. Rows are a
batch dimension (the JAX code vmaps one row).

Phase A parses a sequence speculatively at every input byte (literal
length with its 0xFF run, offset, match length, the next sequence's
position); the true sequence starts are the orbit of position 0 under
next(), found by pointer doubling. Phase B scatters each sequence's
literal and match zones into the output, fills them forward (cummax), and
chases match back-pointers to a literal or into the history window.

What the port keeps exactly, so that every output byte equals JAX's, also
on hostile blocks (which this decoder clips and does not diagnose):

- ``jnp.take(..., mode="clip")`` is a gather behind an explicit clamp to
  [0, len - 1] (negative indices clamp to 0, as JAX's do).
- ``.at[i].set(..., mode="drop")`` writes into a target one slot longer,
  cut afterwards (``_slot``); JAX wraps a negative index once, and so does
  ``_slot``. Zone starts are distinct by construction, so no scatter has
  two writes to one kept slot.
- Values are int64; JAX's int32 never wraps here (every sum is below
  255 * M + 35 * M < 2**31 for rows up to ``block_bound(4 MB)``).
- JAX's row widths: ``M`` (the caller's bucket) enters ``nxt``'s clip and
  the orbit's round cap, ``out_cap`` the chase's.

The two while-loops (the orbit, the chase) keep JAX's round caps
(``_ceil_log2(M) + 1``, ``_ceil_log2(out_cap) + 1``) and its exit test,
read on the host once a round (one sync each). Rows run together until
every row has converged: a round that changes nothing in a row changes
nothing there later (an orbit that gains no position is closed; a pointer
map equal to its square stays so), so the rows that finished first end as
JAX's vmapped loop leaves them. ``decode_blocks_batch.last_rounds`` holds
the last call's rounds (the most of any row chunk) and host syncs.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..constants import WINDOW_SIZE

# Positions (rows x row width) one pass holds at once. A decode pass keeps
# ~25 int64 tensors of that many elements alive: 2**24 positions are
# ~3.4 GB at peak, 256 rows of 64 KB or 3 rows of 4 MB. Rows are
# independent, so the chunking changes no byte.
XLA_CHUNK_POSITIONS = 1 << 24

# Zone packing (decode_xla.py:156-158): tag << 28 | (value + BIAS).
BIAS = 1 << 26

def _ceil_log2(n: int) -> int:
    return max(1, int(np.ceil(np.log2(max(n, 2)))))


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``jnp.take(x_row, i_row, mode="clip")`` per row: x [R, L] (or [L],
    shared by every row), i [R, K]."""
    n = x.shape[-1]
    i = i.clamp(0, n - 1)
    if x.dim() == 1:
        return x[i]
    return torch.gather(x.expand(i.shape[0], n), 1, i)


def _shift_up(x: torch.Tensor, k: int) -> torch.Tensor:
    """out[:, i] = x[:, i + k], zeros in the last k columns."""
    if k == 0:
        return x
    return torch.nn.functional.pad(x[:, k:], (0, k))


def _rev_cummin(x: torch.Tensor) -> torch.Tensor:
    """``lax.cummin(x, axis=1, reverse=True)``."""
    return torch.cummin(x.flip(1), 1).values.flip(1)


def _slot(pos: torch.Tensor, size: int) -> torch.Tensor:
    """The slot a ``.at[pos].set(..., mode="drop")`` into *size* slots
    writes: a negative index wraps once, as JAX's does, and whatever is
    still outside [0, size) goes to the extra slot *size*, cut afterwards."""
    pos = torch.where(pos < 0, pos + size, pos)
    return torch.where((pos < 0) | (pos >= size), size, pos)


def _orbit(reach: torch.Tensor, jump: torch.Tensor, cap: int):
    """The positions reachable from *reach* under *jump* (pointer doubling,
    decode_xla.py:123-140 and encode_xla.py:289-301). Returns (reach,
    rounds)."""
    rounds = 0
    while rounds < cap:
        prop = torch.zeros_like(reach).scatter_reduce(
            1, jump, reach, "amax", include_self=True)
        new = torch.maximum(reach, prop)
        rounds += 1
        changed = bool((new != reach).any())
        reach, jump = new, torch.gather(jump, 1, jump)
        if not changed:
            break
    return reach, rounds


def _decode_rows(comp: torch.Tensor, comp_len: torch.Tensor,
                 hist: torch.Tensor, B: int):
    """decode_xla.py:61-191 for rows: comp int[R, M], comp_len i64[R],
    hist int[R, W] or [W]. Returns (out u8[R, B], out_len i64[R], orbit
    rounds, chase rounds)."""
    R, M = comp.shape
    dev = comp.device
    comp = comp.long()
    hist = hist.long()
    idx = torch.arange(M, dtype=torch.int64, device=dev)
    clen = comp_len.long()[:, None]

    # ---- Phase A: a sequence parsed at every position ----
    r255 = _rev_cummin(torch.where(comp != 255, idx, M)) - idx
    lit_nib = comp >> 4
    match_nib = comp & 0x0F
    r_l = _shift_up(r255, 1)
    has_lit_ext = lit_nib == 15
    ext_l = torch.where(has_lit_ext, r_l + 1, 0)
    lit_len = lit_nib + torch.where(
        has_lit_ext, 255 * r_l + _take(comp, idx + 1 + r_l), 0)
    lit_start = idx + 1 + ext_l
    after_lit = lit_start + lit_len
    terminal = after_lit >= clen
    offset = _take(comp + (_shift_up(comp, 1) << 8), after_lit)
    mes = after_lit + 2
    r_m = _take(r255, mes)
    has_m_ext = match_nib == 15
    ext_m = torch.where(has_m_ext, r_m + 1, 0)
    match_len = 4 + match_nib + torch.where(
        has_m_ext, 255 * r_m + _take(comp, mes + r_m), 0)
    del r255, r_l, ext_l, has_lit_ext, has_m_ext, r_m, after_lit

    nxt = torch.where(terminal, idx, mes + ext_m).clamp(0, M - 1)
    nxt = torch.where(idx >= clen, idx, nxt)
    del mes, ext_m
    reach0 = ((idx == 0) & (clen > 0)).to(torch.int32)
    reach, orbit_rounds = _orbit(reach0, nxt, _ceil_log2(M) + 1)
    is_seq = (reach > 0) & (idx < clen)
    del reach, nxt

    out_adv = torch.where(
        is_seq, lit_len + torch.where(terminal, 0, match_len), 0)
    csum = torch.cumsum(out_adv, 1)
    out_pos = csum - out_adv
    out_len = csum[:, -1]
    del csum, out_adv, match_len

    # ---- Phase B: provenance of every output byte ----
    jB = torch.arange(B, dtype=torch.int64, device=dev)
    lit_zone = torch.where(is_seq & (lit_len > 0), out_pos, B)
    mat_zone = torch.where(is_seq & ~terminal, out_pos + lit_len, B)
    pack = torch.zeros((R, B + 1), dtype=torch.int64, device=dev)
    pack.scatter_(1, _slot(lit_zone, B),
                  (1 << 28) | (lit_start - out_pos + BIAS))
    pack.scatter_(1, _slot(mat_zone, B), (2 << 28) | (BIAS - offset))
    pack = pack[:, :B]
    del lit_zone, mat_zone, lit_start, out_pos, offset, is_seq, terminal

    fill = torch.cummax(torch.where(pack > 0, jB, -1), 1).values
    pack_f = torch.gather(pack, 1, fill.clamp(0, B - 1))
    del pack, fill
    tag_f = pack_f >> 28
    c_f = (pack_f & ((1 << 28) - 1)) - BIAS
    del pack_f

    # Literals are fixpoints; a match byte points offset back (negative:
    # into the history window, right-aligned at index WINDOW_SIZE + g).
    g = torch.where(tag_f == 1, jB, jB + c_f)
    del tag_f
    chase_rounds = 0
    while chase_rounds < _ceil_log2(B) + 1:
        g2 = torch.gather(g, 1, g.clamp(0, B - 1))
        g_new = torch.where(g < 0, g, g2)
        chase_rounds += 1
        changed = bool((g_new != g).any())
        g = g_new
        if not changed:
            break

    src_in = torch.gather(jB + c_f, 1, g.clamp(0, B - 1))
    from_hist = _take(hist, WINDOW_SIZE + g)
    out = torch.where(g >= 0, _take(comp, src_in), from_hist)
    out = torch.where(jB < out_len[:, None], out, 0).to(torch.uint8)
    return out, out_len, orbit_rounds, chase_rounds


def decode_blocks_batch(comp: torch.Tensor, comp_len: torch.Tensor,
                        hist: torch.Tensor, out_cap: int):
    """Decode a batch of LZ4 blocks (``decode_blocks_batch``).

    comp: int[R, M] compressed bytes per row (u8 or wider; bytes past
    comp_len are ignored); comp_len: int[R]; hist: int[R, WINDOW_SIZE] or
    int[WINDOW_SIZE] (one window for every row), each RIGHT-aligned,
    zeros where there is no history; out_cap: the output row width (the
    frame's block size). Returns (out u8[R, out_cap], out_len i64[R]) on
    comp's device: ``out[r, :out_len[r]]`` decoded, zeros past it. A
    hostile block gives JAX's clipped bytes and an out_len that may pass
    out_cap."""
    R, M = comp.shape
    dev = comp.device
    comp_len = comp_len.to(device=dev, dtype=torch.int64)
    hist = hist.to(dev)
    out = torch.empty((R, out_cap), dtype=torch.uint8, device=dev)
    out_len = torch.empty(R, dtype=torch.int64, device=dev)
    step = max(1, XLA_CHUNK_POSITIONS // max(M, out_cap))
    stats = {"orbit": 0, "chase": 0, "syncs": 0}
    for i in range(0, R, step):
        rows = slice(i, min(i + step, R))
        h = hist if hist.dim() == 1 else hist[rows]
        out[rows], out_len[rows], orb, ch = _decode_rows(
            comp[rows], comp_len[rows], h, out_cap)
        stats["orbit"] = max(stats["orbit"], orb)
        stats["chase"] = max(stats["chase"], ch)
        stats["syncs"] += orb + ch
    decode_blocks_batch.last_rounds = stats
    return out, out_len


decode_blocks_batch.last_rounds = None


def decode_block(comp: torch.Tensor, comp_len, hist: torch.Tensor,
                 out_cap: int):
    """Decode one LZ4 block (``decode_block``): comp int[M], comp_len an
    int, hist int[WINDOW_SIZE] right-aligned. Returns (out u8[out_cap],
    out_len i64 scalar tensor)."""
    out, out_len = decode_blocks_batch(
        comp[None], torch.as_tensor([int(comp_len)]), hist, out_cap)
    return out[0], out_len[0]


def _bucket(n: int, floor: int = 1024) -> int:
    b = floor
    while b < n:
        b <<= 1
    return b


def decode_block_host(comp_bytes: np.ndarray, out_cap: int,
                      history: np.ndarray | None = None, *,
                      device="cuda") -> np.ndarray:
    """numpy bytes in, numpy bytes out (``decode_block_host``): the block
    padded to a power-of-two width, the history's last 64 KB
    right-aligned, decoded on *device*."""
    dev = resolve_device(device)
    comp_bytes = np.asarray(comp_bytes, np.uint8)
    m = len(comp_bytes)
    comp = np.zeros(_bucket(m), np.uint8)
    comp[:m] = comp_bytes
    hist = np.zeros(WINDOW_SIZE, np.uint8)
    if history is not None and len(history) > 0:
        h = np.asarray(history, np.uint8)[-WINDOW_SIZE:]
        hist[WINDOW_SIZE - len(h):] = h
    out, out_len = decode_block(torch.from_numpy(comp).to(dev), m,
                                torch.from_numpy(hist).to(dev), out_cap)
    return out[: int(out_len)].cpu().numpy()
