"""Parallel match resolution: what the two chain decoders share.

A linked frame is one chain of dependent bytes, so a decoder that walks it
in order runs on one SM. ``csrc/chain_decode.cu`` (records) and
``csrc/token_decode.cu`` (LZ4 tokens) instead decode a chain in four
stages that spread over the whole card; the stages they share live in
``csrc/span_resolve.cuh``, and this module holds their plain PyTorch
rendition and the bookkeeping of the CUDA runs.

A. Spans: each record or LZ4 sequence becomes one literal span (bytes of
   the compressed image) and one match span (bytes of earlier output).
   Records come with their spans; token rows are parsed alone, each at a
   row-local cursor, and placed by a scan of their lengths
   (``wave_decode.record_spans``, ``token_decode.token_spans``).
B. One source per output byte: a literal byte, a seed byte, a zero (no
   span covers it) or a parent, an earlier output position. A match byte
   i of a span takes ``src + i % period``: ``period`` is the LZ4 offset on
   the token path, so an offset-1 run of any length is one hop to its
   literal, and unbounded on the record path.
C. Pointer doubling: a byte whose parent c is a root gets the final code
   ``-(c + 2)``; any other takes its parent's code, ``code[p] =
   code[code[p]]``, until no code is a parent pointer; about
   ``ceil(log2(depth)) + 1`` rounds. Final bytes are not read again.
D. Gather: every byte with a final code takes its root's byte.

The output is resolved in segments of at most SEGMENT bytes, in order:
a parent in an earlier segment is final and counts as a root, so the codes
stay int32 and the scratch stays at 4 bytes per segment byte.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..constants import WINDOW_SIZE

W = WINDOW_SIZE         # seed window ahead of every chain's output
ROOT = -1               # code of a byte whose value is final
SEGMENT = 1 << 28       # output bytes resolved at once (1 GiB of codes)
NO_PERIOD = 1 << 62     # a record's match span: parent src + i


def rounds_for(n: int) -> int:
    """Pointer-doubling rounds the kernels launch for a segment of *n*
    bytes: depth < n, so ceil(log2(n)) rounds bring every byte within one
    hop of its root, one more makes it final and one more finds no parent
    pointer (each later launch returns at once)."""
    return max(n, 1).bit_length() + 2


class Lits(NamedTuple):
    """Literal spans: output bytes at..at+n take buf[src..src+n), zeros
    at and past end."""
    at: torch.Tensor     # i64 global output position of the first byte
    src: torch.Tensor    # i64 index into the compressed bytes
    end: torch.Tensor    # i64
    n: torch.Tensor      # i64


class Matches(NamedTuple):
    """Match spans: output byte at + i takes global position
    src + i % period; a position below the chain's o0 is the seed's byte
    at W - (o0 - position)."""
    at: torch.Tensor     # i64
    o0: torch.Tensor     # i64 the chain's first output byte
    src: torch.Tensor    # i64
    period: torch.Tensor  # i64 the LZ4 offset, or NO_PERIOD
    n: torch.Tensor      # i64


def _expand(n: torch.Tensor):
    """(span index, byte index inside the span) of every byte of spans of
    lengths *n*."""
    n = n.clamp(min=0)
    owner = torch.repeat_interleave(torch.arange(len(n), device=n.device), n)
    j = torch.arange(len(owner), device=n.device) \
        - (torch.cumsum(n, 0) - n)[owner]
    return owner, j


def pointer_double(code: torch.Tensor) -> int:
    """Stage C on one segment's codes, in place: parent pointers (>= 0)
    until every byte is a root (ROOT) or final (``-(root + 2)``). Returns
    the rounds run, the last of which found no parent pointer."""
    rounds = 0
    while True:
        rounds += 1
        idx = (code >= 0).nonzero().flatten()
        if not len(idx):
            return rounds
        c = code[idx]
        up = code[c]
        code[idx] = torch.where(up == ROOT, -(c + 2), up)


def gather(seg: torch.Tensor, code: torch.Tensor) -> None:
    """Stage D: every final byte of the segment takes its root's byte."""
    m = code <= -2
    seg[m] = seg[-2 - code[m]]


def resolve_segments(out_total: int, buf: torch.Tensor,
                     seed: Optional[torch.Tensor], lits: Lits,
                     matches: Matches, segment: int = SEGMENT,
                     seed_row: Optional[torch.Tensor] = None):
    """Stages B-D over the whole output, segment by segment. *seed* is
    u8[W] (every chain's), None (zeros) or u8[nc, W] with *seed_row*, the
    row of each match span's chain. Returns (out u8[out_total], rounds per
    segment); bytes no span covers are zeros."""
    dev = buf.device
    out = torch.zeros(out_total, dtype=torch.uint8, device=dev)
    k, j = _expand(lits.n)
    lit_g = lits.at[k] + j
    at = lits.src[k] + j
    lit_v = torch.where(at < lits.end[k],
                        buf[at.clamp(0, max(buf.shape[0] - 1, 0))]
                        if buf.shape[0] else torch.zeros_like(at), 0) \
        .to(torch.uint8)
    k, j = _expand(matches.n)
    mat_g = matches.at[k] + j
    mat_o0 = matches.o0[k]
    mat_gs = matches.src[k] + j % matches.period[k]
    mat_row = seed_row[k] if seed_row is not None else None
    rounds = []
    for s0 in range(0, out_total, segment):
        s1 = min(s0 + segment, out_total)
        code = torch.full((s1 - s0,), ROOT, dtype=torch.int64, device=dev)
        m = (lit_g >= s0) & (lit_g < s1)
        out[lit_g[m]] = lit_v[m]
        m = (mat_g >= s0) & (mat_g < s1)
        g, gs, o0 = mat_g[m], mat_gs[m], mat_o0[m]
        in_seed = gs < o0
        at = gs[in_seed] - o0[in_seed] + W
        if mat_row is not None:
            out[g[in_seed]] = seed[mat_row[m][in_seed], at]
        elif seed is not None:
            out[g[in_seed]] = seed[at]
        early = ~in_seed & (gs < s0)    # an earlier segment: final
        out[g[early]] = out[gs[early]]
        rest = ~in_seed & ~early
        code[g[rest] - s0] = gs[rest] - s0
        rounds.append(pointer_double(code))
        gather(out[s0:s1], code)
    return out, rounds


# ---------------------------------------------------------------------------
# The CUDA runs' bookkeeping
# ---------------------------------------------------------------------------

class ResolveRun(NamedTuple):
    """What one CUDA decode left on the device (read with stats(), which
    synchronises). flags i32: on the record path (serial_route), [0] the
    chains' offsets overlap (every chain decodes serially), then one
    serial-route flag per chain; then rounds_max flags per segment, flag k
    set when round k changed a code. stats() gives the rounds, the
    segments, the scratch bytes and, on the record path, the chains
    decoded serially."""
    flags: torch.Tensor
    n_chains: int
    serial_route: bool
    segments: int
    rounds_max: int
    scratch_bytes: int

    def stats(self) -> dict:
        f = self.flags.cpu()
        head = 1 + self.n_chains if self.serial_route else 0
        per_seg = f[head:].view(self.segments, self.rounds_max) \
            if self.segments else f[:0].view(0, 1)
        rounds = [1 + int(r.sum()) for r in per_seg]
        out = dict(rounds=max(rounds, default=0), segments=self.segments,
                   scratch_bytes=self.scratch_bytes)
        if self.serial_route:
            out["serial_chains"] = self.n_chains if int(f[0]) \
                else int(f[1:head].sum())
        return out
