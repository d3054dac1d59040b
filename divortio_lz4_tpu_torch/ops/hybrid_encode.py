"""Candidate-chain builder of the split encode, as torch ops.

Port of ``divortio_lz4_tpu/ops/hybrid_encode.py`` (``_cand_row``,
``_dist_row``, ``build_dist_chains``) and ``ops/encode_xla.py:_pows``. In
the JAX package this phase is plain XLA, not Pallas, so its port is torch
ops: one sort per block row gives every payload position the distance of
its best previous same-word occurrence (u16, 0 = none). The host serializer
(``lz4t_chain_serialize16``) then greedy-selects and extends. The chains
equal the JAX builder's element for element.

Rows are a batch dimension (the JAX code vmaps one row). The JAX code does
its hash and fingerprint math in uint32; here every such value lives in an
int64 tensor holding a u32 and is masked to 32 bits after each multiply,
add, subtract and cumsum (torch lacks uint32 shifts and comparisons on the
CPU). ``_mul32`` splits each product so no int64 product overflows.
Position keys carry the position in their low bits, so every sort key is
unique and ``torch.sort`` reproduces ``jax.lax.sort``'s order exactly.
"""

from __future__ import annotations

import torch

from ..constants import MF_LIMIT, MIN_MATCH, WINDOW_SIZE

_M32 = 0xFFFFFFFF

# encode_xla.py:56-58 — odd polynomial base and its inverse mod 2**32.
_B1 = 0x9E3779B1
_B1_INV = pow(_B1, -1, 1 << 32)

# Sort-predecessors scored per position (hybrid_encode.py:224).
PREDS = (1, 2, 3, 4, 6, 8)


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2**32 for u32 values held in int64 (b: tensor or int).
    Split at 16 bits so every partial product stays below 2**49."""
    lo = b & 0xFFFF
    hi = b >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def _pows(base: int, n: int, device) -> torch.Tensor:
    """[base**0, ..., base**(n-1)] mod 2**32 by binary exponentiation
    (encode_xla.py:74), as int64."""
    e = torch.arange(n, dtype=torch.int64, device=device)
    acc = torch.ones(n, dtype=torch.int64, device=device)
    sq = base & _M32
    for k in range(max(1, (n - 1).bit_length()) + 1):
        acc = torch.where(((e >> k) & 1) == 1, _mul32(acc, sq), acc)
        sq = (sq * sq) & _M32
    return acc


def _shifted(a: torch.Tensor, k: int, fill: int = 0) -> torch.Tensor:
    """out[:, j] = a[:, j - k], with *fill* in the first k columns."""
    pad = torch.full((a.shape[0], k), fill, dtype=a.dtype, device=a.device)
    return torch.cat([pad, a[:, :-k]], dim=1)


def _cand_rows(work: torch.Tensor, src_len: torch.Tensor, hist_len: int,
               hist_start: torch.Tensor, hashed: bool = False):
    """Batched ``_cand_row``: for every position of every row, the scored
    best previous same-word occurrence.

    work: int64[R, N] bytes ([history | payload]); src_len, hist_start:
    int64[R]. Returns (valid bool[R, N], dist int64[R, N]) over all N
    positions, exactly as hybrid_encode.py:132-313 does per row."""
    R, N = work.shape
    if N > (1 << 17):
        raise ValueError(f"row width {N} > 2**17: positions pack in 17 bits")
    dev = work.device
    idx = torch.arange(N, dtype=torch.int64, device=dev)
    s_end = (hist_len + src_len)[:, None]
    mf_limit = s_end - MF_LIMIT

    b = work
    bp = torch.nn.functional.pad(b, (0, 3))
    w = (bp[:, :N] | (bp[:, 1:N + 1] << 8) | (bp[:, 2:N + 2] << 16)
         | (bp[:, 3:N + 3] << 24))
    invalid = (idx + MIN_MATCH > s_end) | (idx < hist_start[:, None])

    # Prefix fingerprints: h_d[p] hashes the whole range [p, p+d).
    inv1 = _pows(_B1_INV, N + 1, dev)
    pw1 = _pows(_B1, N + 1, dev)
    c1 = torch.cat([torch.zeros((R, 1), dtype=torch.int64, device=dev),
                    torch.cumsum(b * inv1[:N], dim=1) & _M32], dim=1)

    def _range_hash(d):
        hi = torch.cat([c1[:, d:],
                        torch.zeros((R, max(d - 1, 0)), dtype=torch.int64,
                                    device=dev)], dim=1)[:, :N]
        return _mul32((hi - c1[:, :N]) & _M32, pw1[:N])

    def _tier(d):
        return (_mul32(_range_hash(d // 2), 0x9E3779B1)
                + _range_hash(d)) & _M32

    t16, t64, t256 = _tier(16), _tier(64), _tier(256)

    # Run-interior positions (the word repeats within 4 bytes).
    interior = torch.zeros((R, N), dtype=torch.bool, device=dev)
    for p in (1, 2, 3, 4):
        interior[:, p:] |= w[:, p:] == w[:, :-p]

    best_key = torch.full((R, N), -1, dtype=torch.int64, device=dev)
    best_cand = torch.full((R, N), -1, dtype=torch.int64, device=dev)

    if hashed:
        ibits = (N - 1).bit_length()
        hbits = 30 - ibits
        mask = (1 << ibits) - 1
        wc8 = _mul32(w, 0x85EBCA77) >> 24                  # word check
        fp16 = _mul32(t16, 0x9E3779B1) >> 23               # 9-bit tier 16
        fp64 = _mul32(t64, 0x85EBCA77) >> 24               # 8-bit tier 64
        fp256 = _mul32(t256, 0xC2B2AE3D) >> 25             # 7-bit tier 256
        pay = (wc8 << 24) | (fp16 << 15) | (fp64 << 7) | fp256
        h = _mul32(w, 0x9E3779B1) >> (32 - hbits)
        key = ((h << (ibits + 2)) | (invalid.long() << (ibits + 1))
               | (interior.long() << ibits) | idx)
        skey, order = torch.sort(key, dim=1)
        spay = torch.gather(pay, 1, order)
        si = skey & mask
        for k in PREDS:
            pkey = _shifted(skey, k, fill=_M32)
            ppay = _shifted(spay, k)
            pi = pkey & mask
            pgood = ((pkey >> (ibits + 1)) & 1) == 0
            bucket = (pkey >> (ibits + 2)) == (skey >> (ibits + 2))
            wc_eq = (ppay >> 24) == (spay >> 24)
            dist = si - pi
            ok = pgood & bucket & wc_eq & (dist > 0) & (dist < WINDOW_SIZE)
            m16 = ok & (((ppay >> 15) & 0x1FF) == ((spay >> 15) & 0x1FF))
            m64 = m16 & (((ppay >> 7) & 0xFF) == ((spay >> 7) & 0xFF))
            m256 = m64 & ((ppay & 0x7F) == (spay & 0x7F))
            sc = 4 + m16.long() * 16 + m64.long() * 64 + m256.long() * 256
            keysc = torch.where(ok, sc * 16 + (15 - k), -1)
            better = keysc > best_key
            best_key = torch.where(better, keysc, best_key)
            best_cand = torch.where(better, pi, best_cand)
    else:
        fp13 = _mul32(t16, 0x85EBCA77) >> 19               # 13-bit tier 16
        sAB = (t64 & 0xFFFF0000) | (t256 >> 16)             # 16+16 payload
        idx2 = ((invalid.long() << 31) | (interior.long() << 30)
                | (idx << 13) | fp13)
        # Lexicographic (w, idx2) as one int64: w is shifted down by 2**31
        # so that w * 2**32 fits a signed int64 without changing the order.
        key = (w - (1 << 31)) * (1 << 32) + idx2
        _, order = torch.sort(key, dim=1)
        sw = torch.gather(w, 1, order)
        si2 = torch.gather(idx2, 1, order)
        ssAB = torch.gather(sAB, 1, order)
        si = (si2 >> 13) & 0x1FFFF
        for k in PREDS:
            # The fill has the bad bit set: slots before the first k
            # entries never take a padding candidate.
            pi2 = _shifted(si2, k, fill=_M32)
            pw = _shifted(sw, k)
            pi = (pi2 >> 13) & 0x1FFFF
            pgood = pi2 < (1 << 31)
            dist = si - pi
            ok = pgood & (pw == sw) & (dist > 0) & (dist < WINDOW_SIZE)
            m16 = (pi2 & 0x1FFF) == (si2 & 0x1FFF)
            psAB = _shifted(ssAB, k)
            m64 = m16 & ((psAB >> 16) == (ssAB >> 16))
            m256 = m64 & ((psAB & 0xFFFF) == (ssAB & 0xFFFF))
            sc = 4 + m16.long() * 16 + m64.long() * 64 + m256.long() * 256
            keysc = torch.where(ok, sc * 16 + (15 - k), -1)
            better = keysc > best_key
            best_key = torch.where(better, keysc, best_key)
            best_cand = torch.where(better, pi, best_cand)

    # Un-sort. si is a permutation of 0..N-1 per row, so a scatter over it
    # is the exact inverse of the JAX code's second sort.
    recv_ok = (idx >= hist_len) & (idx < mf_limit)
    if N <= (1 << 16):
        dist_s = torch.where(best_cand >= 0, si - best_cand, 0)
        dist = torch.empty_like(dist_s).scatter_(1, si, dist_s)
        return (dist > 0) & recv_ok, dist
    cand = torch.empty_like(best_cand).scatter_(1, si, best_cand)
    valid = (cand >= 0) & (idx - cand < WINDOW_SIZE) & recv_ok
    return valid, idx - cand


def _dist_rows(work: torch.Tensor, src_len: torch.Tensor, hist_len: int,
               hist_start: torch.Tensor, hashed: bool = False
               ) -> torch.Tensor:
    """u16 per-payload-position match distance per row (0 = no match)."""
    valid, dist = _cand_rows(work, src_len, hist_len, hist_start, hashed)
    return torch.where(valid[:, hist_len:], dist[:, hist_len:], 0) \
        .to(torch.uint16)


def build_dist_chains(work: torch.Tensor, lens: torch.Tensor, hist_len: int,
                      hist_start, hashed: bool = True) -> torch.Tensor:
    """u16 dist-only chains: int[nb, N] work -> uint16[nb, N - hist_len].

    Same contract as the JAX ``build_dist_chains``: *hist_start* is an int
    or an int[nb] (first valid history index per row); ``hashed=True`` is
    the production hashed-bucket layout, ``hashed=False`` exact words."""
    work = work.to(torch.int64)
    lens = lens.to(device=work.device, dtype=torch.int64)
    hs = torch.as_tensor(hist_start, dtype=torch.int64, device=work.device)
    hs = hs.expand(work.shape[0]).contiguous()
    return _dist_rows(work, lens, hist_len, hs, hashed)
