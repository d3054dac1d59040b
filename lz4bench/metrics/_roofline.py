"""A decode kernel's share of its roofline, from the traced run."""

from __future__ import annotations

import numpy as np
import torch

from ..reference.frame import FrameError, frame_blocks, parse_blocks, \
    read_frame
from . import _bytes, _trace

# Parse the traced frames in batches of about this many compressed bytes.
BATCH_BYTES = 64 << 20


def _counts(frames, device):
    """(sizes, records) of each frame, from the reference's parse of its
    blocks, several frames a batch."""
    out, batch, held = [], [], 0

    def flush():
        if not batch:
            return
        joined = np.concatenate([c for c, _, _, _ in batch])
        c = torch.from_numpy(joined).to(device)
        starts, sizes, stored, owner = [], [], [], []
        base = 0
        for i, (part, st, sz, so) in enumerate(batch):
            starts += [base + s for s in st]
            sizes += sz
            stored += so
            owner += [i] * len(sz)
            base += len(part)
        seq = parse_blocks(c, starts, sizes, stored, [])
        per_block = _bytes.records_per_block(seq, len(sizes)).cpu().numpy()
        per_frame = np.zeros(len(batch), np.int64)
        np.add.at(per_frame, np.array(owner, np.int64), per_block)
        out.extend((sz, int(n)) for (_, _, sz, _), n in zip(batch, per_frame))
        batch.clear()

    for buf in frames:
        fr = read_frame(bytes(buf))
        c, st, sz, so = frame_blocks(bytes(buf), fr, "cpu")
        batch.append((c.numpy(), st, sz, so))
        held += len(c)
        if held >= BATCH_BYTES:
            flush()
            held = 0
    flush()
    return out


def roofline_pct(run, kernel: str, names) -> float | None:
    """The least time of *kernel* on the traced decompress calls' frames
    (the bytes it must move over the card's memory rate) over its profiled
    time, in percent; None where the trace has no such kernel or the card
    is not in the table of peaks."""
    if run.trace is None or not run.hbm_bytes_per_s:
        return None
    ns = _trace.kernel_ns(run.trace, names, "decompress")
    if not ns:
        return None
    frames, outs, kinds = [], [], []
    for rec in run.records:
        if rec.frame is None or rec.out is None:
            continue
        try:
            fr = read_frame(bytes(rec.frame))
        except FrameError:
            continue
        if _bytes.route(fr.independent, fr.block_max) != kernel:
            continue
        frames.append(rec.frame)
        outs.append(len(rec.out))
        kinds.append(fr.independent)
    if not frames:
        return None
    total = 0
    for (sizes, n_rec), out, indep in zip(_counts(frames, run.device), outs,
                                          kinds):
        if kernel == "compact_decode":
            total += _bytes.compact_decode_bytes(sizes, n_rec, out)
        else:
            total += _bytes.chain_decode_bytes(sizes, n_rec, out, indep)
    return 100.0 * (total / run.hbm_bytes_per_s) / (ns / 1e9)
