"""The streaming decoder's burst decode: a list of independent blocks' wire
bytes in, their plaintexts out, one kernel launch and one fetch a burst.

Port of ``divortio_lz4_tpu/ops/pallas_split_decode.py:1274-1303``
(``decode_wire_blocks2``), on the routes the frame path takes for the same
blocks: blocks and wires of at most 64 KB go through the native staging
(``split_decode.stage_compact_batch``) and the compact kernel
(``parallel/device.py:_decode_independent_split``),
wider ones through the padded records and the wire kernel
(``_decode_wide_split``). The TPU planning that JAX wraps around the same
kernels (``dispatch_compact``, ``partition_by_plan``,
``dispatch_partitioned``: interleave ways, SMEM and VMEM tiers) is not
ported; a GPU block walks its own records. The placed-literal
``split_decode.decode_wire_blocks`` is not this function: JAX's docstring
naming the stream as its caller is stale (``stream.py:617``).
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from .compact_decode import decode_blocks_compact
from .split_decode import CompactBatch, stage_compact_batch
from .wire_decode import decode_blocks_wire, parse_wire_batch

COMPACT_MAX = 65536     # widest block and wire the compact route takes


def decode_wire_blocks2(comps, block_size: int, *, device="cuda") -> list:
    """Decode independent blocks (no history) on *device*: *comps* is a
    list of compressed blocks' wire bytes, *block_size* the frame's block
    maximum, which bounds every output. Returns np.uint8 outputs in input
    order, views of one array fetched for this call (no buffer is reused
    by a later call). Raises the host parser's "LZ4: ..." ValueErrors on
    malformed blocks, before anything is launched."""
    dev = resolve_device(device)
    if not comps:
        return []
    entries = [(np.asarray(c, np.uint8), False) for c in comps]
    widest = max(len(c) for c, _ in entries)
    if block_size <= COMPACT_MAX and widest <= COMPACT_MAX:
        sizes = np.array([len(c) for c, _ in entries], np.int64)
        blocks = np.zeros((len(sizes), 3), np.int64)
        blocks[1:, 0] = np.cumsum(sizes)[:-1]
        blocks[:, 1] = sizes
        staged = stage_compact_batch(
            np.concatenate([c for c, _ in entries]), blocks, block_size)
        out_lens = staged[3]
        b = CompactBatch.upload(*staged, dev)
        out = decode_blocks_compact(b.wire, b.rec_words, b.rec_off,
                                    b.out_lens, block_size)
    else:
        wire, recs, counts, out_lens, _ = parse_wire_batch(entries,
                                                           block_size)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        out = decode_blocks_wire(put(wire), put(recs), put(counts),
                                 block_size)
    out_np = out.cpu().numpy()
    return [out_np[i, : int(n)] for i, n in enumerate(out_lens)]
