#!/usr/bin/env python3
"""Layer breakdown of one frame on one GPU.

    python3 chip_breakdown.py [--mib 64] [--seed N]
                              [--engine split|pallas|hybrid|xla]

Encodes bench.build_corpus(MiB, seed) as one FrameConfig() frame (4 MB
linked blocks) with a content checksum, then decodes it, and times each
layer of the port's path on its own: host clock around synchronised
calls, median of 3 (the chain kernel by CUDA events). The layers are
those of the default frame's route through parallel/device.py:

- encode: segment rows, H2D of the rows, chain builder (H2D included),
  D2H of the chains, serialize with splice meta, splice, frame assembly
  with the content xxh32;
- decode: block index, piece scan, scan + parse, chain arrays, H2D,
  chain_decode kernel, D2H of the output, content xxh32;
- the same frame decoded with engine="pallas" ("decode_pallas"): block
  index, host scan + rows + H2D, token_decode_linked kernel, D2H of the
  output and lengths, join, content xxh32;
- the corpus at 256 KB independent blocks decoded by the split engine
  ("decode_256k"): block index, host record parse, H2D, wire_decode
  kernel (its stages: dst scan, conformance, spans, rounds, gather,
  serial walk), D2H;
- the corpus at 64 KB independent blocks with a content checksum, the
  split engine's main path ("decode_64k"): block index, host record
  parse, flat records, H2D, compact_decode kernel (its stages: groups,
  serial route; and its per-block stats), D2H, join, content xxh32.

Both chain kernels' resolve stats (pointer-doubling rounds, scratch bytes
and, on the record path, chains decoded serially) are printed beside their
times, and one call of each runs under torch.profiler for its stages'
device time.

With ``--engine pallas`` the frame is the engine="pallas" one instead: 64 KB
independent blocks with a content checksum, whose layers are

- encode: blocks to batch, H2D of the rows, greedy_encode kernel (CUDA
  events), D2H of the rows and lengths, frame assembly with the content
  xxh32;
- decode: block index, padded comp rows + H2D, token_decode kernel (CUDA
  events; its stages under torch.profiler: split parse, stitch, copy
  groups, serial route; and its per-block stats), D2H of the rows and
  lengths, joining rows, content xxh32.

With ``--engine hybrid`` the frame is the engine="hybrid" one (64 KB
independent blocks, content checksum; encode only: hybrid decode is the
XLA decode, which ``--engine xla`` breaks down): blocks to rows, H2D of
the rows, chain builder (CUDA events), hybrid_encode walk (CUDA events),
D2H of the rows and lengths, frame assembly with the content xxh32.

With ``--engine xla`` two frames go through engine="xla" (torch ops on the
card, no kernel of their own): the corpus at 64 KB independent blocks with
a content checksum ("encode", "decode") and the FrameConfig() frame with a
content checksum ("encode_default", "decode_default"). Their layers:

- encode: blocks to rows (host), H2D of the rows, encode_blocks_batch
  (CUDA events), D2H of the rows and lengths, frame assembly with the
  content xxh32;
- decode: block index, comp rows + H2D, the block decode (64 KB:
  decode_blocks_batch; default: decode_linked_scan, 16 blocks one after
  another) by CUDA events, concat_blocks (CUDA events), D2H of the
  output, content xxh32.

The row passes' stages are timed by ``ops/decode_xla.stage_hook`` in a
separate call (host clock, synchronised at each stage's end, summed over
row chunks and blocks): encode words + sort + candidates, the 16-byte
direct check, LCE + inheritance, orbit, serialization; decode parse,
orbit, zone fill, chase, gather.

Then one compress_frame and one decompress_frame (hybrid: compress_frame
only; xla: both frames) run under torch.profiler.
The device busy share of a call is the union of its device activity
intervals (kernels, memcpy, memset; user annotations left out) over the
call's host wall time, so an interval the profiler reports under two
names counts once. The device ops' summed durations are printed beside it.

Prints one line per layer and per device op, and last a JSON line with
every number. Needs an NVIDIA GPU, nvcc and g++; never imports jax.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np

MIB = 1 << 20


def _median_ms(torch, fn, reps=3):
    """(median ms of fn() over *reps* synchronised calls, last result)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def _busy(torch, fn):
    """Run fn() once under torch.profiler. Returns (wall ms, union of the
    device intervals in ms, summed device op ms, {op name: ms})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans, per_op = [], defaultdict(float)
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or \
                getattr(e, "is_user_annotation", False):
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        per_op[e.name] += (b - a) / 1e3
    union, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            union += b - a
            end = b
        elif b > end:
            union += b - end
            end = b
    return wall, union / 1e3, sum(per_op.values()), dict(per_op)


def _per_kernel(torch, side, name, fn, res):
    """One call of fn() under torch.profiler: its device ops' ms by name
    (the stages of a chain kernel), printed and kept in res[side]."""
    ops = _busy(torch, fn)[3]
    res[side][f"{name} device ops (ms)"] = ops
    for op, ms in sorted(ops.items(), key=lambda kv: -kv[1]):
        print(f"{side}:   {name}: {ms:8.3f} ms  {op[:80]}")


def _split_layers(torch, pt, raw, frame, cfg, dev, layer, kernel, res):
    """The default frame's layers (split engine)."""
    from divortio_lz4_tpu_torch.constants import WINDOW_SIZE
    from divortio_lz4_tpu_torch.ops.split_encode import encode_blocks_chain
    from divortio_lz4_tpu_torch.ops.wave_decode import (
        ChainBatch, block_pieces, build_chain_arrays, decode_chains,
        plan_blocks)
    from divortio_lz4_tpu_torch.parallel import bigblock as bb
    from divortio_lz4_tpu_torch.parallel.device import (
        _assemble_frame_host, parse_block_index)
    from divortio_lz4_tpu_torch.utils import host_pool
    from divortio_lz4_tpu_torch.xxh import xxhash32

    n = len(raw)
    bs = cfg.resolved_block_size
    # -- encode ----------------------------------------------------------
    res["encode"]["compress_frame"] = _median_ms(
        torch, lambda: pt.compress_frame(raw, cfg, device=dev))[0]
    work, lens, hist_start, seg_rows = layer(
        "encode", "segment rows", lambda: bb._segment_rows(raw, bs, None,
                                                           True))
    layer("encode", "H2D segment rows",
          lambda: torch.from_numpy(work).to(dev))
    chains = layer("encode", "chain builder incl. H2D",
                   lambda: encode_blocks_chain(work, lens, bb.SEG,
                                               WINDOW_SIZE, hist_start,
                                               device=dev))
    chains_np = layer("encode", "D2H chains", lambda: chains.cpu().numpy())
    outs, out_lens, metas = layer(
        "encode", "serialize with meta",
        lambda: bb._encode_segments(work, lens, chains_np))

    def splice():
        return [bb._splice_block(
            raw, b * bs, min(b * bs + bs, n),
            [outs[r][: int(out_lens[r])] for r in rl],
            [metas[r] for r in rl], [lens[r] for r in rl], src_floor=0)
            for b, rl in enumerate(seg_rows)]
    comps = layer("encode", "splice", splice)
    blens = [min(bs, n - b * bs) for b in range(len(comps))]
    got = layer("encode", "assemble + content xxh32",
                lambda: _assemble_frame_host(raw, comps, blens, len(comps),
                                             bs, cfg, None))
    if got.tobytes() != np.asarray(frame).tobytes():
        raise AssertionError("the layers' frame differs from compress_frame")

    # -- decode ----------------------------------------------------------
    res["decode"]["decompress_frame"] = _median_ms(
        torch, lambda: pt.decompress_frame(frame, device=dev))[0]
    header, blocks, _ = layer("decode", "parse_block_index",
                              lambda: parse_block_index(frame))
    bm = header["block_max"]
    layer("decode", "scan (host pool)", lambda: list(host_pool().map(
        lambda b: block_pieces(frame, *b, bm)[0], blocks)))
    out_lens_d, recs_l = layer("decode", "scan + parse (host pool)",
                               lambda: plan_blocks(frame, blocks, header,
                                                   None))
    arrays = layer("decode", "build chain arrays",
                   lambda: build_chain_arrays(frame, blocks, False,
                                              out_lens_d, recs_l))
    tensors = layer("decode", "H2D wire + records", lambda: [
        torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays])
    batch = ChainBatch(*tensors, None, int(arrays[4][-1]))
    res["decode"]["records"] = int(arrays[2].shape[0])
    out = kernel("decode", "chain_decode", lambda: decode_chains(batch),
                 f", {arrays[2].shape[0]} records")
    res["decode"]["resolve"] = decode_chains.last.stats()
    print(f"decode: chain_decode: {res['decode']['resolve']}")
    _per_kernel(torch, "decode", "chain_decode", lambda: decode_chains(batch),
                res)
    out_np = layer("decode", "D2H output", lambda: out.cpu().numpy())
    layer("decode", "content xxh32", lambda: xxhash32(out_np, 0))
    if out_np.tobytes() != raw.tobytes():
        raise AssertionError("the layers' output differs from the corpus")


def _wire_decode(torch, pt, raw, dev, layer, kernel, res):
    """The corpus at 256 KB independent blocks, decoded by the split
    engine: host parse into padded records, H2D, wire_decode (its stages
    under torch.profiler), D2H."""
    from divortio_lz4_tpu_torch.config import FrameConfig
    from divortio_lz4_tpu_torch.ops.wire_decode import (decode_blocks_wire,
                                                         parse_wire_batch)
    from divortio_lz4_tpu_torch.parallel.device import parse_block_index

    side = "decode_256k"
    res[side] = {}
    frame = pt.compress_frame(raw, FrameConfig(block_size=256 * 1024,
                                               block_independence=True),
                              engine="pallas", device=dev)
    res[side]["decompress_frame"] = _median_ms(
        torch, lambda: pt.decompress_frame(frame, device=dev))[0]
    _, blocks, _ = layer(side, "parse_block_index",
                         lambda: parse_block_index(frame))
    entries = [(frame[o: o + n], st) for o, n, st in blocks]
    wire, recs, counts, out_lens, _ = layer(
        side, "parse records (host)",
        lambda: parse_wire_batch(entries, 256 * 1024, None))
    args = layer(side, "H2D wire + records", lambda: [
        torch.from_numpy(a).to(dev) for a in (wire, recs, counts)])
    out = kernel(side, "wire_decode",
                 lambda: decode_blocks_wire(*args, 256 * 1024),
                 f", {int(counts.sum())} records")
    res[side]["resolve"] = decode_blocks_wire.last.stats()
    print(f"{side}: wire_decode: {res[side]['resolve']}")
    _per_kernel(torch, side, "wire_decode",
                lambda: decode_blocks_wire(*args, 256 * 1024), res)
    rows = layer(side, "D2H output", lambda: out.cpu().numpy())
    got = np.concatenate([rows[i, : out_lens[i]] for i in range(len(rows))])
    if got.tobytes() != raw.tobytes():
        raise AssertionError("the 256 KB layers' output differs from the "
                             "corpus")


def _compact_decode(torch, pt, raw, dev, layer, kernel, res):
    """The corpus at 64 KB independent blocks with a content checksum,
    decoded by the split engine: host parse into records, flat records,
    H2D, compact_decode (its stages under torch.profiler), D2H, join,
    content xxh32."""
    from divortio_lz4_tpu_torch.config import FrameConfig
    from divortio_lz4_tpu_torch.ops.compact_decode import \
        decode_blocks_compact
    from divortio_lz4_tpu_torch.ops.split_decode import (build_flat_records,
                                                         parse_wire_raw)
    from divortio_lz4_tpu_torch.parallel.device import parse_block_index
    from divortio_lz4_tpu_torch.xxh import xxhash32

    side = "decode_64k"
    res[side] = {}
    frame = pt.compress_frame(raw, FrameConfig(
        block_size=65536, block_independence=True, content_checksum=True),
        device=dev)
    res[side]["decompress_frame"] = _median_ms(
        torch, lambda: pt.decompress_frame(frame, device=dev))[0]
    _, blocks, _ = layer(side, "parse_block_index",
                         lambda: parse_block_index(frame))
    entries = [(frame[o: o + n], st) for o, n, st in blocks]
    wire, recs_l, counts, out_lens, _ = layer(
        side, "parse records (host)",
        lambda: parse_wire_raw(entries, 65536, None))
    rec_words, rec_off = layer(side, "flat records (numpy)",
                               lambda: build_flat_records(recs_l))
    args = layer(side, "H2D wire + records", lambda: [
        torch.from_numpy(a).to(dev) for a in (wire, rec_words, rec_off,
                                              out_lens)])
    out = kernel(side, "compact_decode",
                 lambda: decode_blocks_compact(*args, 65536),
                 f", {int(counts.sum())} records")
    st = decode_blocks_compact.last_stats.cpu().long()
    res[side]["stats sums"] = st.sum(0).tolist()
    res[side]["stats maxima"] = st.max(0).values.tolist()
    print(f"{side}: compact_decode stats (records, groups, levels, the "
          f"largest group's levels, serial) sums {st.sum(0).tolist()} "
          f"maxima {st.max(0).values.tolist()}")
    _per_kernel(torch, side, "compact_decode",
                lambda: decode_blocks_compact(*args, 65536), res)
    rows = layer(side, "D2H output", lambda: out.cpu().numpy())
    got = layer(side, "join", lambda: np.concatenate(
        [rows[i, : out_lens[i]] for i in range(len(rows))]))
    layer(side, "content xxh32", lambda: xxhash32(got, 0))
    if got.tobytes() != raw.tobytes():
        raise AssertionError("the 64 KB layers' output differs from the "
                             "corpus")


def _default_pallas_decode(torch, pt, raw, frame, dev, layer, kernel, res):
    """The default frame's decode with engine="pallas": host scan, one
    token chain for the linked frame, token_decode_linked."""
    from divortio_lz4_tpu_torch.ops.token_decode import decode_token_chains
    from divortio_lz4_tpu_torch.parallel.device import (
        _fetch_all, parse_block_index, stage_token_chains)
    from divortio_lz4_tpu_torch.xxh import xxhash32

    side = "decode_pallas"
    res[side] = {}
    res[side]["decompress_frame"] = _median_ms(
        torch, lambda: pt.decompress_frame(frame, engine="pallas",
                                           device=dev))[0]
    header, blocks, _ = layer(side, "parse_block_index",
                              lambda: parse_block_index(frame))
    batch, starts, out_off = layer(
        side, "scan + rows + H2D", lambda: stage_token_chains(
            frame, blocks, header, None, dev, True))
    out = kernel(side, "token_decode_linked",
                 lambda: decode_token_chains(batch))
    stats = decode_token_chains.last.stats()
    res[side]["resolve"] = stats
    print(f"{side}: token_decode_linked: {stats}, "
          f"{batch.stored.shape[0]} rows")
    _per_kernel(torch, side, "token_decode_linked",
                lambda: decode_token_chains(batch), res)
    flat, ols = layer(side, "D2H output + lengths",
                      lambda: _fetch_all(list(out)))
    out_np = layer(side, "join", lambda: np.concatenate(
        [flat[: int(ols.sum())]]))
    layer(side, "content xxh32", lambda: xxhash32(out_np, 0))
    if out_np.tobytes() != raw.tobytes():
        raise AssertionError("the pallas layers' output differs from the "
                             "corpus")


def _pallas_layers(torch, pt, raw, frame, cfg, dev, layer, kernel, res):
    """The engine="pallas" 64 KB frame's layers."""
    from divortio_lz4_tpu_torch.ops.greedy_encode import encode_blocks_pallas
    from divortio_lz4_tpu_torch.ops.token_decode import decode_blocks_pallas
    from divortio_lz4_tpu_torch.parallel.device import (
        _assemble_frame_host, _blocks_to_batch, _fetch_all,
        parse_block_index, stage_token_blocks)
    from divortio_lz4_tpu_torch.xxh import xxhash32

    n = len(raw)
    bs = cfg.resolved_block_size
    layer("encode", "compress_frame",
          lambda: pt.compress_frame(raw, cfg, engine="pallas", device=dev))
    work, lens, nblocks = layer("encode", "blocks to batch (host)",
                                lambda: _blocks_to_batch(raw, bs))
    w = layer("encode", "H2D work rows",
              lambda: torch.from_numpy(work).to(dev))
    ln = torch.from_numpy(lens.astype(np.int64)).to(dev)
    out = kernel("encode", "greedy_encode",
                 lambda: encode_blocks_pallas(w, ln, bs))
    rows, ols = layer("encode", "D2H rows + lengths",
                      lambda: _fetch_all(list(out)))
    got = layer("encode", "assemble + content xxh32", lambda:
                _assemble_frame_host(raw, [rows[b, : ols[b]]
                                           for b in range(nblocks)],
                                     lens, nblocks, bs, cfg, None))
    if got.tobytes() != np.asarray(frame).tobytes():
        raise AssertionError("the layers' frame differs from compress_frame")

    layer("decode", "decompress_frame",
          lambda: pt.decompress_frame(frame, engine="pallas", device=dev))
    header, blocks, _ = layer("decode", "parse_block_index",
                              lambda: parse_block_index(frame))
    comp, clens, _ = layer("decode", "comp rows + H2D",
                           lambda: stage_token_blocks(frame, blocks, None,
                                                      dev))
    dec = kernel("decode", "token_decode",
                 lambda: decode_blocks_pallas(comp, clens, bs))
    st = decode_blocks_pallas.last_stats.cpu().long()
    print(f"decode: token_decode stats (sequences, re-walked, in order, "
          f"serial): sums {st.sum(0).tolist()}, maxima "
          f"{st.max(0).values.tolist()}")
    _per_kernel(torch, "decode", "token_decode",
                lambda: decode_blocks_pallas(comp, clens, bs), res)
    rows, ols = layer("decode", "D2H rows + lengths",
                      lambda: _fetch_all(list(dec)))
    out_np = layer("decode", "join rows", lambda: np.concatenate([
        frame[o: o + s] if st else rows[i, : ols[i]]
        for i, (o, s, st) in enumerate(blocks)]))
    layer("decode", "content xxh32", lambda: xxhash32(out_np, 0))
    if out_np.tobytes() != raw.tobytes():
        raise AssertionError("the layers' output differs from the corpus")


def _hybrid_layers(torch, pt, raw, frame, cfg, dev, layer, kernel):
    """The engine="hybrid" 64 KB frame's encode layers."""
    from divortio_lz4_tpu_torch.ops.hybrid_encode import (_chunked_chains,
                                                          hybrid_walk)
    from divortio_lz4_tpu_torch.parallel.device import (
        _assemble_frame_host, _fetch_all, _history_rows)

    bs = cfg.resolved_block_size
    layer("encode", "compress_frame",
          lambda: pt.compress_frame(raw, cfg, engine="hybrid", device=dev))
    work, lens, nblocks, hl, hs = layer(
        "encode", "blocks to rows (host)",
        lambda: _history_rows(raw, bs, None, False))
    w = layer("encode", "H2D work rows",
              lambda: torch.from_numpy(work).to(dev))
    ln = torch.from_numpy(lens.astype(np.int64)).to(dev)
    chains = kernel("encode", "chain builder",
                    lambda: _chunked_chains(w, ln, bs, hl, hs))
    out = kernel("encode", "hybrid_encode walk",
                 lambda: hybrid_walk(w, ln, chains, hl))
    print(f"encode: hybrid_encode: sequences re-walked in the stitch "
          f"{int(hybrid_walk.last_rewalked.sum())}")
    rows, ols, _ = layer("encode", "D2H rows + lengths + meta",
                         lambda: _fetch_all(list(out)))
    got = layer("encode", "assemble + content xxh32", lambda:
                _assemble_frame_host(raw, [rows[b, : ols[b]]
                                           for b in range(nblocks)],
                                     lens, nblocks, bs, cfg, None))
    if got.tobytes() != np.asarray(frame).tobytes():
        raise AssertionError("the layers' frame differs from compress_frame")


def _xla_stages(torch, fn):
    """fn() once with the XLA engine's stage hook. Returns ({stage: ms},
    fn's result): host clock, synchronised at each stage's end, summed
    over row chunks and blocks."""
    from divortio_lz4_tpu_torch.ops import decode_xla
    acc = defaultdict(float)
    torch.cuda.synchronize()
    last = [time.perf_counter()]

    def hook(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        acc[name] += (now - last[0]) * 1e3
        last[0] = now
    decode_xla.stage_hook = hook
    try:
        out = fn()
    finally:
        decode_xla.stage_hook = None
    return dict(acc), out


def _xla_layers(torch, pt, raw, dev, layer, kernel, res):
    """The engine="xla" layers of the 64 KB frame and the default frame."""
    from divortio_lz4_tpu_torch.config import FrameConfig
    from divortio_lz4_tpu_torch.constants import WINDOW_SIZE
    from divortio_lz4_tpu_torch.ops.assemble_xla import concat_blocks
    from divortio_lz4_tpu_torch.ops.decode_xla import decode_blocks_batch
    from divortio_lz4_tpu_torch.ops.encode_xla import encode_blocks_batch
    from divortio_lz4_tpu_torch.ops.linked_xla import decode_linked_scan
    from divortio_lz4_tpu_torch.parallel.device import (
        _assemble_frame_host, _fetch_all, _history_rows, parse_block_index,
        stage_xla_blocks, stage_xla_chain)
    from divortio_lz4_tpu_torch.xxh import xxhash32

    frames = {}
    for suffix, cfg in (("", FrameConfig(block_size=65536,
                                         block_independence=True,
                                         content_checksum=True)),
                        ("_default", FrameConfig(content_checksum=True))):
        enc, dec = "encode" + suffix, "decode" + suffix
        res.setdefault(enc, {})
        res.setdefault(dec, {})
        bs = cfg.resolved_block_size
        linked = not cfg.block_independence
        frame = pt.compress_frame(raw, cfg, engine="xla", device=dev)
        frames[suffix] = (cfg, frame)
        layer(enc, "compress_frame",
              lambda: pt.compress_frame(raw, cfg, engine="xla", device=dev))
        work, lens, nb, hl, hs = layer(
            enc, "blocks to rows (host)",
            lambda: _history_rows(raw, bs, None, linked))
        w = layer(enc, "H2D rows", lambda: torch.from_numpy(work).to(dev))
        ln = torch.from_numpy(lens.astype(np.int64)).to(dev)
        out = kernel(enc, "encode_blocks_batch",
                     lambda: encode_blocks_batch(w, ln, hl, True, hs))
        res[enc]["rounds"] = encode_blocks_batch.last_rounds
        stages, _ = _xla_stages(
            torch, lambda: encode_blocks_batch(w, ln, hl, True, hs))
        res[enc]["stages (ms)"] = stages
        for name, ms in stages.items():
            print(f"{enc}:   stage {name}: {ms:.1f} ms")
        print(f"{enc}: rounds {encode_blocks_batch.last_rounds}")
        rows, ols = layer(enc, "D2H rows + lengths",
                          lambda: _fetch_all(list(out)))
        got = layer(enc, "assemble + content xxh32", lambda:
                    _assemble_frame_host(raw, [rows[b, : ols[b]]
                                               for b in range(nb)],
                                         lens, nb, bs, cfg, None))
        if got.tobytes() != np.asarray(frame).tobytes():
            raise AssertionError("the layers' frame differs from "
                                 "compress_frame")
        del w, out

        layer(dec, "decompress_frame",
              lambda: pt.decompress_frame(frame, engine="xla", device=dev))
        _, blocks, _ = layer(dec, "parse_block_index",
                             lambda: parse_block_index(frame))
        if linked:
            comp, cl, st = layer(dec, "comp rows + H2D",
                                 lambda: stage_xla_chain(frame, blocks, bs,
                                                         dev))
            init = torch.zeros(WINDOW_SIZE, dtype=torch.uint8, device=dev)

            def block_decode():
                return decode_linked_scan(comp, cl, st, init, bs)
            name = "decode_linked_scan"
        else:
            comp, cl = layer(dec, "comp rows + H2D",
                             lambda: stage_xla_blocks(frame, blocks, bs, dev))
            hist = torch.zeros(WINDOW_SIZE, dtype=torch.uint8, device=dev)

            def block_decode():
                return decode_blocks_batch(comp, cl, hist, bs)
            name = "decode_blocks_batch"
        outs, out_lens = kernel(dec, name, block_decode)
        res[dec]["rounds"] = (decode_linked_scan.last_syncs if linked
                              else decode_blocks_batch.last_rounds)
        stages, _ = _xla_stages(torch, block_decode)
        res[dec]["stages (ms)"] = stages
        for sname, ms in stages.items():
            print(f"{dec}:   stage {sname}: {ms:.1f} ms")
        print(f"{dec}: rounds (linked: host syncs) {res[dec]['rounds']}")
        if linked or not any(f for _, _, f in blocks):
            flat, total = kernel(dec, "concat_blocks", lambda: concat_blocks(
                outs, out_lens, len(blocks) * bs))
            out_np = layer(dec, "D2H output",
                           lambda: flat[: int(total)].cpu().numpy())
        else:       # stored blocks: the rows are joined on the host
            rows, ols = layer(dec, "D2H rows + lengths",
                              lambda: _fetch_all([outs, out_lens]))
            out_np = layer(dec, "join", lambda: np.concatenate([
                frame[o: o + n] if f else rows[i, : ols[i]]
                for i, (o, n, f) in enumerate(blocks)]))
        layer(dec, "content xxh32", lambda: xxhash32(out_np, 0))
        if out_np.tobytes() != raw.tobytes():
            raise AssertionError("the xla layers' output differs from the "
                                 "corpus")
        del comp, outs
    return frames


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mib", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0x51E51A)
    ap.add_argument("--engine", choices=("split", "pallas", "hybrid", "xla"),
                    default="split")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_breakdown: torch.cuda.is_available() is False; this "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60)
    card = card.stdout.strip().splitlines()[0]
    print(card)

    import divortio_lz4_tpu_torch as pt
    from bench import build_corpus
    from divortio_lz4_tpu_torch.config import FrameConfig

    dev = torch.device("cuda:0")
    raw = build_corpus(args.mib * MIB, args.seed)
    n = len(raw)
    engine = args.engine
    cfg = FrameConfig(content_checksum=True)
    if engine not in ("split", "xla"):
        cfg = cfg.with_(block_size=65536, block_independence=True)
    frame = pt.compress_frame(raw, cfg, engine=engine, device=dev)  # warm-up
    if pt.decompress_frame(frame, engine="split" if engine == "hybrid"
                           else engine, device=dev).tobytes() \
            != raw.tobytes():
        raise AssertionError("round trip is not exact")
    res = {"card": card, "mib": args.mib, "encode": {}, "decode": {}}
    if engine != "split":
        res["engine"] = engine

    def layer(side, name, fn, reps=3):
        ms, out = _median_ms(torch, fn, reps)
        res[side][name] = ms
        print(f"{side}: {name}: {ms:.1f} ms")
        return out

    def kernel(side, name, fn, note=""):
        """fn() timed by CUDA events, median of 3; returns its result."""
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        kms = []
        for _ in range(3):
            start.record()
            out = fn()
            stop.record()
            torch.cuda.synchronize()
            kms.append(start.elapsed_time(stop))
        res[side][f"{name} kernel (CUDA events)"] = statistics.median(kms)
        print(f"{side}: {name} kernel (CUDA events): "
              f"{statistics.median(kms):.1f} ms{note}")
        return out

    frames = {}
    if engine == "xla":
        frames = _xla_layers(torch, pt, raw, dev, layer, kernel, res)
    elif engine == "pallas":
        _pallas_layers(torch, pt, raw, frame, cfg, dev, layer, kernel, res)
    elif engine == "hybrid":
        _hybrid_layers(torch, pt, raw, frame, cfg, dev, layer, kernel)
    else:
        _split_layers(torch, pt, raw, frame, cfg, dev, layer, kernel, res)
        _default_pallas_decode(torch, pt, raw, frame, dev, layer, kernel,
                               res)
        _wire_decode(torch, pt, raw, dev, layer, kernel, res)
        _compact_decode(torch, pt, raw, dev, layer, kernel, res)

    # -- device busy share -----------------------------------------------
    profiled = [("encode", lambda: pt.compress_frame(
                    raw, cfg, engine=engine, device=dev))]
    if engine == "xla":
        profiled = [(side + suffix, fn) for suffix, (c, f) in frames.items()
                    for side, fn in (
                        ("encode", lambda c=c: pt.compress_frame(
                            raw, c, engine="xla", device=dev)),
                        ("decode", lambda f=f: pt.decompress_frame(
                            f, engine="xla", device=dev)))]
    elif engine != "hybrid":
        profiled.append(("decode", lambda: pt.decompress_frame(
            frame, engine=engine, device=dev)))
    if engine == "split":
        profiled.append(("decode_pallas", lambda: pt.decompress_frame(
            frame, engine="pallas", device=dev)))
    for side, fn in profiled:
        wall, union, summed, per_op = _busy(torch, fn)
        top = sorted(per_op.items(), key=lambda kv: -kv[1])[:8]
        share = union / wall if per_op else None    # no device events
        res[side]["profiled"] = {
            "wall_ms": wall, "device_union_ms": union,
            "device_summed_ms": summed, "busy_share": share,
            "top_ops_ms": top}
        print(f"{side}: profiled call {wall:.1f} ms wall, device busy "
              f"{union:.1f} ms (union of intervals; summed {summed:.1f} ms), "
              f"busy share "
              f"{'not measured' if share is None else f'{share:.4f}'}")
        for name, ms in top:
            print(f"{side}:   {ms:9.1f} ms  {name[:90]}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
