#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (divortio_lz4_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printed on its own line:

Every frame is made by the port itself: engine="pallas" (the reference
encoder's greedy scan, byte-identical to the host encoder) for independent
frames without a dictionary, the split engine for the rest. Every check
that a frame is decodable elsewhere decodes it with the other engine,
which must be exact.

1. Device and build: the card's name and power limit (nvidia-smi), the
   nvcc builds of csrc/{compact_decode,chain_decode,greedy_encode,
   token_decode,split_decode}.cu and the g++ build of
   csrc/host_kernels.cpp from this checkout (all started together), and
   ptxas's registers and spills for every entry point.
2. Kernel vs plain: the CUDA compact-decode kernel against its plain
   PyTorch version on the card, byte for byte, on the 64 MiB corpus
   frame's blocks (the main-path shape), dense 64 KB blocks, a dictionary
   batch and a batch with one row of random records; both timed with CUDA
   events. Each batch prints the kernel's per-block stats (records, groups
   of 32, dependency levels, the largest group's levels, blocks routed
   serially): the serial count must be 0, and exactly 1 with the random
   row.
3. One 64 MiB frame through compress_frame / decompress_frame (64 KB
   independent blocks, content checksum): exact round trip, decoded
   exactly by engine="pallas" too, size against the engine="pallas"
   frame's, MB/s, and the kernel's launch count during the run.
4. 16 frames of 4 MiB in flight through compress_frames /
   decompress_frames, one with block checksums and one with a dictionary.
5. Kernel vs plain for the chain and wide-block kernels, byte for byte,
   both timed with CUDA events: chain_decode on a 4 MiB linked 4 MB-block
   frame, 4 independent 1 MB blocks, a linked frame with a dictionary, a
   giant-RLE block and a batch with one chain of random records;
   wire_decode on the 64 MiB corpus's 256 independent 256 KB blocks (the
   batch phase 6 decodes), on 32 such blocks with a dictionary, and on
   that batch with one block's records replaced by random words with
   offsets below 64. Every chain and wire decode prints its
   pointer-doubling rounds, chains (blocks) routed to the serial walk and
   scratch bytes; the serial count must be 0, and 1 on each random-record
   batch.
6. The default frame (FrameConfig(): 4 MB linked blocks) at 64 MiB, with a
   content checksum, through compress_frame / decompress_frame: exact
   round trip, decoded exactly by engine="pallas", size against the
   engine="pallas" frame at 4 MB independent blocks, MB/s (median of 3)
   and chain_decode's launch count; chain_decode timed on the frame's one
   chain (the main path's launch shape; its plain version is timed on
   phase 5's 4 MiB frame), with its rounds, serial chains (0), scratch
   bytes and the call's device memory; the engine="pallas" frame at 4 MB
   independent blocks decoded exactly by both engines; then once each for
   independent 4 MB, independent 256 KB and linked 64 KB blocks, each with
   its kernel's launch count.
7. 16 default-config frames of 4 MiB in flight, and one decompress_frames
   call over a mixed batch (64 KB and 256 KB independent, 4 MB linked
   with a dictionary).
8. The engine="pallas" kernels against their plain versions, byte for
   byte, each timed with CUDA events: greedy_encode on 32 corpus blocks, 8
   random, one zero, one short and one empty row and 10 rows aimed at its
   warp steps (hash conflicts inside a step, a hit on lane 31, grown
   steps, steps cut by mf_limit, the u16 table's edge), and on 256 KB and
   4 MB rows with repeats 65535 and 65536 bytes back; timed on the 64 MiB
   frame's 1024 rows (with its warp steps and hits per block) and on 16 x
   4 MiB corpus rows (the int32 table; token_decode must give them back);
   the lane-31 row must take exactly the probe at 0 and one warp step;
   token_decode on the 64 MiB frame's 1024 blocks, a dictionary batch and
   the frame's first 64 rows with one of them random bytes (no history),
   each with its per-block stats
   (sequences, sequences the stitch walked again, matches copied in order,
   serial blocks: 0, and exactly 1 with the random row); 1024 rows,
   random ones between empty ones (as stored blocks are staged), decoded
   8 times over memory filled with 0xFF: the empty rows come back zero;
   token_decode_linked on a linked 64 KB frame with a dictionary and
   stored blocks, an independent 4 MB-block frame and a linked frame of
   three 4 MB blocks, each also decoded to its plaintext, and that linked
   frame with random bytes in its last row (kernel == plain, the rows
   before it exact), each with its resolve stats (rounds, scratch bytes);
   a linked frame of three incompressible 4 MB blocks (stored rows: one
   span slot each, so the scratch stays under 4.125 B an output byte);
   timed on the 64 MiB default frame, with its stats and device memory
   (its plain version is timed on the linked 64 KB frame). Then
   64 MiB at 64 KB independent blocks with a
   content checksum through compress_frame / decompress_frame with
   engine="pallas" (exact, MB/s median of 3, launch counts), and the 64 MiB
   default frame decoded with engine="pallas".
9. engine="hybrid": the walk kernel (greedy_encode.cu's second entry
   point) against its plain version on the same packed chains, byte for
   byte with its meta lanes: 32 corpus rows, 8 random, one zero, one short
   and one empty row; 8 rows with a 32 KB dictionary as history; 8 linked
   rows; 10 8 KB rows aimed at its segments and stitch (boundaries in a
   long match and in literal runs, periodic and small-alphabet rows,
   rows shorter than a segment), each batch with the sequences its stitch
   walked again. Each batch's streams and meta lanes also equal the host
   serializer's (chain_serialize16_meta_native) over the same exact-word
   chains. Then the 64 MiB corpus at 64 KB independent blocks through
   compress_frame(engine="hybrid") (MB/s median of 3, launches): byte-
   identical to the split engine's frame with exact chains, decoded
   exactly by both engines, size against the engine="pallas" frame; the
   kernel timed on the frame's 1024 rows, with the sequences its stitch
   walked again.
10. split_decode (the placed-literal decode) against its plain version,
   byte for byte: on the 64 MiB hybrid frame's blocks through
   parse_block_batch, a dictionary batch, and the main batch with one
   row's records replaced by random words (the other rows unchanged),
   each with the kernel's per-block stats (as phase 2's; serial blocks 0,
   and exactly 1 with the random row); decode_wire_blocks of the frame's
   blocks gives the corpus (launches counted there); the kernel timed on
   the frame's compressed blocks.
11. engine="xla" on the card (the XLA engine: torch ops, no kernel of its
   own; every step asserted to run on the card). The 64 MiB corpus at
   64 KB independent blocks with a content checksum: compress_frame /
   decompress_frame with engine="xla" exact (MB/s median of 3, size
   against the engine="pallas" frame, the loops' rounds, calls), the frame
   decoded exactly by "split" and "pallas", the split and pallas frames
   decoded exactly by "xla" and "hybrid"; encode_blocks_batch,
   decode_blocks_batch and the split engine's chain builder timed on the
   frame's 1024 rows with CUDA events, each with its byte bound. The
   64 MiB FrameConfig() frame encoded and decoded once with engine="xla"
   (exact, MB/s, decoded exactly by "split"). The routes JAX sends to the
   XLA engine, each a round trip on an 8 MiB slice: engine="pallas" with
   a 32 KB dictionary and on linked 64 KB blocks, engine="hybrid" on
   linked 64 KB blocks with block checksums (the host frame encoder, then
   the linked XLA decode), assemble="device" (== the host-assembled
   frame). On a 4 MiB slice the xla frames made on the card equal the
   port's on the CPU, at 64 KB independent and at linked 64 KB. The peak
   device memory, then a JSON line {"xla_engine": {...}}.
12. Streaming on the card (backend="device", the port's default): the
   64 MiB corpus at 64 KB blocks, independent and linked, with a content
   checksum, through CompressStream.write/flush in 4 MiB chunks
   (compress_file's default chunk_size), then a DecompressStream of its
   own fed 4 MiB chunks: exact, the frame decoded exactly by
   decompress_frame too, encode and decode MB/s (median of 3), device
   blocks, bursts and blocks a burst on both sides and the host blocks
   (device blocks must be > 0 on both sides of the independent stream,
   and on the encoder of the linked one), compact_decode's launches; the
   card's stream frame == the port's CPU stream frame on a 4 MiB prefix;
   a 256 KB-block independent frame decoded by a DecompressStream (the
   wire kernel, its launches); 8 mutated 4 MiB stream frames decoded: an
   "LZ4: ..." ValueError or at most the bound, never a fault; the peak
   device memory of the 64 KB streams and of the rest.
13. ShardedCodec on the card: make_mesh(1) and [cuda:0, cuda:0] (the
   split into shards and the join on one card), engines "best" and "xla"
   on the 64 MiB corpus at 64 KB independent blocks: the frame equals the
   single-device compress_frame(engine="hybrid") / (engine="xla") frame,
   decodes exactly through both engines, and a 256 KB-block frame (16 MiB)
   decodes exactly through the 64 KB codec; encode and decode MB/s for 1
   and 2 shards (median of 3), the kernels' launches (hybrid_encode,
   compact_decode and wire_decode must launch on "best"); the peak device
   memory.

14. The CLI on the card: divortio_lz4_tpu_torch.__main__.main(argv) in
   this process on a 16 MiB cut of the corpus. --device compress at 64 KB
   on the split, pallas and hybrid engines, at 256 KB and at the default
   4 MB (each file == compress_frame of its config and engine), each
   decoded by decompress --device (split; pallas for the pallas file);
   the stream path at 64 KB independent and at the default 4 MB linked
   (each file == a CompressStream frame fed 4 MiB chunks), decoded by the
   stream path, and the linked file by decompress --device on split and
   pallas. Every output equals the cut. One `python -m
   divortio_lz4_tpu_torch compress - | ... decompress -` pipe on 4 MiB.
   The CLI's own summary lines (MB/s) and every kernel's launches.
15. MultiHostCodec on the card: one process on ["cuda:0"], the 64 MiB
   corpus at 64 KB independent blocks: compress_corpus ==
   ShardedCodec(["cuda:0"]).compress, decompress_corpus exact, MB/s
   (median of 3) and launches; then two processes (torch.multiprocessing
   spawn, gloo, both on cuda:0) on 16 MiB: rank 0's stream == the
   ShardedCodec frames of the two shard_bounds halves joined, both ranks
   decode it exactly, MB/s from rank 0's clock. A child that fails fails
   the phase.
16. The device example (examples/12_torch_device.py, a subprocess) and
   the host facade on the card machine: pt.compress / pt.decompress on
   16 MiB (== the engine="pallas" frame at 64 KB independent blocks; the
   default frame decoded by decompress_frame on the card too),
   compress_raw / decompress_raw, the string and object helpers,
   compress_async / decompress_async and LZ4Worker's buffer and stream
   tasks on the card (== CompressStream frames), and the test vectors of
   tests/test_golden.py (copied) through the host codec, decompress_frame
   on the card and a DecompressStream.

Then a JSON line describing the kernels (with each one's bound: the bytes
the function must move, without row padding or entries it never reads,
over the H100's 3.35 TB/s; where ms and plain_ms come from different
inputs, an "inputs" key names both; "launches" counts the frame path's
run, "path_launches" the runs of phases 12, 13, 14 and 15: "stream",
"sharded", "cli", "multihost"; every kernel but split_decode must launch
in phase 14), and last the device line. Any failed check raises and the
exit code is non-zero. Needs an NVIDIA GPU, nvcc and g++; imports
neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import io
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

MIB = 1 << 20
HBM_BYTES_PER_MS = 3.35e9   # H100 SXM HBM3, 3.35 TB/s (NVIDIA data sheet)
CUDA_SOURCES = ("compact_decode", "chain_decode", "greedy_encode",
                "token_decode", "split_decode")


def _card() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def _cuda_ms(torch, fn, reps: int, warm: bool = True) -> float:
    """Mean milliseconds per call of fn() over *reps* calls (CUDA events,
    after one warm-up call unless *warm* is False)."""
    if warm:
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _timed(torch, fn):
    """(fn(), milliseconds of that one call by CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def _bound_ms(*parts) -> float:
    """The least time the card could take: the bytes the function must
    move over the HBM rate. Each part is a byte count (the wire bytes of
    padded rows, the decoded bytes), a tensor read or written whole, or
    None."""
    n = sum(x if isinstance(x, int) else x.numel() * x.element_size()
            for x in parts if x is not None)
    return n / HBM_BYTES_PER_MS


def _wire_bytes(entries) -> int:
    """The compressed bytes of a batch's blocks, without row padding."""
    return sum(len(c) for c, _ in entries)


def _match_sequences(stream: bytes) -> int:
    """The match sequences of one LZ4 block stream: every token but the
    last, which carries only the trailing literals."""
    n, i, end = 0, 0, len(stream)
    while i < end:
        t = stream[i]
        i += 1
        lit = t >> 4
        if lit == 15:
            b = 255
            while b == 255:
                b = stream[i]
                i += 1
                lit += b
        i += lit
        if i >= end:
            break
        i += 2
        if t & 15 == 15:
            while stream[i] == 255:
                i += 1
            i += 1
        n += 1
    return n


def _port_frame(pt, x, cfg, dev, dictionary=None):
    """The port's frame of *x*: engine="pallas" (reference-identical) for
    an independent frame without a dictionary, the split engine for the
    rest."""
    engine = "pallas" if cfg.block_independence and dictionary is None \
        else "split"
    return pt.compress_frame(x, cfg, dictionary=dictionary, engine=engine,
                             device=dev)


def _other_engine_exact(pt, frame, x, dev, engine, dictionary=None, what=""):
    """Decode *frame* with *engine* (the one that did not make it); it
    must give *x* exactly."""
    out = pt.decompress_frame(frame, dictionary=dictionary, engine=engine,
                              device=dev)
    if out.tobytes() != np.asarray(x).tobytes():
        raise AssertionError(f"{what}: engine={engine!r} decode differs")


def _batch(entries, window, device):
    from divortio_lz4_tpu_torch.ops.split_decode import (
        from_reference_records, parse_wire_raw)
    wire, recs_l, counts, out_lens, hist = parse_wire_raw(entries, 65536,
                                                          window)
    return from_reference_records(wire, recs_l, out_lens, hist, device), \
        int(counts.max())


def _frame_entries(frame):
    from divortio_lz4_tpu_torch.parallel.device import parse_block_index
    _, blocks, _ = parse_block_index(frame)
    return [(frame[o: o + s], st) for o, s, st in blocks]


def _chain_batch(frame, window, device):
    from divortio_lz4_tpu_torch.ops.wave_decode import stage_chains
    from divortio_lz4_tpu_torch.parallel.device import parse_block_index
    header, blocks, _ = parse_block_index(frame)
    return stage_chains(frame, blocks, header, window, device)


def _resolve_stats(fn, what: str, serial: int = 0) -> dict:
    """The stats of *fn*'s last CUDA call (decode_chains,
    decode_blocks_wire or decode_token_chains: rounds, scratch bytes and,
    on the record path, chains decoded serially); raises unless exactly
    *serial* chains took the record path's serial route (the token path
    has none)."""
    stats = fn.last.stats()
    if stats.get("serial_chains", 0) != serial:
        raise AssertionError(f"{what}: {stats['serial_chains']} chains took "
                             f"the serial route, expected {serial}")
    return stats


def _token_stats(fn, what: str, serial: int) -> str:
    """The per-block stats of decode_blocks_pallas's last CUDA call, as
    sums and maxima; raises unless exactly *serial* blocks took the serial
    route."""
    st = fn.last_stats.cpu().long()
    if int(st[:, 3].sum()) != serial:
        raise AssertionError(f"token_decode {what}: {int(st[:, 3].sum())} "
                             f"blocks took the serial route, expected "
                             f"{serial}")
    names = ("sequences", "re-walked in the stitch",
             "matches copied in order")
    parts = [f"{n} {int(st[:, i].sum())} (max {int(st[:, i].max())} a "
             f"block)" for i, n in enumerate(names)]
    return ", ".join(parts) + f", serial blocks {serial}"


def _group_stats(fn, what: str, serial: int) -> str:
    """The per-block stats of a record decode's last CUDA call
    (decode_blocks_compact or decode_blocks_split) as sums and maxima;
    raises unless exactly *serial* blocks took the serial route."""
    st = fn.last_stats.cpu().long()
    if int(st[:, 4].sum()) != serial:
        raise AssertionError(f"{what}: {int(st[:, 4].sum())} blocks took "
                             f"the serial route, expected {serial}")
    parts = [f"{n} {int(st[:, i].sum())} (max {int(st[:, i].max())} a "
             f"block)" for i, n in enumerate(("records", "groups",
                                              "levels"))]
    return (", ".join(parts) + f", the largest group's levels "
            f"{int(st[:, 3].max())}, serial blocks {serial}")


def _stats_text(stats: dict) -> str:
    serial = f"{stats['serial_chains']} chains serial, " \
        if "serial_chains" in stats else ""
    return (f"{stats['rounds']} pointer-doubling rounds, {serial}"
            f"scratch {stats['scratch_bytes']} B")


def _compare(torch, name, got, want, tag, phase=5) -> int:
    """Byte-for-byte kernel vs plain; returns the max abs difference (0).
    *got* and *want* are tensors or tuples of tensors."""
    torch.cuda.synchronize()
    err = 0
    for g, w in zip(*((x,) if torch.is_tensor(x) else x
                      for x in (got, want))):
        if g.shape != w.shape:
            raise AssertionError(f"{name}: kernel shape {tuple(g.shape)} "
                                 f"!= plain {tuple(w.shape)}")
        e = int((g.long() - w.long()).abs().max()) if g.numel() else 0
        if e:
            bad = (g != w).reshape(g.shape[0], -1).any(1).nonzero()
            raise AssertionError(f"{name}: kernel != plain (rows "
                                 f"{bad.flatten().tolist()[:8]})")
        err = max(err, e)
    print(f"phase {phase}: {name}: kernel == plain byte for byte {tag}")
    return err


def _phase5(torch, pt, dev, corpus, seed, tag):
    """chain_decode and wire_decode against their plain versions.
    Returns ((max_err, ms, plain_ms, bound_ms) for chain, the same for
    wire), timed on the 4 MiB default-config frame and on the 256
    independent 256 KB blocks of the 64 MiB corpus (phase 6's batch)."""
    from divortio_lz4_tpu_torch import FrameConfig
    from divortio_lz4_tpu_torch.ops.wave_decode import (
        decode_chains, decode_chains_plain)
    from divortio_lz4_tpu_torch.ops.wire_decode import (
        decode_blocks_wire, decode_blocks_wire_plain, parse_wire_batch)
    from bench import build_corpus

    data = build_corpus(8 * MIB, seed + 1)
    d = np.array(data[5 * MIB: 5 * MIB + 32768])
    rng = np.random.default_rng(seed)

    def frame(x, bs, indep, dic=None):
        return _port_frame(pt, x, FrameConfig(block_size=bs,
                                              block_independence=indep),
                           dev, dic)

    cases = {
        "linked_4m": _chain_batch(frame(data[:4 * MIB], 4 * MIB, False),
                                  None, dev),
        "independent_1m": _chain_batch(frame(data[4 * MIB:], MIB, True),
                                       None, dev),
        "linked_256k_dict": _chain_batch(
            frame(data[6 * MIB: 7 * MIB], 256 * 1024, False, d), d, dev),
        "giant_rle": _chain_batch(frame(np.zeros(MIB + 1000, np.uint8),
                                        MIB, True), None, dev),
    }
    hb = cases["independent_1m"]
    r0, r1 = int(hb.rec_off[1]), int(hb.rec_off[2])
    words = hb.rec_words.clone()
    words[r0:r1] = torch.from_numpy(rng.integers(
        -2**31, 2**31, (r1 - r0, 3), dtype=np.int64).astype(np.int32)).to(dev)
    cases["hostile"] = hb._replace(rec_words=words)
    chain_err, outs = 0, {}
    for name, b in cases.items():
        got = decode_chains(b)
        chain_err = max(chain_err, _compare(torch, f"chain_decode {name}",
                                            got, decode_chains_plain(b),
                                            tag))
        outs[name] = got
        stats = _resolve_stats(decode_chains, f"chain_decode {name}",
                               1 if name == "hostile" else 0)
        print(f"phase 5: chain_decode {name}: {b.wire_off.shape[0] - 1} "
              f"chains, {b.rec_words.shape[0]} records, {b.out_total} B; "
              f"{_stats_text(stats)} {tag}")
    o1, o2 = int(hb.out_off[1]), int(hb.out_off[2])
    for part in (slice(0, o1), slice(o2, None)):
        if not torch.equal(outs["hostile"][part],
                           outs["independent_1m"][part]):
            raise AssertionError("hostile records changed another chain")
    print(f"phase 5: hostile: no fault, the other chains exact {tag}")
    main = cases["linked_4m"]
    chain = (chain_err, _cuda_ms(torch, lambda: decode_chains(main), 5),
             _cuda_ms(torch, lambda: decode_chains_plain(main), 1, False),
             _bound_ms(*main[:6], main.out_total))
    print(f"phase 5: chain_decode linked_4m: kernel {chain[1]:.3f} ms "
          f"({main.out_total / chain[1] / 1e3:.1f} MB/s), plain "
          f"{chain[2]:.1f} ms {tag}")

    # the main-path batch (the 64 MiB corpus at 256 KB, as phase 6 decodes
    # it), then a dictionary batch
    wire_err, timed = 0, None
    for x, dic in ((corpus, None), (data, d)):
        entries = _frame_entries(frame(x, 256 * 1024, True, dic))
        w, recs, counts, out_lens, hist = parse_wire_batch(entries,
                                                           256 * 1024, dic)
        args_ = [torch.from_numpy(a).to(dev) for a in (w, recs, counts)]
        args_ += [256 * 1024,
                  None if hist is None else torch.from_numpy(hist).to(dev)]
        name = f"wire_decode {len(entries)} x 256 KB" + \
            (" dictionary" if dic is not None else "")
        wire_err = max(wire_err, _compare(
            torch, name, decode_blocks_wire(*args_),
            decode_blocks_wire_plain(*args_), tag))
        stats = _resolve_stats(decode_blocks_wire, name, 0)
        print(f"phase 5: {name}: {int(counts.sum())} records; "
              f"{_stats_text(stats)} {tag}")
        if timed is None:
            # wire bytes, records (8 B each) and counts in, decoded bytes out
            timed, timed_name = args_, name
            wire_need = _wire_bytes(entries) + 8 * int(counts.sum()) \
                + 4 * len(counts) + int(out_lens.sum())
    # hostile: one block of the dictionary batch holds random words whose
    # offsets are below 64 (matches reaching into themselves, offsets of
    # 0): it fails the conformance check and takes the serial walk
    h = int(torch.argmax(args_[2]))
    n = int(args_[2][h])
    words = rng.integers(0, 2**32, (n, 2), dtype=np.uint64)
    words[:, 1] = (words[:, 1] & ~np.uint64(0xFFFF)) \
        | (words[:, 1] & np.uint64(63))
    recs_h = args_[1].clone()
    recs_h[h, :n] = torch.from_numpy(
        words.astype(np.uint32).view(np.int32)).to(dev)
    hargs = [args_[0], recs_h] + args_[2:]
    hgot = decode_blocks_wire(*hargs)
    wire_err = max(wire_err, _compare(
        torch, f"wire_decode, block {h} random records", hgot,
        decode_blocks_wire_plain(*hargs), tag))
    stats = _resolve_stats(decode_blocks_wire, "wire_decode hostile", 1)
    dgot = decode_blocks_wire(*args_)
    others = [i for i in range(dgot.shape[0]) if i != h]
    if not torch.equal(hgot[others], dgot[others]):
        raise AssertionError("random records in one block changed another")
    print(f"phase 5: wire_decode hostile block: no fault, the other "
          f"{len(others)} blocks exact; {_stats_text(stats)} {tag}")
    wire = (wire_err, _cuda_ms(torch, lambda: decode_blocks_wire(*timed), 5),
            _cuda_ms(torch, lambda: decode_blocks_wire_plain(*timed), 1,
                     False),
            _bound_ms(wire_need))
    decode_blocks_wire(*timed)
    stats = _resolve_stats(decode_blocks_wire, timed_name, 0)
    print(f"phase 5: {timed_name}: kernel {wire[1]:.3f} ms "
          f"({len(corpus) / wire[1] / 1e3:.1f} MB/s), plain {wire[2]:.1f} "
          f"ms; {_stats_text(stats)} {tag}")
    return chain, wire


def _roundtrip(pt, corpus, cfg, dev, reps):
    """Encode and decode *corpus* *reps* times with the split engine;
    checks (engine="pallas" decodes the frame exactly too) and returns
    (frame, encode seconds, decode seconds)."""
    t_enc, t_dec = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        frame = pt.compress_frame(corpus, cfg, device=dev)
        t1 = time.perf_counter()
        out = pt.decompress_frame(frame, device=dev)
        t2 = time.perf_counter()
        t_enc.append(t1 - t0)
        t_dec.append(t2 - t1)
        if out.tobytes() != corpus.tobytes():
            raise AssertionError(f"{cfg}: round trip is not exact")
    _other_engine_exact(pt, frame, corpus, dev, "pallas", what=str(cfg))
    return frame, t_enc, t_dec


def _phase6(torch, pt, dev, corpus, tag):
    """The default frame at 64 MiB, then the other block routes once.
    Returns (the default frame, the launch counts of chain_decode (default
    frame) and wire_decode (256 KB blocks), chain_decode's time, bound and
    resolve stats on the frame's chain)."""
    from divortio_lz4_tpu_torch import FrameConfig
    from divortio_lz4_tpu_torch.ops.compact_decode import decode_blocks_compact
    from divortio_lz4_tpu_torch.ops.wave_decode import decode_chains
    from divortio_lz4_tpu_torch.ops.wire_decode import decode_blocks_wire

    n = len(corpus)
    cfg = FrameConfig(content_checksum=True)
    ref = pt.compress_frame(corpus, cfg.with_(block_independence=True),
                            engine="pallas", device=dev)
    for engine in ("split", "pallas"):
        _other_engine_exact(pt, ref, corpus, dev, engine,
                            what="engine='pallas' 4 MB-block frame")
    print(f"phase 6: engine='pallas' frame at 4 MB independent blocks, "
          f"{len(ref)} B: both engines decode it exactly {tag}")
    _roundtrip(pt, corpus, cfg, dev, 1)          # warm-up
    decode_chains.launches = 0
    frame, t_enc, t_dec = _roundtrip(pt, corpus, cfg, dev, 3)
    chain_launches = decode_chains.launches
    if chain_launches < 1:
        raise AssertionError("the default frame never launched chain_decode")
    enc_s, dec_s = statistics.median(t_enc), statistics.median(t_dec)
    print(f"phase 6: default frame (4 MB linked) 64 MiB, {len(frame)} B, "
          f"ratio vs the engine='pallas' frame at 4 MB independent blocks "
          f"{len(frame) / len(ref):.4f} ({len(ref)} B); round trip exact, "
          f"engine='pallas' decodes it exactly; chain_decode launches "
          f"{chain_launches} {tag}")
    print(f"phase 6: default frame: encode {n / enc_s / 1e6:.1f} MB/s, "
          f"decode {n / dec_s / 1e6:.1f} MB/s (median of 3; enc {t_enc}, "
          f"dec {t_dec} s) {tag}")
    _resolve_stats(decode_chains, "the default frame's decode", 0)
    # chain_decode at the main path's launch shape: the frame's one chain
    batch = _chain_batch(frame, None, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = decode_chains(batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    if out.cpu().numpy().tobytes() != corpus.tobytes():
        raise AssertionError("chain_decode of the default frame's chain "
                             "does not give the corpus")
    stats = _resolve_stats(decode_chains, "chain_decode, default frame", 0)
    ms = _cuda_ms(torch, lambda: decode_chains(batch), 5)
    chain64 = dict(ms=ms, bound_ms=_bound_ms(*batch[:6], batch.out_total),
                   records=batch.rec_words.shape[0], **stats)
    print(f"phase 6: chain_decode, the default frame's chain "
          f"({chain64['records']} records): kernel {ms:.3f} ms "
          f"({n / ms / 1e3:.1f} MB/s), bound {chain64['bound_ms']:.4f} ms; "
          f"{_stats_text(stats)}; device memory of the call {peak} B "
          f"(output included) {tag}")
    counters = {"chain_decode": decode_chains,
                "wire_decode": decode_blocks_wire,
                "compact_decode": decode_blocks_compact}
    counts = {}
    for label, c, kernel in (
            ("independent 4 MB", FrameConfig(block_independence=True),
             "chain_decode"),
            ("independent 256 KB", FrameConfig(block_size=256 * 1024,
                                               block_independence=True),
             "wire_decode"),
            ("linked 64 KB", FrameConfig(block_size=65536), "chain_decode")):
        for fn in counters.values():
            fn.launches = 0
        f, t_enc, t_dec = _roundtrip(pt, corpus, c, dev, 1)
        counts[label] = counters[kernel].launches
        if counts[label] < 1:
            raise AssertionError(f"{label} never launched {kernel}")
        print(f"phase 6: {label} 64 MiB, {len(f)} B: exact, engine='pallas' "
              f"decodes it exactly; encode {n / t_enc[0] / 1e6:.1f} MB/s, "
              f"decode {n / t_dec[0] / 1e6:.1f} MB/s; {kernel} launches "
              f"{counts[label]} {tag}")
    return frame, chain_launches, counts["independent 256 KB"], chain64


def _phase7(torch, pt, dev, corpus, d, tag):
    """Default-config frames in flight, and a mixed batch in one call."""
    from divortio_lz4_tpu_torch import FrameConfig
    n = 64 * MIB
    datas = [corpus[i * 4 * MIB: (i + 1) * 4 * MIB] for i in range(16)]
    t0 = time.perf_counter()
    frames = pt.compress_frames(datas, device=dev)
    t1 = time.perf_counter()
    outs = pt.decompress_frames(frames, device=dev)
    t2 = time.perf_counter()
    for i, (o, x) in enumerate(zip(outs, datas)):
        if o.tobytes() != x.tobytes():
            raise AssertionError(f"default-config frame {i} differs")
    print(f"phase 7: 16 x 4 MiB default-config frames exact; encode "
          f"{n / (t1 - t0) / 1e6:.1f} MB/s, decode {n / (t2 - t1) / 1e6:.1f} "
          f"MB/s {tag}")
    mixed = [(datas[0], FrameConfig(block_size=65536,
                                    block_independence=True)),
             (datas[1], FrameConfig(block_size=256 * 1024,
                                    block_independence=True)),
             (datas[2], FrameConfig(content_checksum=True))]
    frames = [pt.compress_frame(x, c, dictionary=d, device=dev)
              for x, c in mixed]
    outs = pt.decompress_frames(frames, dictionary=d, device=dev)
    for (x, c), o in zip(mixed, outs):
        if o.tobytes() != x.tobytes():
            raise AssertionError(f"mixed batch: {c} differs")
    outs = pt.decompress_frames(frames, dictionary=d, engine="pallas",
                                device=dev)
    for (x, c), o in zip(mixed, outs):
        if o.tobytes() != x.tobytes():
            raise AssertionError(f"mixed batch: engine='pallas' decode of "
                                 f"{c} differs")
    print(f"phase 7: mixed batch (64 KB, 256 KB independent; 4 MB linked; "
          f"dictionary) exact in one decompress_frames call, with either "
          f"engine {tag}")
    peak = torch.cuda.max_memory_allocated() / MIB
    print(f"phase 7: peak device memory {peak:.0f} MiB {tag}")


def _json_payload(n: int) -> np.ndarray:
    """JSON event records (bench.build_corpus's log records): few LZ4
    sequences per KB, so the plain versions stay quick."""
    rec = (b'{"ts":1700000000,"level":"info","service":"api-gateway",'
           b'"msg":"request completed","status":200,"latency_ms":%d,'
           b'"path":"/v1/users/%d"}\n')
    return np.frombuffer(b"".join(rec % (i % 900, i * 7919 % 100000)
                                  for i in range(n // 120 + 1)),
                         np.uint8)[:n].copy()


def _json_low(n: int, rng) -> np.ndarray:
    """*n* bytes of 60000-byte periods of JSON records, one byte of each
    period changed: a few LZ4 sequences per period, so the plain versions
    stay quick on blocks of 4 MB."""
    x = np.tile(_json_payload(60_000), n // 60_000 + 1)[:n]
    at = np.arange(0, n, 60_000) + rng.integers(0, 60_000, -(-n // 60_000))
    x[at[at < n]] = ord("#")
    return x


def _far_row(n: int, at: int, rng) -> np.ndarray:
    """*n* bytes, zeros but for two 8 KB chunks of random bytes, each
    written twice: one at 0 and 65535 (a match at the largest offset), one
    at *at* and at + 65536, where every candidate lies one byte past the
    window and the encoder must refuse it."""
    row = np.zeros(n, np.uint8)
    for start, gap in ((0, 65535), (at, 65536)):
        chunk = rng.integers(1, 256, 8192, dtype=np.uint8)
        row[start: start + 8192] = chunk
        row[start + gap: start + gap + 8192] = chunk
    return row


def _greedy_hostile(rng) -> list:
    """64 KB-or-shorter rows aimed at the greedy kernel's 32-probe steps:
    a hit on lane 31 (first, a 48-byte row whose scan is the probe at 0
    and one step: s = 0 misses, the step from s = 1 probes 1 + i on lane
    i, and position 32 repeats position 0; then a 4 KB row), two probes of
    one step that share a hash (equal words, and unequal words with one
    hash, the later lane writing the table), a match found after the step
    has grown past 1, rows whose steps mf_limit cuts, and a full 64 KB row
    whose match source is position 0 (the u16 table's edge)."""
    def rand(n):
        return rng.integers(0, 256, n, dtype=np.uint8)
    same = [np.frombuffer(np.uint32(x).tobytes(), np.uint8)
            for x in (0xDE257AB6, 0x9B6E60A3)]   # one hash, two words
    r = rand(4096)
    r[32:36] = r[0:4]
    rows = [r[:48].copy(), r]
    r = rand(4096)
    r[9:13] = r[2:6]
    rows.append(r)
    r = rand(4096)
    r[2:6], r[9:13], r[40:44] = same[0], same[1], same[0]
    rows.append(r)
    r = rand(4096)
    r[2:6], r[9:13], r[16:20] = same[0], same[1], same[0]
    rows.append(r)
    r = rand(16384)
    r[12000:14000] = r[100:2100]
    rows.append(r)
    for n in (13, 40, 50, 77):
        r = rand(n)
        if n >= 20:
            r[n - 15: n - 11] = r[1:5]
        rows.append(r)
    r = rand(65536)
    r[65000:] = r[:536]
    rows.append(r)
    return rows


def _phase8(torch, pt, dev, corpus, ref_frame, dict_frame, d,
            default_frame, seed, tag):
    """The engine="pallas" kernels against their plain versions, timed;
    then the engine's main path. Returns {kernel name: JSON fields}."""
    from divortio_lz4_tpu_torch import FrameConfig
    from divortio_lz4_tpu_torch.ops.greedy_encode import (
        encode_blocks_pallas, encode_blocks_pallas_plain)
    from divortio_lz4_tpu_torch.ops.token_decode import (
        decode_blocks_pallas, decode_blocks_pallas_plain, decode_token_chains,
        decode_token_chains_plain)
    from divortio_lz4_tpu_torch.parallel.device import (
        _blocks_to_batch, parse_block_index, stage_token_blocks,
        stage_token_chains)

    rng = np.random.default_rng(seed + 8)
    B = 65536
    res = {}

    # -- greedy_encode ---------------------------------------------------
    nblk = len(corpus) // B
    rows = [corpus[(k * nblk // 32) * B: (k * nblk // 32 + 1) * B]
            for k in range(32)]
    rows += [rng.integers(0, 256, B, dtype=np.uint8) for _ in range(8)]
    rows += [np.zeros(B, np.uint8), corpus[:10], corpus[:0]]
    hostile = _greedy_hostile(rng)
    rows += hostile
    work = np.zeros((len(rows), B), np.uint8)
    lens = np.array([len(r) for r in rows], np.int64)
    for i, r in enumerate(rows):
        work[i, : len(r)] = r
    w, ln = torch.from_numpy(work).to(dev), torch.from_numpy(lens).to(dev)
    got = encode_blocks_pallas(w, ln, B)
    lane31 = len(rows) - len(hostile)
    st = encode_blocks_pallas.last_stats[lane31].tolist()
    token, ext = got[0][lane31, :2].tolist()
    if st != [2, 1] or token >> 4 != 15 or ext != 17:
        raise AssertionError(f"greedy_encode's lane-31 row: warp steps and "
                             f"hits {st}, not [2, 1] with 32 literals")
    print(f"phase 8: greedy_encode lane-31 row: warp steps and hits {st} "
          f"(the probe at 0, then one step whose lane 31 hits after 32 "
          f"literals) {tag}")
    want, plain_ms = _timed(torch, lambda: encode_blocks_pallas_plain(w, ln,
                                                                      B))
    err = _compare(torch, f"greedy_encode {len(rows)} rows (32 corpus, 8 "
                   f"random, zero, short, empty, {len(hostile)} hostile: "
                   "hash conflicts in one warp step, a hit on lane 31, "
                   "grown steps, steps cut by mf_limit, the u16 table's "
                   "edge)", got, want, tag, 8)
    # past 64 KB the window check decides: repeats 65535 and 65536 back
    for bs, far in ((256 * 1024, [_far_row(256 * 1024, 150_000, rng),
                                  _json_payload(200_000)]),
                    (4 * MIB, [_far_row(4 * MIB, 3 * MIB, rng)])):
        fw = np.zeros((len(far), bs), np.uint8)
        for i, r in enumerate(far):
            fw[i, : len(r)] = r
        fw = torch.from_numpy(fw).to(dev)
        fl = torch.tensor([len(r) for r in far], dtype=torch.int64,
                          device=dev)
        err = max(err, _compare(
            torch, f"greedy_encode {len(far)} x {bs >> 10} KB rows with "
            "repeats 65535 and 65536 bytes back", encode_blocks_pallas(
                fw, fl, bs), encode_blocks_pallas_plain(fw, fl, bs), tag, 8))
    mw, ml, _ = _blocks_to_batch(corpus, B)
    mw = torch.from_numpy(mw).to(dev)
    ml = torch.from_numpy(ml.astype(np.int64)).to(dev)
    mout = encode_blocks_pallas(mw, ml, B)
    st = encode_blocks_pallas.last_stats.cpu().double()
    print(f"phase 8: greedy_encode {mw.shape[0]} x 64 KB: warp steps per "
          f"block mean {float(st[:, 0].mean()):.1f} max "
          f"{int(st[:, 0].max())}, hits per block mean "
          f"{float(st[:, 1].mean()):.1f} max {int(st[:, 1].max())} {tag}")
    ms = _cuda_ms(torch, lambda: encode_blocks_pallas(mw, ml, B), 5)
    bw = torch.from_numpy(corpus[: 16 * 4 * MIB].reshape(16, 4 * MIB)).to(dev)
    bl = torch.full((16,), 4 * MIB, dtype=torch.int64, device=dev)
    bout = encode_blocks_pallas(bw, bl, 4 * MIB)
    st = encode_blocks_pallas.last_stats.cpu()
    back = decode_blocks_pallas(bout[0], bout[1], 4 * MIB)
    if not (torch.equal(back[0], bw) and torch.equal(back[1], bl)):
        raise AssertionError("greedy_encode's 16 x 4 MiB rows do not decode "
                             "back to their corpus bytes")
    b_ms = _cuda_ms(torch, lambda: encode_blocks_pallas(bw, bl, 4 * MIB), 3)
    print(f"phase 8: greedy_encode 16 x 4 MiB rows (int32 table): kernel "
          f"{b_ms:.3f} ms ({len(corpus) / b_ms / 1e3:.1f} MB/s), "
          f"{int(bout[1].sum())} B out (token_decode gives the rows back), "
          f"warp steps per block max "
          f"{int(st[:, 0].max())}, hits max {int(st[:, 1].max())}, bound "
          f"{_bound_ms(bw, bl, int(bout[1].sum()), bout[1]):.4f} ms {tag}")
    # payload and lengths in, the encoded streams and lengths out
    res["greedy_encode"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=_bound_ms(int(ml.sum()), ml, int(mout[1].sum()), mout[1]))
    print(f"phase 8: greedy_encode {mw.shape[0]} x 64 KB (the 64 MiB "
          f"frame's rows): kernel {ms:.3f} ms ({len(corpus) / ms / 1e3:.1f} "
          f"MB/s), plain {plain_ms:.1f} ms on the {len(rows)}-row batch, "
          f"bound {res['greedy_encode']['bound_ms']:.4f} ms {tag}")

    # -- token_decode ----------------------------------------------------
    def blocks_of(frame, window):
        _, blocks, _ = parse_block_index(frame)
        return blocks, stage_token_blocks(frame, blocks, window, dev)

    blocks, main = blocks_of(ref_frame, None)
    got = decode_blocks_pallas(main[0], main[1], B, main[2])
    main_stats = _token_stats(decode_blocks_pallas, "token_decode, the "
                              "64 MiB frame's blocks", 0)
    want, plain_ms = _timed(torch, lambda: decode_blocks_pallas_plain(
        main[0], main[1], B, main[2]))
    err = _compare(torch, f"token_decode {len(blocks)} x 64 KB (the 64 MiB "
                   "frame's blocks)", got, want, tag, 8)
    rows_np, lens_np = got[0].cpu().numpy(), got[1].cpu().numpy()
    joined = np.concatenate([ref_frame[o: o + s] if st
                             else rows_np[i, : lens_np[i]]
                             for i, (o, s, st) in enumerate(blocks)])
    if joined.tobytes() != corpus.tobytes():
        raise AssertionError("token_decode of the 64 MiB frame's blocks "
                             "does not give the corpus")
    _, dic = blocks_of(dict_frame, d)
    dgot = decode_blocks_pallas(dic[0], dic[1], B, dic[2])
    print(f"phase 8: token_decode dictionary batch: "
          f"{_token_stats(decode_blocks_pallas, 'dictionary batch', 0)} "
          f"{tag}")
    err = max(err, _compare(torch, f"token_decode {dic[0].shape[0]} blocks "
                            "with a dictionary", dgot,
                            decode_blocks_pallas_plain(dic[0], dic[1], B,
                                                       dic[2]), tag, 8))
    # hostile: the first 64 of the frame's rows, one of them random bytes
    # (no history: its first match reaches before the row, so it takes
    # the serial route)
    hostile, hlens = main[0][:64].clone(), main[1][:64]
    h = int(torch.nonzero(hlens)[0])
    nh = int(hlens[h])
    hostile[h, :nh] = torch.from_numpy(rng.integers(
        0, 256, nh, dtype=np.uint8)).to(dev)
    hgot = decode_blocks_pallas(hostile, hlens, B)
    hstats = _token_stats(decode_blocks_pallas, "hostile batch", 1)
    err = max(err, _compare(torch, f"token_decode, row {h} of 64 random "
                            "bytes", hgot, decode_blocks_pallas_plain(
                                hostile, hlens, B), tag, 8))
    others = [i for i in range(hostile.shape[0]) if i != h]
    if not (torch.equal(hgot[0][others], got[0][others])
            and torch.equal(hgot[1][others], got[1][others])):
        raise AssertionError(f"random bytes in row {h} changed another row")
    print(f"phase 8: token_decode hostile row: no fault, the other "
          f"{len(others)} rows exact; {hstats} {tag}")
    # rows of length 0 (stored blocks are staged so) between random rows,
    # more rows than the card runs at once, over memory filled with 0xFF:
    # each empty row must come back a zero row, whatever the SM's shared
    # memory held (the random rows' serial route leaves its flag set)
    erng = np.random.default_rng(seed + 81)
    erows = np.zeros((1024, 256), np.uint8)
    elens = np.zeros(1024, np.int64)
    elens[::2] = erng.integers(1, 192, 512)
    for i in range(0, 1024, 2):
        erows[i, :elens[i]] = erng.integers(0, 256, elens[i], dtype=np.uint8)
    erows, elens = torch.from_numpy(erows).to(dev), \
        torch.from_numpy(elens).to(dev)
    ewant = decode_blocks_pallas_plain(erows, elens, B)
    for trial in range(8):
        poison = torch.full((1024, B), 255, dtype=torch.uint8, device=dev)
        del poison   # the kernel's output takes this block back
        egot = decode_blocks_pallas(erows, elens, B)
        err = max(err, _compare(torch, f"token_decode, 512 empty rows "
                                f"between random rows over 0xFF memory "
                                f"(call {trial + 1} of 8)", egot, ewant,
                                tag, 8))
    ms = _cuda_ms(torch, lambda: decode_blocks_pallas(main[0], main[1], B,
                                                      main[2]), 5)
    # wire bytes and lengths in, decoded bytes and lengths out
    res["token_decode"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=_bound_ms(int(main[1].sum()), main[1], int(got[1].sum()),
                           got[1]))
    print(f"phase 8: token_decode {len(blocks)} x 64 KB: kernel {ms:.3f} ms "
          f"({len(corpus) / ms / 1e3:.1f} MB/s of output), plain "
          f"{plain_ms:.1f} ms, bound {res['token_decode']['bound_ms']:.4f} "
          f"ms; {main_stats} {tag}")

    # -- token_decode_linked ---------------------------------------------
    linked = np.concatenate([_json_payload(3 * B),
                             rng.integers(0, 256, B, dtype=np.uint8),
                             _json_payload(2 * B)[B // 2:]])
    lframe = pt.compress_frame(linked, FrameConfig(block_size=B),
                               dictionary=d, device=dev)
    big = np.concatenate([np.repeat(rng.integers(0, 256, 8192,
                                                 dtype=np.uint8), 512),
                          _json_payload(4 * B)])
    bframe = pt.compress_frame(big, FrameConfig(block_independence=True),
                               engine="pallas", device=dev)
    # the default frame's row shape and chaining: 3 linked 4 MB blocks
    low = _json_low(3 * 4 * MIB - 5000, rng)
    dframe = pt.compress_frame(low, FrameConfig(), device=dev)
    noise = rng.integers(0, 256, 3 * 4 * MIB, dtype=np.uint8)
    rframe = pt.compress_frame(noise, FrameConfig(), device=dev)
    err, plain_ms = 0, None
    for name, frame, x, window, scan in (
            ("linked 64 KB, dictionary, stored block", lframe, linked, d,
             False),
            ("independent 4 MB blocks", bframe, big, None, True),
            ("linked 4 MB blocks (the default config)", dframe, low, None,
             True),
            ("linked 4 MB blocks, incompressible", rframe, noise, None,
             True)):
        header, blocks, _ = parse_block_index(frame)
        if name.startswith("linked 64") and not any(st for *_, st in blocks):
            raise AssertionError("the linked frame has no stored block")
        if name.endswith("incompressible") and \
                not all(st for *_, st in blocks):
            raise AssertionError("the incompressible frame has a "
                                 "compressed block")
        batch, starts, out_off = stage_token_chains(frame, blocks, header,
                                                    window, dev, scan)
        got = decode_token_chains(batch)
        want, p_ms = _timed(torch, lambda: decode_token_chains_plain(batch))
        plain_ms = p_ms if plain_ms is None else plain_ms
        err = max(err, _compare(torch, f"token_decode_linked {name} "
                                f"({batch.row_off.shape[0] - 1} chains, "
                                f"{len(blocks)} rows)", got, want, tag, 8))
        flat, ols = got[0].cpu().numpy(), got[1].cpu().numpy()
        done = np.concatenate([[0], np.cumsum(ols)])[starts]
        joined = np.concatenate([flat[out_off[c]: out_off[c] + done[c + 1]
                                      - done[c]]
                                 for c in range(len(starts) - 1)])
        if joined.tobytes() != x.tobytes():
            raise AssertionError(f"token_decode_linked {name}: the decoded "
                                 "chains do not give the plaintext")
        stats = _resolve_stats(decode_token_chains,
                               f"token_decode_linked {name}")
        if name.endswith("incompressible") and \
                stats["scratch_bytes"] >= 4 * len(x) + len(x) // 8:
            raise AssertionError(f"token_decode_linked {name}: scratch "
                                 f"{stats['scratch_bytes']} B for {len(x)} "
                                 f"B of stored rows")
        print(f"phase 8: token_decode_linked {name}: {len(frame)} B frame, "
              f"plain {p_ms:.1f} ms, decodes to its {len(x)} B exactly; "
              f"{_stats_text(stats)} {tag}")
        if name.startswith("linked 4 MB blocks (the"):
            dbatch, dgot = batch, got
    # random bytes in the last row (the last scanned piece of the third
    # linked 4 MB block): kernel == plain, the rows before it exact (its
    # length may hit the region's cap)
    batch, got = dbatch, dgot
    r = batch.stored.shape[0] - 1
    a, b = int(batch.comp_off[r]), int(batch.comp_off[r + 1])
    comp = batch.comp.clone()
    comp[a:b] = torch.from_numpy(rng.integers(0, 256, b - a,
                                              dtype=np.uint8)).to(dev)
    hostile = batch._replace(comp=comp)
    hgot = decode_token_chains(hostile)
    err = max(err, _compare(torch, f"token_decode_linked, row {r} of the "
                            "linked 4 MB frame random bytes", hgot,
                            decode_token_chains_plain(hostile), tag, 8))
    stats = _resolve_stats(decode_token_chains,
                           "token_decode_linked hostile row")
    head = int(got[1][:r].sum())
    if not (torch.equal(hgot[1][:r], got[1][:r])
            and torch.equal(hgot[0][:head], got[0][:head])):
        raise AssertionError(f"random bytes in row {r} changed the rows "
                             "before it")
    print(f"phase 8: token_decode_linked hostile row: no fault, rows 0-"
          f"{r - 1} of {r + 1} exact, row {r} decodes {int(hgot[1][r])} B "
          f"of {int(got[1][r])}; {_stats_text(stats)} {tag}")
    header, blocks, _ = parse_block_index(default_frame)
    main = stage_token_chains(default_frame, blocks, header, None, dev,
                              True)[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    mout = decode_token_chains(main)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    if mout[0][: len(corpus)].cpu().numpy().tobytes() != corpus.tobytes():
        raise AssertionError("token_decode_linked of the default frame does "
                             "not give the corpus")
    stats = _resolve_stats(decode_token_chains,
                           "token_decode_linked, default frame")
    print(f"phase 8: token_decode_linked, the default frame: "
          f"{_stats_text(stats)}; device memory of the call {peak} B "
          f"(output included) {tag}")
    ms = _cuda_ms(torch, lambda: decode_token_chains(main), 5)
    # wire bytes, row flags, offsets and lengths in, decoded bytes out
    res["token_decode_linked"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=_bound_ms(*main[:6], int(mout[1].sum()), mout[1]))
    print(f"phase 8: token_decode_linked, the 64 MiB default frame (one "
          f"chain, {len(blocks)} blocks staged as {main.stored.shape[0]} "
          f"rows): kernel {ms:.3f} ms "
          f"({len(corpus) / ms / 1e3:.1f} MB/s), plain {plain_ms:.1f} ms on "
          f"the linked 64 KB frame ({len(linked)} B), bound "
          f"{res['token_decode_linked']['bound_ms']:.4f} ms {tag}")

    # -- the engine="pallas" main path -------------------------------------
    cfg = FrameConfig(block_size=B, block_independence=True,
                      content_checksum=True)
    n = len(corpus)
    frame = pt.compress_frame(corpus, cfg, engine="pallas", device=dev)
    pt.decompress_frame(frame, engine="pallas", device=dev)   # warm-up
    encode_blocks_pallas.launches = 0
    decode_blocks_pallas.launches = 0
    t_enc, t_dec = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        frame = pt.compress_frame(corpus, cfg, engine="pallas", device=dev)
        t1 = time.perf_counter()
        out = pt.decompress_frame(frame, engine="pallas", device=dev)
        t2 = time.perf_counter()
        t_enc.append(t1 - t0)
        t_dec.append(t2 - t1)
        if out.tobytes() != corpus.tobytes():
            raise AssertionError("engine='pallas' 64 MiB round trip is not "
                                 "exact")
    res["greedy_encode"]["launches"] = encode_blocks_pallas.launches
    res["token_decode"]["launches"] = decode_blocks_pallas.launches
    for k in ("greedy_encode", "token_decode"):
        if res[k]["launches"] < 1:
            raise AssertionError(f"the engine='pallas' main path never "
                                 f"launched {k}")
    if frame.tobytes() != ref_frame.tobytes():
        raise AssertionError("engine='pallas' frames differ between runs")
    _other_engine_exact(pt, frame, corpus, dev, "split",
                        what="engine='pallas' 64 MiB frame")
    enc_s, dec_s = statistics.median(t_enc), statistics.median(t_dec)
    print(f"phase 8: engine='pallas' 64 MiB frame (64 KB independent, "
          f"content checksum), {len(frame)} B: round trip exact, the split "
          f"engine decodes it exactly; greedy_encode launches "
          f"{res['greedy_encode']['launches']}, token_decode launches "
          f"{res['token_decode']['launches']} {tag}")
    print(f"phase 8: engine='pallas': encode {n / enc_s / 1e6:.1f} MB/s, "
          f"decode {n / dec_s / 1e6:.1f} MB/s (median of 3; enc {t_enc}, "
          f"dec {t_dec} s) {tag}")
    decode_token_chains.launches = 0
    t0 = time.perf_counter()
    out = pt.decompress_frame(default_frame, engine="pallas", device=dev)
    dt = time.perf_counter() - t0
    res["token_decode_linked"]["launches"] = decode_token_chains.launches
    if out.tobytes() != corpus.tobytes():
        raise AssertionError("engine='pallas' decode of the default frame "
                             "differs")
    if res["token_decode_linked"]["launches"] < 1:
        raise AssertionError("the default frame's engine='pallas' decode "
                             "never launched token_decode_linked")
    _resolve_stats(decode_token_chains, "the default frame's "
                   "engine='pallas' decode")
    print(f"phase 8: default frame (4 MB linked, split-made) decoded with "
          f"engine='pallas': exact, {n / dt / 1e6:.1f} MB/s ({dt:.3f} s); "
          f"token_decode_linked launches "
          f"{res['token_decode_linked']['launches']} {tag}")
    return res


def _rows_batch(torch, rows, dev, B=65536, hist=None):
    """[history | payload] rows on *dev*: (work u8, lens i64, hist_len)."""
    hl = 0 if hist is None else 65536
    work = np.zeros((len(rows), hl + B), np.uint8)
    lens = np.array([len(r) for r in rows], np.int64)
    for i, r in enumerate(rows):
        if hist is not None:
            work[i, :hl] = hist[i]
        work[i, hl: hl + len(r)] = r
    return (torch.from_numpy(work).to(dev), torch.from_numpy(lens).to(dev),
            hl)


def _split_exact_frame(pt, corpus, cfg, dev):
    """The split engine's frame of *corpus* (independent blocks of at most
    64 KB, no dictionary) with exact-word chains instead of hashed ones."""
    from divortio_lz4_tpu_torch.ops.split_encode import encode_blocks_chain
    from divortio_lz4_tpu_torch.parallel.device import (
        _assemble_frame_host, _EncodeState, _history_rows,
        _split_encode_fetch)
    bs = cfg.resolved_block_size
    work, lens, nb, hl, hs = _history_rows(corpus, bs, None, False)
    chains = encode_blocks_chain(work, lens, bs, hl, hs, device=dev,
                                 exact=True)
    st = _EncodeState(corpus, work, lens, nb, bs, hl, chains)
    return _assemble_frame_host(corpus, _split_encode_fetch(
        st, chains.cpu().numpy()), lens, nb, bs, cfg, None)


def _walk_hostile(rng) -> list:
    """8 KB-or-shorter rows aimed at the segmented walk: a long match over
    several segment boundaries, a row of literals with one short match,
    periodic rows, small-alphabet rows whose segments meet late (the stitch
    walks on), and rows shorter than a segment."""
    def rand(n, a=256):
        return rng.integers(0, a, n, dtype=np.uint8)
    long_match, lits = rand(8192), rand(8192)
    long_match[1500:6000] = long_match[100:4600]
    lits[6000:6050] = lits[300:350]
    periodic = [np.tile(rand(p), 8192 // p + 1)[:8192] for p in (4, 53)]
    return [long_match, lits] + periodic + [rand(8192, a) for a in (2, 3, 4)] \
        + [rand(10), rand(40), _json_payload(300)]


def _phase9(torch, pt, dev, corpus, ref_frame, d, seed, tag):
    """engine="hybrid": the walk kernel against its plain version and the
    host serializer, then the 64 MiB frame. Returns (JSON fields, the
    hybrid frame)."""
    from divortio_lz4_tpu_torch import FrameConfig
    from divortio_lz4_tpu_torch.ops.hybrid_encode import (
        WALK_WARPS, build_chains, build_dist_chains,
        hybrid_walk, hybrid_walk_plain)
    from divortio_lz4_tpu_torch.ops.split_encode import (
        chain_select_serialize_meta)
    from divortio_lz4_tpu_torch.parallel.device import (_blocks_to_batch,
                                                        _history_rows)

    rng = np.random.default_rng(seed + 9)
    B = 65536
    nblk = len(corpus) // B
    rows = [corpus[(k * nblk // 32) * B: (k * nblk // 32 + 1) * B]
            for k in range(32)]
    rows += [rng.integers(0, 256, B, dtype=np.uint8) for _ in range(8)]
    rows += [np.zeros(B, np.uint8), corpus[:10], corpus[:0]]
    dict_hist = np.zeros((8, B), np.uint8)
    dict_hist[:, B - len(d):] = d
    lwork, llens, _, _, lstart = _history_rows(corpus[:8 * B], B, None, True)
    batches = {
        f"{len(rows)} rows (32 corpus, 8 random, zero, short, empty)":
            _rows_batch(torch, rows, dev) + (0,),
        "8 rows with a 32 KB dictionary":
            _rows_batch(torch, [corpus[(5 + 7 * k) * B: (6 + 7 * k) * B]
                                for k in range(8)], dev, B, dict_hist)
            + (B - len(d),),
        "8 linked rows": (torch.from_numpy(lwork).to(dev),
                          torch.from_numpy(llens.astype(np.int64)).to(dev),
                          B, torch.from_numpy(lstart).to(dev)),
        "8 KB hostile rows (segment boundaries in a long match and in "
        "literal runs, periodic rows, small alphabets, shorter than a "
        "segment)": _rows_batch(torch, _walk_hostile(rng), dev, 8192) + (0,),
    }
    err, plain_ms = 0, None
    for name, (w, ln, hl, hs) in batches.items():
        chains = build_chains(w, ln, hl, hs)
        got = hybrid_walk(w, ln, chains, hl)
        redo = hybrid_walk.last_rewalked
        want, p_ms = _timed(torch, lambda: hybrid_walk_plain(w, ln, chains,
                                                             hl))
        plain_ms = p_ms if plain_ms is None else plain_ms
        err = max(err, _compare(torch, f"hybrid_encode {name}", got, want,
                                tag, 9))
        print(f"phase 9: hybrid_encode {name}: {WALK_WARPS} warps a row, "
              f"{int(redo.sum())} sequences re-walked in the stitch (max "
              f"{int(redo.max())} a row) {tag}")
        # the host serializer over the same exact-word chains (u16 form)
        d16 = build_dist_chains(w, ln, hl, hs, hashed=False).cpu().numpy()
        work_np, lens_np = w.cpu().numpy(), ln.cpu().numpy()
        out_np, ol_np, meta_np = (x.cpu().numpy() for x in got)
        for i, n in enumerate(lens_np):
            if not n:
                continue
            wk = np.zeros(hl + n + 8, np.uint8)
            wk[: hl + n] = work_np[i, : hl + n]
            stream, meta = chain_select_serialize_meta(wk, hl, int(n),
                                                       d16[i])
            if (out_np[i, : ol_np[i]].tobytes() != stream.tobytes()
                    or not np.array_equal(meta_np[i], meta)):
                raise AssertionError(f"hybrid_encode {name}: row {i} != the "
                                     "host serializer's stream and meta")
        print(f"phase 9: hybrid_encode {name}: streams and meta lanes == "
              f"chain_serialize16_meta_native on the same chains, plain "
              f"{p_ms:.1f} ms {tag}")

    # -- the engine="hybrid" main path -------------------------------------
    n = len(corpus)
    cfg = FrameConfig(block_size=B, block_independence=True,
                      content_checksum=True)
    exact = _split_exact_frame(pt, corpus, cfg, dev)
    pt.compress_frame(corpus, cfg, engine="hybrid", device=dev)   # warm-up
    hybrid_walk.launches = 0
    t_enc = []
    for _ in range(3):
        t0 = time.perf_counter()
        frame = pt.compress_frame(corpus, cfg, engine="hybrid", device=dev)
        t_enc.append(time.perf_counter() - t0)
    launches = hybrid_walk.launches
    if launches < 1:
        raise AssertionError("the engine='hybrid' main path never launched "
                             "hybrid_encode")
    if frame.tobytes() != exact.tobytes():
        raise AssertionError("the hybrid 64 MiB frame differs from the split "
                             "engine's frame with exact chains")
    for engine in ("split", "pallas"):
        _other_engine_exact(pt, frame, corpus, dev, engine,
                            what="engine='hybrid' 64 MiB frame")
    enc_s = statistics.median(t_enc)
    print(f"phase 9: engine='hybrid' 64 MiB frame (64 KB independent, "
          f"content checksum), {len(frame)} B == the split-exact frame; "
          f"both engines decode it exactly; ratio vs the engine='pallas' "
          f"frame {len(frame) / len(ref_frame):.4f} ({len(ref_frame)} B); "
          f"hybrid_encode launches {launches} {tag}")
    print(f"phase 9: engine='hybrid': encode {n / enc_s / 1e6:.1f} MB/s "
          f"(median of 3; {t_enc} s) {tag}")
    mw, ml, _ = _blocks_to_batch(corpus, B)
    mw = torch.from_numpy(mw).to(dev)
    ml = torch.from_numpy(ml.astype(np.int64)).to(dev)
    chains = torch.cat([build_chains(mw[i: i + 128], ml[i: i + 128], 0, 0)
                        for i in range(0, mw.shape[0], 128)])
    mout = hybrid_walk(mw, ml, chains, 0)
    redo = hybrid_walk.last_rewalked
    ms = _cuda_ms(torch, lambda: hybrid_walk(mw, ml, chains, 0), 5)
    # In: the payload once, the chain entries the walk reads (chain[0] of
    # every row, then one per match sequence, counted from the streams) and
    # lengths. Out: streams, lengths and meta lanes.
    total = int(ml.sum())
    out_np, ol_np = mout[0].cpu().numpy(), mout[1].cpu().numpy()
    seqs = sum(_match_sequences(out_np[i, : ol_np[i]].tobytes())
               for i in range(len(ol_np)))
    res = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, launches=launches,
               bound_ms=_bound_ms(total, 4 * (mw.shape[0] + seqs), ml,
                                  int(ol_np.sum()), mout[1], mout[2]))
    print(f"phase 9: hybrid_encode {mw.shape[0]} x 64 KB: {WALK_WARPS} "
          f"warps a row, {int(redo.sum())} of {seqs} sequences re-walked in "
          f"the stitch (max {int(redo.max())} a row) {tag}")
    print(f"phase 9: hybrid_encode {mw.shape[0]} x 64 KB (the 64 MiB "
          f"frame's rows, {seqs} match sequences): kernel {ms:.3f} ms "
          f"({n / ms / 1e3:.1f} MB/s), plain {plain_ms:.1f} ms on the "
          f"{len(rows)}-row batch, bound {res['bound_ms']:.4f} ms {tag}")
    return res, frame


def _phase10(torch, pt, dev, corpus, frame, dict_frame, d, seed, tag):
    """split_decode against its plain version on the hybrid frame's blocks,
    a dictionary batch and one row of random records; decode_wire_blocks
    of the frame. Returns the kernel's JSON fields."""
    from divortio_lz4_tpu_torch.ops.split_decode import (
        decode_blocks_split, decode_blocks_split_plain, decode_wire_blocks,
        parse_block_batch)
    from divortio_lz4_tpu_torch.parallel.device import parse_block_index

    rng = np.random.default_rng(seed + 10)
    B = 65536

    def blocks_of(f):
        _, blocks, _ = parse_block_index(f)
        return blocks, [f[o: o + s] for o, s, st in blocks if not st]

    blocks, comps = blocks_of(frame)
    main = parse_block_batch(comps, B)
    _, dcomps = blocks_of(dict_frame)
    dic = parse_block_batch(dcomps, B, [d] * len(dcomps))

    def put(batch):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in batch[:3]] + [B, batch[4]]

    margs, dargs = put(main), put(dic)
    err = 0
    outs = {}
    for name, args in ((f"{len(comps)} x 64 KB (the 64 MiB hybrid frame's "
                        "compressed blocks)", margs),
                       (f"{len(dcomps)} blocks with a dictionary", dargs)):
        got = decode_blocks_split(*args)
        stats = _group_stats(decode_blocks_split, f"split_decode {name}", 0)
        want, p_ms = _timed(torch, lambda: decode_blocks_split_plain(*args))
        err = max(err, _compare(torch, f"split_decode {name}", got, want,
                                tag, 10))
        print(f"phase 10: split_decode {name}: {stats} {tag}")
        outs[name] = (got, p_ms)
    plain_ms = next(iter(outs.values()))[1]
    mout = next(iter(outs.values()))[0]
    h = min(7, len(comps) - 1)
    nrec = int(main[2][h])
    hostile = margs[1].clone()
    hostile[h, :nrec] = torch.from_numpy(rng.integers(
        -2**31, 2**31, (nrec, 2), dtype=np.int64).astype(np.int32)).to(dev)
    hargs = [margs[0], hostile] + margs[2:]
    hgot = decode_blocks_split(*hargs)
    stats = _group_stats(decode_blocks_split, "split_decode hostile row", 1)
    err = max(err, _compare(torch, f"split_decode, row {h} random records",
                            hgot, decode_blocks_split_plain(*hargs), tag,
                            10))
    others = [i for i in range(len(comps)) if i != h]
    if not torch.equal(hgot[others], mout[others]):
        raise AssertionError(f"random records in row {h} changed another row")
    print(f"phase 10: split_decode hostile row: no fault, the other "
          f"{len(others)} rows exact; {stats} {tag}")

    # -- the main path: decode_wire_blocks of the frame's blocks -----------
    decode_blocks_split.launches = 0
    t0 = time.perf_counter()
    decoded = iter(decode_wire_blocks(comps, B, device=dev))
    dt = time.perf_counter() - t0
    launches = decode_blocks_split.launches
    joined = np.concatenate([frame[o: o + s] if st else next(decoded)
                             for o, s, st in blocks])
    if joined.tobytes() != corpus.tobytes():
        raise AssertionError("decode_wire_blocks of the hybrid frame's blocks "
                             "does not give the corpus")
    if launches < 1:
        raise AssertionError("decode_wire_blocks never launched split_decode")
    print(f"phase 10: decode_wire_blocks of the 64 MiB hybrid frame's "
          f"{len(comps)} compressed blocks (parse and fetch included): the "
          f"corpus exactly, {len(corpus) / dt / 1e6:.1f} MB/s; split_decode "
          f"launches {launches} {tag}")
    ms = _cuda_ms(torch, lambda: decode_blocks_split(*margs), 5)
    stats = _group_stats(decode_blocks_split, "split_decode main batch", 0)
    # literal images without padding (the decoded length of each block),
    # 8 B per record, decoded bytes out; no history in the main batch
    decoded_bytes = int(main[3].sum())
    res = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, launches=launches,
               bound_ms=_bound_ms(decoded_bytes, 8 * int(main[2].sum()),
                                  decoded_bytes))
    print(f"phase 10: split_decode {len(comps)} x 64 KB: kernel {ms:.3f} ms "
          f"({decoded_bytes / ms / 1e3:.1f} MB/s of output), plain "
          f"{plain_ms:.1f} ms, bound {res['bound_ms']:.4f} ms; {stats} "
          f"{tag}")
    return res


def _phase11(torch, pt, dev, corpus, ref_frame, card, tag):
    """engine="xla" on the card (the module docstring's phase 11)."""
    from divortio_lz4_tpu_torch import FrameConfig
    from divortio_lz4_tpu_torch.ops import decode_xla, encode_xla
    from divortio_lz4_tpu_torch.ops import split_encode
    from divortio_lz4_tpu_torch.ops.hybrid_encode import CHAIN_CHUNK_ROWS
    from divortio_lz4_tpu_torch.parallel import device as pdev

    # No fallback: every row pass of the engine must run on the card.
    on_card = {}
    passes = ((encode_xla, "_encode_rows", encode_xla._encode_rows),
              (decode_xla, "_decode_rows", decode_xla._decode_rows))
    for mod, name, fn in passes:
        def checked(*a, _fn=fn, _name=name):
            if a[0].device.type != dev.type:
                raise AssertionError(f"{_name} ran on {a[0].device}")
            on_card[_name] = on_card.get(_name, 0) + 1
            return _fn(*a)
        setattr(mod, name, checked)
    calls = {"encode_blocks_batch": 0, "decode_blocks_batch": 0,
             "build_dist_chains": 0}
    for mod, name in ((pdev, "encode_blocks_batch"),
                      (pdev, "decode_blocks_batch"),
                      (split_encode, "build_dist_chains")):
        def counted(*a, _fn=getattr(mod, name), _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        setattr(mod, name, counted)
    torch.cuda.reset_peak_memory_stats()
    res = {"card": card}
    n = len(corpus)
    corpus_b = corpus.tobytes()
    cfg = FrameConfig(block_size=65536, block_independence=True,
                      content_checksum=True)

    frame = pt.compress_frame(corpus, cfg, engine="xla", device=dev)
    pt.decompress_frame(frame, engine="xla", device=dev)       # warm-up
    for k in calls:
        calls[k] = 0
    t_enc, t_dec = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        frame = pt.compress_frame(corpus, cfg, engine="xla", device=dev)
        t1 = time.perf_counter()
        out = pt.decompress_frame(frame, engine="xla", device=dev)
        t2 = time.perf_counter()
        t_enc.append(t1 - t0)
        t_dec.append(t2 - t1)
        if out.tobytes() != corpus_b:
            raise AssertionError("64 MiB xla round trip is not exact")
    main_calls = dict(calls)
    if main_calls["encode_blocks_batch"] != 3 \
            or main_calls["decode_blocks_batch"] != 3:
        raise AssertionError(f"the xla main path's calls: {main_calls}")
    enc_rounds = dict(encode_xla.encode_blocks_batch.last_rounds)
    dec_rounds = dict(decode_xla.decode_blocks_batch.last_rounds)
    for engine in ("split", "pallas"):
        _other_engine_exact(pt, frame, corpus, dev, engine,
                            what="64 MiB xla frame")
    calls["build_dist_chains"] = 0
    split_frame = pt.compress_frame(corpus, cfg, device=dev)
    main_calls["build_dist_chains"] = calls["build_dist_chains"]
    for made_by, f in (("split", split_frame), ("pallas", ref_frame)):
        for engine in ("xla", "hybrid"):
            _other_engine_exact(pt, f, corpus, dev, engine,
                                what=f"64 MiB {made_by} frame")
    enc_s, dec_s = statistics.median(t_enc), statistics.median(t_dec)
    res["frame_64k"] = {
        "bytes": len(frame), "pallas_bytes": len(ref_frame),
        "ratio_vs_pallas": len(frame) / len(ref_frame),
        "encode_mb_s": n / enc_s / 1e6, "decode_mb_s": n / dec_s / 1e6,
        "encode_s": t_enc, "decode_s": t_dec,
        "encode_rounds": enc_rounds, "decode_rounds": dec_rounds}
    print(f"phase 11: engine='xla' 64 MiB frame (64 KB independent, "
          f"content checksum), {len(frame)} B, ratio vs the engine='pallas' "
          f"frame {len(frame) / len(ref_frame):.4f}: round trip exact, "
          f"'split' and 'pallas' decode it exactly, 'xla' and 'hybrid' "
          f"decode the split and pallas frames exactly {tag}")
    print(f"phase 11: engine='xla': encode {n / enc_s / 1e6:.1f} MB/s, "
          f"decode {n / dec_s / 1e6:.1f} MB/s (median of 3; enc {t_enc}, "
          f"dec {t_dec} s); encode rounds {enc_rounds}, decode rounds "
          f"{dec_rounds} {tag}")

    # the frame's rows, as the main path builds them
    work, lens, nb, _, _ = pdev._history_rows(corpus, 65536, None, False)
    d_work = torch.from_numpy(work).to(dev)
    d_lens = torch.from_numpy(lens.astype(np.int64)).to(dev)
    _, blocks, _ = pdev.parse_block_index(frame)
    comp, clens = pdev.stage_xla_blocks(frame, blocks, 65536, dev)
    hist = torch.zeros(65536, dtype=torch.uint8, device=dev)
    enc_ms = _cuda_ms(torch, lambda: encode_xla.encode_blocks_batch(
        d_work, d_lens, 0, True, 0), 3)
    rows, rlens = encode_xla.encode_blocks_batch(d_work, d_lens, 0, True, 0)
    dec_ms = _cuda_ms(torch, lambda: decode_xla.decode_blocks_batch(
        comp, clens, hist, 65536), 3)
    dec, dlens = decode_xla.decode_blocks_batch(comp, clens, hist, 65536)
    chain_ms = _cuda_ms(torch, lambda: [
        split_encode.build_dist_chains(d_work[i: i + CHAIN_CHUNK_ROWS],
                                       d_lens[i: i + CHAIN_CHUNK_ROWS], 0, 0)
        for i in range(0, nb, CHAIN_CHUNK_ROWS)], 3)
    comp_bytes = int(clens.sum())
    stored_bytes = sum(size for _, size, st in blocks if st)
    res["rows"] = {
        "encode_blocks_batch": {
            "ms": enc_ms,
            "calls_on_path": main_calls["encode_blocks_batch"] // 3,
            "row_passes": -(-nb // max(
                1, decode_xla.XLA_CHUNK_POSITIONS // 65536)),
            # payload in, each row's stream out
            "bound_ms": _bound_ms(n, int(rlens.sum()))},
        "decode_blocks_batch": {
            "ms": dec_ms,
            "calls_on_path": main_calls["decode_blocks_batch"] // 3,
            # compressed bytes in, decoded bytes out (stored blocks skip)
            "bound_ms": _bound_ms(comp_bytes, n - stored_bytes)},
        "build_dist_chains": {
            "ms": chain_ms,
            "calls_on_path": main_calls["build_dist_chains"],
            # payload in, a u16 distance per position out
            "bound_ms": _bound_ms(n, 2 * n)}}
    if int(dlens.sum()) != n - stored_bytes:
        raise AssertionError("decode_blocks_batch lost bytes")
    print(f"phase 11: on the frame's {nb} rows (CUDA events, mean of 3): "
          f"encode_blocks_batch {enc_ms:.3f} ms (bound "
          f"{res['rows']['encode_blocks_batch']['bound_ms']:.4f}), "
          f"decode_blocks_batch {dec_ms:.3f} ms (bound "
          f"{res['rows']['decode_blocks_batch']['bound_ms']:.4f}), the split "
          f"engine's chain builder {chain_ms:.3f} ms (bound "
          f"{res['rows']['build_dist_chains']['bound_ms']:.4f}) {tag}")
    del d_work, comp, rows, dec

    # the default frame: 4 MB linked blocks
    dcfg = FrameConfig()
    t0 = time.perf_counter()
    dframe = pt.compress_frame(corpus, dcfg, engine="xla", device=dev)
    t1 = time.perf_counter()
    out = pt.decompress_frame(dframe, engine="xla", device=dev)
    t2 = time.perf_counter()
    if out.tobytes() != corpus_b:
        raise AssertionError("64 MiB default xla round trip is not exact")
    _other_engine_exact(pt, dframe, corpus, dev, "split",
                        what="64 MiB default xla frame")
    from divortio_lz4_tpu_torch.ops.linked_xla import decode_linked_scan
    res["default"] = {
        "bytes": len(dframe), "encode_mb_s": n / (t1 - t0) / 1e6,
        "decode_mb_s": n / (t2 - t1) / 1e6,
        "encode_rounds": dict(encode_xla.encode_blocks_batch.last_rounds),
        "decode_syncs": decode_linked_scan.last_syncs}
    print(f"phase 11: engine='xla' default frame (4 MB linked) 64 MiB, "
          f"{len(dframe)} B: exact, 'split' decodes it exactly; encode "
          f"{n / (t1 - t0) / 1e6:.1f} MB/s, decode {n / (t2 - t1) / 1e6:.1f}"
          f" MB/s (once each); encode rounds {res['default']['encode_rounds']}"
          f", linked decode host syncs {decode_linked_scan.last_syncs} {tag}")

    # the routes JAX sends to the XLA engine
    part = corpus[: 8 * MIB]
    d = np.array(corpus[3 * MIB: 3 * MIB + 32768])
    linked = FrameConfig(block_size=65536)
    routes = {
        "pallas_dictionary": ("pallas", cfg, d, {}),
        "pallas_linked": ("pallas", linked, None, {}),
        "hybrid_linked_block_checksums": (
            "hybrid", linked.with_(block_checksums=True), None, {}),
        "xla_assemble_device": ("xla", cfg, None, {"assemble": "device"}),
        "xla_linked_assemble_device": ("xla", linked, d,
                                       {"assemble": "device"}),
    }
    res["routes"] = {}
    for name, (engine, rcfg, rd, kw) in routes.items():
        t0 = time.perf_counter()
        f = pt.compress_frame(part, rcfg, dictionary=rd, engine=engine,
                              device=dev, **kw)
        t1 = time.perf_counter()
        back = pt.decompress_frame(f, dictionary=rd, engine=engine,
                                   device=dev)
        t2 = time.perf_counter()
        if back.tobytes() != part.tobytes():
            raise AssertionError(f"route {name}: round trip differs")
        if kw:
            host = pt.compress_frame(part, rcfg, dictionary=rd,
                                     engine=engine, device=dev)
            if host.tobytes() != f.tobytes():
                raise AssertionError(f"route {name}: device assembly != "
                                     "host assembly")
        res["routes"][name] = {"bytes": len(f), "encode_s": t1 - t0,
                               "decode_s": t2 - t1}
        print(f"phase 11: route {name} (8 MiB): {len(f)} B, round trip "
              f"exact on engine={engine!r}{' (== host assembly)' if kw else ''}"
              f"; encode {t1 - t0:.3f} s, decode {t2 - t1:.3f} s {tag}")

    res["peak_mib"] = torch.cuda.max_memory_allocated() / MIB
    res["row_passes_on_card"] = on_card
    for mod, name, fn in passes:
        setattr(mod, name, fn)

    # the card against the port's own CPU run
    part = corpus[: 4 * MIB]
    for name, ccfg in (("64k_independent", cfg), ("linked_64k", linked)):
        on_gpu = pt.compress_frame(part, ccfg, engine="xla", device=dev)
        on_cpu = pt.compress_frame(part, ccfg, engine="xla", device="cpu")
        if on_gpu.tobytes() != on_cpu.tobytes():
            raise AssertionError(f"xla {name}: card frame != CPU frame")
        print(f"phase 11: xla {name} 4 MiB: the card's frame == the port's "
              f"CPU frame ({len(on_gpu)} B) {tag}")
    print(f"phase 11: peak device memory {res['peak_mib']:.0f} MiB {tag}")
    print(json.dumps({"xla_engine": res}))


def _stream_pass(pt, data, cfg, dev, chunk):
    """One stream round trip of *data* fed in *chunk*-byte pieces: a
    CompressStream's write/flush, then a DecompressStream of its own fed
    the frame in *chunk*-byte pieces. Returns (frame, plaintext, encode
    seconds, decode seconds, encoder stats, decoder stats)."""
    t0 = time.perf_counter()
    cs = pt.CompressStream(cfg, device=dev)
    parts = [cs.write(data[i: i + chunk]) for i in range(0, len(data),
                                                          chunk)]
    parts.append(cs.flush())
    frame = b"".join(parts)
    t1 = time.perf_counter()
    ds = pt.DecompressStream(device=dev)
    out = b"".join(ds.write(frame[i: i + chunk])
                   for i in range(0, len(frame), chunk))
    t2 = time.perf_counter()
    return (frame, out, t1 - t0, t2 - t1, dict(cs._enc.stats),
            dict(ds._dec.stats))


def _phase12(torch, pt, dev, corpus, seed, tag) -> dict:
    """Streaming on the card (the module docstring's phase 12). Returns
    the launches of compact_decode and wire_decode in its runs."""
    from divortio_lz4_tpu_torch import FrameConfig
    from divortio_lz4_tpu_torch.ops.compact_decode import decode_blocks_compact
    from divortio_lz4_tpu_torch.ops.wire_decode import decode_blocks_wire

    n = len(corpus)
    corpus_b = corpus.tobytes()
    chunk = 4 * MIB        # compress_file's default chunk_size
    torch.cuda.reset_peak_memory_stats()
    launches = {"compact_decode": 0, "wire_decode": 0}
    for name, cfg in (
            ("independent", FrameConfig(block_size=65536,
                                        block_independence=True,
                                        content_checksum=True)),
            ("linked", FrameConfig(block_size=65536,
                                   block_independence=False,
                                   content_checksum=True))):
        _stream_pass(pt, corpus[: 8 * MIB], cfg, dev, chunk)    # warm-up
        decode_blocks_compact.launches = 0
        t_enc, t_dec = [], []
        for _ in range(3):
            frame, out, te, td, es, ds = _stream_pass(pt, corpus, cfg, dev,
                                                      chunk)
            t_enc.append(te)
            t_dec.append(td)
            if out != corpus_b:
                raise AssertionError(f"{name} stream round trip differs")
        compact = decode_blocks_compact.launches
        launches["compact_decode"] += compact
        if es["device_blocks"] < 1:
            raise AssertionError(f"{name} stream: no device encode burst")
        if name == "independent" and (ds["device_blocks"] < 1
                                      or compact < 3):
            raise AssertionError(f"independent stream decode: device "
                                 f"blocks {ds['device_blocks']}, "
                                 f"compact_decode launches {compact}")
        got = pt.decompress_frame(frame, device=dev)
        if got.tobytes() != corpus_b:
            raise AssertionError(f"{name} stream frame: decompress_frame "
                                 "differs")
        enc_s, dec_s = statistics.median(t_enc), statistics.median(t_dec)
        print(f"phase 12: {name} stream (64 KB blocks, content checksum), "
              f"64 MiB fed in 4 MiB chunks, {len(frame)} B: "
              f"decompress_frame and a DecompressStream give the corpus; "
              f"encoder: device blocks {es['device_blocks']} in "
              f"{es['device_bursts']} bursts "
              f"({es['device_blocks'] / max(es['device_bursts'], 1):.1f} a "
              f"burst), host blocks {es['host_blocks']}; decoder: device "
              f"blocks {ds['device_blocks']} in {ds['device_bursts']} "
              f"bursts, host blocks {ds['host_blocks']}; compact_decode "
              f"launches {compact} {tag}")
        print(f"phase 12: {name} stream: encode {n / enc_s / 1e6:.1f} MB/s, "
              f"decode {n / dec_s / 1e6:.1f} MB/s (median of 3; enc "
              f"{t_enc}, dec {t_dec} s) {tag}")
        prefix = corpus[: 4 * MIB]
        card_f = _stream_pass(pt, prefix, cfg, dev, chunk)[0]
        cpu_f = _stream_pass(pt, prefix, cfg, "cpu", chunk)[0]
        if card_f != cpu_f:
            raise AssertionError(f"{name} stream: card bytes != CPU bytes "
                                 "on the 4 MiB prefix")
        print(f"phase 12: {name} stream: the card's frame == the port's "
              f"CPU frame on the 4 MiB prefix ({len(card_f)} B) {tag}")

    peak = torch.cuda.max_memory_allocated() / MIB
    print(f"phase 12: peak device memory of the 64 KB streams {peak:.0f} "
          f"MiB {tag}")

    # 256 KB independent blocks: the decoder's bursts take the wire kernel
    cfg = FrameConfig(block_size=262144, block_independence=True,
                      content_checksum=True)
    wide = pt.compress_frame(corpus, cfg, device=dev).tobytes()
    torch.cuda.reset_peak_memory_stats()
    decode_blocks_wire.launches = 0
    ds = pt.DecompressStream(device=dev)
    out = b"".join(ds.write(wide[i: i + chunk])
                   for i in range(0, len(wide), chunk))
    launches["wire_decode"] = decode_blocks_wire.launches
    st = ds._dec.stats
    if out != corpus_b or launches["wire_decode"] < 1:
        raise AssertionError(f"256 KB stream decode: exact "
                             f"{out == corpus_b}, wire_decode launches "
                             f"{launches['wire_decode']}")
    print(f"phase 12: 256 KB independent frame through a DecompressStream "
          f"(4 MiB chunks): exact; device blocks {st['device_blocks']} in "
          f"{st['device_bursts']} bursts, host blocks {st['host_blocks']}; "
          f"wire_decode launches {launches['wire_decode']} {tag}")

    # mutated frames: an "LZ4: ..." error or at most the bound, no fault
    rng = np.random.default_rng(seed)
    cfg = FrameConfig(block_size=65536, block_independence=True,
                      content_checksum=True)
    base = bytearray(_stream_pass(pt, corpus[: 4 * MIB], cfg, dev,
                                  chunk)[0])
    outcomes = []
    for _ in range(8):
        buf = bytearray(base)
        for at in rng.integers(0, len(buf), 2):
            buf[int(at)] = int(rng.integers(0, 256))
        try:
            got = pt.LZ4Decoder(device=dev).update(bytes(buf))
            size = sum(len(c) for c in got)
            if size > 4 * MIB + 65536:
                raise AssertionError(f"mutated frame decoded {size} B")
            outcomes.append(f"{size} B")
        except ValueError as e:
            if not str(e).startswith("LZ4: "):
                raise
            outcomes.append(str(e))
    torch.cuda.synchronize()
    print(f"phase 12: 8 mutated 4 MiB stream frames: no fault; "
          f"{outcomes} {tag}")
    peak = torch.cuda.max_memory_allocated() / MIB
    print(f"phase 12: peak device memory of the 256 KB stream decode and "
          f"the mutated frames {peak:.0f} MiB {tag}")
    return launches


def _phase13(torch, pt, dev, corpus, tag) -> dict:
    """ShardedCodec on the card (the module docstring's phase 13). Returns
    the launches of hybrid_encode, compact_decode and wire_decode in its
    runs."""
    from divortio_lz4_tpu_torch import FrameConfig
    from divortio_lz4_tpu_torch.ops.compact_decode import decode_blocks_compact
    from divortio_lz4_tpu_torch.ops.hybrid_encode import hybrid_walk
    from divortio_lz4_tpu_torch.ops.wire_decode import decode_blocks_wire
    from divortio_lz4_tpu_torch.parallel import ShardedCodec, make_mesh

    n = len(corpus)
    corpus_b = corpus.tobytes()
    mesh = make_mesh(1)
    if mesh != [torch.device("cuda", 0)]:
        raise AssertionError(f"make_mesh(1) gave {mesh}")
    cfg = FrameConfig(block_size=65536, block_independence=True)
    torch.cuda.reset_peak_memory_stats()
    fns = {"hybrid_encode": hybrid_walk,
           "compact_decode": decode_blocks_compact,
           "wire_decode": decode_blocks_wire}
    launches = dict.fromkeys(fns, 0)
    single = {e: pt.compress_frame(corpus, cfg,
                                   engine="hybrid" if e == "best" else "xla",
                                   device=dev).tobytes()
              for e in ("best", "xla")}
    wide = pt.compress_frame(corpus[: 16 * MIB], FrameConfig(
        block_size=262144, block_independence=True), device=dev)
    for engine in ("best", "xla"):
        for shards, devices in (("1 shard", mesh), ("2 shards", [dev, dev])):
            codec = ShardedCodec(devices, engine=engine)
            codec.decompress(codec.compress(corpus[: 8 * MIB]))  # warm-up
            for fn in fns.values():
                fn.launches = 0
            t_enc, t_dec = [], []
            for _ in range(3):
                t0 = time.perf_counter()
                frame = codec.compress(corpus)
                t1 = time.perf_counter()
                out = codec.decompress(frame)
                t2 = time.perf_counter()
                t_enc.append(t1 - t0)
                t_dec.append(t2 - t1)
                if out.tobytes() != corpus_b:
                    raise AssertionError(f"{engine} {shards}: round trip "
                                         "differs")
            if frame.tobytes() != single[engine]:
                raise AssertionError(f"{engine} {shards}: frame != the "
                                     "single-device compress_frame frame")
            other = ShardedCodec(devices, engine="xla" if engine == "best"
                                 else "best")
            if other.decompress(frame).tobytes() != corpus_b:
                raise AssertionError(f"{engine} {shards}: the other "
                                     "engine's decode differs")
            if codec.decompress(wide).tobytes() != corpus_b[: 16 * MIB]:
                raise AssertionError(f"{engine} {shards}: the 256 KB frame "
                                     "decodes wrong through the 64 KB codec")
            runs = {k: fn.launches for k, fn in fns.items()}
            for k in fns:
                launches[k] += runs[k]
            if engine == "best" and min(runs.values()) < 1:
                raise AssertionError(f"best {shards}: launches {runs}")
            enc_s, dec_s = statistics.median(t_enc), statistics.median(t_dec)
            print(f"phase 13: ShardedCodec(engine={engine!r}) over "
                  f"{shards} ({[str(d) for d in devices]}), 64 MiB at 64 KB "
                  f"independent blocks, {len(frame)} B: == the "
                  f"single-device compress_frame(engine="
                  f"{'hybrid' if engine == 'best' else 'xla'!r}) frame, "
                  f"decoded exactly by both engines; a 256 KB-block frame "
                  f"(16 MiB) decodes exactly through it; launches {runs} "
                  f"{tag}")
            print(f"phase 13: {engine} {shards}: encode "
                  f"{n / enc_s / 1e6:.1f} MB/s, decode {n / dec_s / 1e6:.1f} "
                  f"MB/s (median of 3; enc {t_enc}, dec {t_dec} s) {tag}")
    peak = torch.cuda.max_memory_allocated() / MIB
    print(f"phase 13: peak device memory {peak:.0f} MiB {tag}")
    return launches


def _kernel_fns() -> dict:
    """Every kernel's wrapper by the name the kernels JSON gives it; each
    counts its launches in ``.launches``."""
    from divortio_lz4_tpu_torch.ops.compact_decode import decode_blocks_compact
    from divortio_lz4_tpu_torch.ops.greedy_encode import encode_blocks_pallas
    from divortio_lz4_tpu_torch.ops.hybrid_encode import hybrid_walk
    from divortio_lz4_tpu_torch.ops.split_decode import decode_blocks_split
    from divortio_lz4_tpu_torch.ops.token_decode import (decode_blocks_pallas,
                                                         decode_token_chains)
    from divortio_lz4_tpu_torch.ops.wave_decode import decode_chains
    from divortio_lz4_tpu_torch.ops.wire_decode import decode_blocks_wire
    return {"compact_decode": decode_blocks_compact,
            "chain_decode": decode_chains,
            "wire_decode": decode_blocks_wire,
            "greedy_encode": encode_blocks_pallas,
            "token_decode": decode_blocks_pallas,
            "token_decode_linked": decode_token_chains,
            "hybrid_encode": hybrid_walk,
            "split_decode": decode_blocks_split}


def _stream_frame(pt, data, cfg, dev, chunk: int) -> bytes:
    """A CompressStream frame of *data* fed *chunk*-byte pieces."""
    cs = pt.CompressStream(cfg, device=dev)
    return b"".join([cs.write(data[i: i + chunk])
                     for i in range(0, len(data), chunk)] + [cs.flush()])


def _cli(argv) -> str:
    """The port CLI's main(argv) in this process; returns its summary
    line (stderr)."""
    from divortio_lz4_tpu_torch.__main__ import main
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = main(argv)
    if rc != 0:
        raise AssertionError(f"CLI {argv} exited {rc}")
    return err.getvalue().strip()


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _phase14(torch, pt, dev, corpus, tag) -> dict:
    """The CLI on the card (the module docstring's phase 14). Returns every
    kernel's launches in its in-process runs."""
    from divortio_lz4_tpu_torch import FrameConfig

    x = corpus[: 16 * MIB]
    xb = x.tobytes()
    tdev = ["--torch-device", str(dev)]
    # (--engine, -b, the --engine of each decompress --device)
    device_runs = (("split", 65536, ("split",)),
                   ("pallas", 65536, ("pallas",)),
                   ("hybrid", 65536, ("split",)),
                   ("split", 262144, ("split",)),
                   ("split", 4194304, ("split",)))
    stream_runs = (("64 KB independent", ["-b", "65536", "--independent",
                                          "--checksum"],
                    FrameConfig(block_size=65536, block_independence=True,
                                content_checksum=True)),
                   ("default 4 MB linked", ["--checksum"],
                    FrameConfig(content_checksum=True)))
    # the frames each CLI file must equal, made before the counts start
    want = {(engine, bs): pt.compress_frame(x, FrameConfig(
        block_size=bs, block_independence=True, content_checksum=True),
        engine=engine, device=dev).tobytes()
        for engine, bs, _ in device_runs}
    want.update({name: _stream_frame(pt, x, cfg, dev, 1 << 22)  # CLI reads
                 for name, _, cfg in stream_runs})
    fns = _kernel_fns()
    for fn in fns.values():
        fn.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "corpus.bin")
        with open(src, "wb") as f:
            f.write(xb)

        def decode_exact(path, flags, what):
            back = os.path.join(tmp, "back.bin")
            line = _cli(["decompress", path, "-o", back, *flags, *tdev])
            if _read(back) != xb:
                raise AssertionError(f"CLI decompress {flags} of {what} "
                                     "differs from the corpus")
            return line

        for engine, bs, decoders in device_runs:
            name = f"{engine} -b {bs}"
            path = os.path.join(tmp, f"{engine}{bs}.lz4")
            enc = _cli(["compress", src, "-o", path, "--device", "--engine",
                        engine, "-b", str(bs), "--checksum", *tdev])
            if _read(path) != want[engine, bs]:
                raise AssertionError(f"CLI --device {name} file != "
                                     "compress_frame's frame")
            decs = [decode_exact(path, ["--device", "--engine", e], name)
                    for e in decoders]
            print(f"phase 14: compress --device --engine {engine} -b {bs} "
                  f"--checksum == compress_frame, decompress --device "
                  f"{'/'.join(decoders)} exact: [{enc}] [{'] ['.join(decs)}] "
                  f"{tag}")

        for name, flags, cfg in stream_runs:
            path = os.path.join(tmp, "stream.lz4")
            enc = _cli(["compress", src, "-o", path, *flags, *tdev])
            if _read(path) != want[name]:
                raise AssertionError(f"CLI stream {name} file != the "
                                     "CompressStream frame")
            routes = ["stream"]
            decs = [decode_exact(path, [], name)]
            if not cfg.block_independence:
                routes += ["--device split", "--device pallas"]
                decs += [decode_exact(path, ["--device", "--engine", e],
                                      name) for e in ("split", "pallas")]
            print(f"phase 14: stream path {name} == a CompressStream frame, "
                  f"decoded exactly ({', '.join(routes)}): [{enc}] "
                  f"[{'] ['.join(decs)}] {tag}")

        # the module entry: one pipe of two processes, stdin to stdout
        small = os.path.join(tmp, "small.bin")
        with open(small, "wb") as f:
            f.write(xb[: 4 * MIB])
        env = dict(os.environ, PYTHONPATH=os.path.dirname(
            os.path.abspath(__file__)))
        cmd = [sys.executable, "-m", "divortio_lz4_tpu_torch"]
        with open(small, "rb") as fin:
            p1 = subprocess.Popen(cmd + ["compress", "-", "-b", "65536",
                                         "--independent", *tdev],
                                  stdin=fin, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, env=env)
            p2 = subprocess.Popen(cmd + ["decompress", "-", *tdev],
                                  stdin=p1.stdout, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, env=env)
            p1.stdout.close()
            try:
                out, err2 = p2.communicate(timeout=300)
                err1 = p1.communicate(timeout=300)[1]
            finally:
                for p in (p1, p2):
                    if p.poll() is None:
                        p.kill()
                        p.wait()
        if p1.returncode or p2.returncode or out != xb[: 4 * MIB]:
            raise AssertionError(f"python -m divortio_lz4_tpu_torch pipe: "
                                 f"rc {p1.returncode}/{p2.returncode}, "
                                 f"{err1[-2000:]!r} {err2[-2000:]!r}")
        print(f"phase 14: python -m divortio_lz4_tpu_torch compress - | "
              f"decompress - on 4 MiB: exact [{err1.decode().strip()}] "
              f"[{err2.decode().strip()}] {tag}")
    launches = {k: fn.launches for k, fn in fns.items()}
    print(f"phase 14: kernel launches in the CLI runs {launches} {tag}")
    return launches


def _mh_rank(rank, port, path, device, out_dir):
    """One rank of phase 15's two-process run (torch.multiprocessing
    spawn): gloo from torch's env names, MultiHostCodec on *device*."""
    import torch
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE="2", RANK=str(rank))
    from divortio_lz4_tpu_torch import FrameConfig
    from divortio_lz4_tpu_torch.parallel.multihost import (
        MultiHostCodec, maybe_distributed_init)
    dist = torch.distributed
    if not maybe_distributed_init():
        raise AssertionError("maybe_distributed_init() is False")
    try:
        data = np.fromfile(path, np.uint8)
        codec = MultiHostCodec(FrameConfig(block_size=65536,
                                           block_independence=True),
                               devices=[device])
        if (codec.nproc, codec.pid) != (2, rank):
            raise AssertionError(f"rank {rank}: codec sees "
                                 f"{codec.nproc, codec.pid}")
        t_enc, t_dec = [], []
        for rep in range(4):        # a warm-up, then 3 timed
            dist.barrier()
            t0 = time.perf_counter()
            stream = codec.compress_corpus(data)
            dist.barrier()
            t1 = time.perf_counter()
            obj = [stream]
            dist.broadcast_object_list(obj, src=0)
            dist.barrier()
            t2 = time.perf_counter()
            plain = codec.decompress_corpus(obj[0])
            dist.barrier()
            t3 = time.perf_counter()
            if (stream is None) != (rank != 0):
                raise AssertionError(f"rank {rank}: stream {type(stream)}")
            if plain.tobytes() != data.tobytes():
                raise AssertionError(f"rank {rank}: decode differs")
            if rep:
                t_enc.append(t1 - t0)
                t_dec.append(t3 - t2)
        if rank == 0:
            with open(os.path.join(out_dir, "stream.lz4"), "wb") as f:
                f.write(obj[0])
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump({"enc": t_enc, "dec": t_dec}, f)
    finally:
        dist.destroy_process_group()


def _phase15(torch, pt, dev, corpus, tag) -> dict:
    """MultiHostCodec on the card (the module docstring's phase 15).
    Returns every kernel's launches in the one-process runs."""
    from divortio_lz4_tpu_torch import FrameConfig
    from divortio_lz4_tpu_torch.parallel import MultiHostCodec, ShardedCodec
    from divortio_lz4_tpu_torch.parallel.multihost import shard_bounds

    n = len(corpus)
    corpus_b = corpus.tobytes()
    cfg = FrameConfig(block_size=65536, block_independence=True)
    codec = MultiHostCodec(cfg, devices=[dev])
    if (codec.nproc, codec.pid) != (1, 0):
        raise AssertionError(f"one process: {codec.nproc, codec.pid}")
    want = ShardedCodec([dev], cfg).compress(corpus).tobytes()
    codec.decompress_corpus(codec.compress_corpus(corpus[: 8 * MIB]))
    fns = _kernel_fns()
    for fn in fns.values():
        fn.launches = 0
    t_enc, t_dec = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        stream = codec.compress_corpus(corpus)
        t1 = time.perf_counter()
        out = codec.decompress_corpus(stream)
        t2 = time.perf_counter()
        t_enc.append(t1 - t0)
        t_dec.append(t2 - t1)
        if stream != want or out.tobytes() != corpus_b:
            raise AssertionError("MultiHostCodec one process: stream == "
                                 f"ShardedCodec {stream == want}, decode "
                                 f"exact {out.tobytes() == corpus_b}")
    launches = {k: fn.launches for k, fn in fns.items()}
    enc_s, dec_s = statistics.median(t_enc), statistics.median(t_dec)
    print(f"phase 15: MultiHostCodec one process on [{dev}], 64 MiB at 64 KB "
          f"independent blocks, {len(stream)} B: == ShardedCodec([{dev}]) "
          f"frame, decoded exactly; encode {n / enc_s / 1e6:.1f} MB/s, "
          f"decode {n / dec_s / 1e6:.1f} MB/s (median of 3; enc {t_enc}, "
          f"dec {t_dec} s); launches {launches} {tag}")

    x = corpus[: 16 * MIB]
    half = shard_bounds(len(x), 2, 0)[1]
    sc = ShardedCodec([dev], cfg)
    want2 = sc.compress(x[:half]).tobytes() + sc.compress(x[half:]).tobytes()
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "corpus.bin")
        x.tofile(path)
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        t0 = time.perf_counter()
        mp.start_processes(_mh_rank, args=(port, path, str(dev), tmp),
                           nprocs=2, join=True, start_method="spawn")
        wall = time.perf_counter() - t0
        got = _read(os.path.join(tmp, "stream.lz4"))
        with open(os.path.join(tmp, "rank0.json")) as f:
            times = json.load(f)
    if got != want2:
        raise AssertionError("two processes: rank 0's stream != the two "
                             "shard frames joined")
    enc_s, dec_s = statistics.median(times["enc"]), \
        statistics.median(times["dec"])
    print(f"phase 15: MultiHostCodec two processes (spawn, gloo, both on "
          f"{dev}), 16 MiB: rank 0's stream ({len(got)} B) == the "
          f"ShardedCodec frames of the two halves joined; both ranks decode "
          f"it exactly; encode {len(x) / enc_s / 1e6:.1f} MB/s, decode "
          f"{len(x) / dec_s / 1e6:.1f} MB/s (rank 0's clock, median of 3; "
          f"enc {times['enc']}, dec {times['dec']} s); the call took "
          f"{wall:.1f} s with the processes' start {tag}")
    return launches


# The test vectors of tests/test_golden.py: (hex, plaintext, dictionary).
def _golden() -> dict:
    a_block = "1F410100" + "FF" * 256 + "E750" + "41" * 5
    pat = "4142434445464748494A4B4C4D4E4F50"
    hello = b"Hello World"
    return {
        "hello": ("04224D186040820B00008048656c6c6f20576f726c6400000000",
                  hello, None),
        "empty_4mb": ("04224D1860707300000000", b"", None),
        "hello_ck": ("04224D186440A70B00008048656c6c6f20576f726c6400000000"
                     "EE16FDB1", hello, None),
        "multiblock": ("04224D18604082" + ("0B010000" + a_block) * 2
                       + "00000000", b"A" * 131072, None),
        "linked_xblock": (
            "04224D184040C0" + "1B010000" + "FF01" + pat + "1000"
            + "FF" * 256 + "D850" + "4C4D4E4F50" + "8A000000" + "0F1000"
            + "FF" * 128 + "6850" + "4C4D4E4F50" + "00000000",
            b"ABCDEFGHIJKLMNOP" * 6144, None),
        "dictionary": ("04224D184140FBE517E7080A0000000F400068506263646566"
                       "00000000", b"0123456789abcdef" * 8,
                       b"0123456789abcdef" * 4),
        "block_ck": ("04224D187040AD0B00008048656C6C6F20576F726C64EE16FDB1"
                     "00000000", hello, None),
        "mixed_stored": ("04224D18604082" + "0B010000" + a_block
                         + "1B000080"
                         + b"incompressible tail bytes!!".hex().upper()
                         + "00000000",
                         b"A" * 65536 + b"incompressible tail bytes!!",
                         None),
        "content_size": ("04224D1868400B00000000000000580B00008048656C6C6F"
                         "20576F726C6400000000", hello, None),
    }


def _phase16(torch, pt, dev, corpus, tag):
    """The device example and the host facade (the module docstring's
    phase 16)."""
    from divortio_lz4_tpu_torch import FrameConfig

    root = os.path.dirname(os.path.abspath(__file__))
    res = subprocess.run([sys.executable, os.path.join(
        root, "examples", "12_torch_device.py"), "--device", dev.type],
        capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise AssertionError(f"examples/12_torch_device.py exited "
                             f"{res.returncode}: {res.stderr[-3000:]}")
    print(f"phase 16: examples/12_torch_device.py --device {dev.type}: "
          f"exit 0; {' | '.join(res.stdout.strip().splitlines())} {tag}")

    x = corpus[: 16 * MIB]
    xb = x.tobytes()
    cfg = FrameConfig(block_size=65536, block_independence=True,
                      content_checksum=True)
    t0 = time.perf_counter()
    f = pt.compress(x, None, cfg)
    t1 = time.perf_counter()
    out = pt.decompress(f)
    t2 = time.perf_counter()
    if out.tobytes() != xb:
        raise AssertionError("pt.compress / pt.decompress round trip")
    if f.tobytes() != pt.compress_frame(x, cfg, engine="pallas",
                                        device=dev).tobytes():
        raise AssertionError("pt.compress != the engine='pallas' frame")
    default = pt.compress(x)
    if pt.decompress(default).tobytes() != xb or \
            pt.decompress_frame(default, device=dev).tobytes() != xb:
        raise AssertionError("the default host frame does not decode")
    block = pt.compress_raw(x[:65536])
    if pt.decompress_raw(block, 65536).tobytes() != xb[:65536]:
        raise AssertionError("compress_raw / decompress_raw round trip")
    text = xb[:100_000].decode("latin-1")
    obj = {"rows": [text[i: i + 100] for i in range(0, 5000, 100)]}
    if pt.decompress_string(pt.compress_string(text)) != text or \
            pt.decompress_object(pt.compress_object(obj)) != obj:
        raise AssertionError("string / object helpers round trip")
    print(f"phase 16: host codec, 16 MiB at 64 KB independent blocks: "
          f"pt.compress {len(x) / (t1 - t0) / 1e6:.1f} MB/s (== the "
          f"engine='pallas' frame), pt.decompress "
          f"{len(x) / (t2 - t1) / 1e6:.1f} MB/s (host clock, one call "
          f"each); the default frame decoded by pt.decompress and "
          f"decompress_frame; raw block, string and object round trips "
          f"{tag}")

    want = _stream_frame(pt, x, cfg, dev, 4 * MIB)
    got = asyncio.run(pt.compress_async(x, config=cfg, chunk_size=4 * MIB,
                                        device=dev))
    back = asyncio.run(pt.decompress_async(got, chunk_size=4 * MIB,
                                           device=dev))
    if got != want or back != xb:
        raise AssertionError(f"compress_async == stream frame {got == want}"
                             f", decompress_async exact {back == xb}")
    chunks = [xb[i: i + 4 * MIB] for i in range(0, len(xb), 4 * MIB)]
    w = pt.LZ4Worker
    if w.compress(x, config=cfg).result(timeout=300).tobytes() != \
            f.tobytes() or w.decompress(f).result(timeout=300).tobytes() \
            != xb:
        raise AssertionError("LZ4Worker buffer tasks")
    ws = w.compress_stream(chunks, config=cfg, device=dev).result(
        timeout=300)
    wd = w.decompress_stream([ws[i: i + 4 * MIB]
                              for i in range(0, len(ws), 4 * MIB)],
                             device=dev).result(timeout=300)
    if ws != want or wd != xb:
        raise AssertionError(f"LZ4Worker streams: frame {ws == want}, "
                             f"decode {wd == xb}")
    print(f"phase 16: compress_async / decompress_async and LZ4Worker's "
          f"buffer and stream tasks on {dev}: frames == the CompressStream "
          f"frame ({len(want)} B), decoded exactly {tag}")

    for name, (hexs, plain, d) in _golden().items():
        frame = np.frombuffer(bytes.fromhex(hexs), np.uint8)
        host = pt.decompress(frame, d).tobytes()
        card = pt.decompress_frame(frame, dictionary=d, device=dev).tobytes()
        ds = pt.DecompressStream(d, device=dev)
        stream = ds.write(frame.tobytes()) + ds.flush()
        if not host == card == stream == plain:
            raise AssertionError(f"test vector {name}: host {host == plain}"
                                 f", card {card == plain}, stream "
                                 f"{stream == plain}")
    print(f"phase 16: the {len(_golden())} test vectors of "
          f"tests/test_golden.py decode exactly through pt.decompress, "
          f"decompress_frame on {dev} and a DecompressStream {tag}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0x51E51A)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2

    # -- phase 1: device and build -------------------------------------
    card = _card()
    print(card)
    tag = f"[{card}]"
    dev = torch.device("cuda:0")
    print(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda} "
          f"on {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    import divortio_lz4_tpu_torch as pt
    from divortio_lz4_tpu_torch import FrameConfig, _build
    from divortio_lz4_tpu_torch.ops.compact_decode import (
        decode_blocks_compact, decode_blocks_compact_plain)
    from bench import build_corpus

    t0 = time.perf_counter()
    sources = CUDA_SOURCES + ("host_kernels",)
    with ThreadPoolExecutor(len(sources)) as ex:   # one compiler per source
        list(ex.map(_build.library_path, sources))
    build_s = time.perf_counter() - t0
    print(f"phase 1: built csrc/{{{','.join(CUDA_SOURCES)}}}.cu for sm_90a "
          f"(nvcc) and csrc/host_kernels.cpp (g++) in {build_s:.2f} s {tag}")
    for name in CUDA_SOURCES:
        for line in _build.build_log(name).splitlines():
            if any(k in line for k in ("Compiling entry", "registers",
                                       "spill")):
                print(f"phase 1: {name}: ptxas: {line.strip()}")

    # -- phase 2: kernel vs plain ----------------------------------------
    corpus = build_corpus(64 * MIB, args.seed)
    cfg = FrameConfig(block_size=65536, block_independence=True,
                      content_checksum=True)
    ref_frame = pt.compress_frame(corpus, cfg, engine="pallas", device=dev)
    rng = np.random.default_rng(args.seed)
    d = np.array(corpus[3 * MIB: 3 * MIB + 32768])
    dict_frame = pt.compress_frame(corpus[:4 * MIB], cfg, dictionary=d,
                                   device=dev)
    dense = rng.integers(0, 4, 32 * 65536).astype(np.uint8)
    dense_frame = pt.compress_frame(dense, cfg, engine="pallas", device=dev)
    entries = {"main": _frame_entries(ref_frame),
               "dense": _frame_entries(dense_frame),
               "dict": _frame_entries(dict_frame)}
    cases = {name: _batch(e, d if name == "dict" else None, dev)
             for name, e in entries.items()}
    # hostile: the dense batch with random words in row 5's records
    hb = cases["dense"][0]
    r0, r1 = int(hb.rec_off[5]), int(hb.rec_off[6])
    words = hb.rec_words.clone()
    words[r0:r1] = torch.from_numpy(rng.integers(
        -2**31, 2**31, (r1 - r0, 2), dtype=np.int64).astype(np.int32)).to(dev)
    cases["hostile"] = (hb._replace(rec_words=words), cases["dense"][1])

    timing = {}
    max_err = 0
    outs = {}
    for name, (b, max_recs) in cases.items():
        args_ = (b.wire, b.rec_words, b.rec_off, b.out_lens, 65536, b.hist)
        got = decode_blocks_compact(*args_)
        stats = _group_stats(decode_blocks_compact, f"compact_decode {name}",
                             int(name == "hostile"))
        want = decode_blocks_compact_plain(*args_)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        max_err = max(max_err, err)
        if err:
            bad = (got != want).any(1).nonzero().flatten().tolist()
            raise AssertionError(f"{name}: kernel != plain in rows {bad[:8]}")
        outs[name] = got
        print(f"phase 2: {name}: {b.wire.shape[0]} blocks, <= {max_recs} "
              f"records/block, kernel == plain byte for byte; {stats} "
              f"{tag}")
    # the hostile row stays in its row: every other row decodes as before
    others = [i for i in range(outs["dense"].shape[0]) if i != 5]
    if not torch.equal(outs["hostile"][others], outs["dense"][others]):
        raise AssertionError("hostile records changed another row")
    print(f"phase 2: hostile: no fault, the other {len(others)} rows exact "
          f"{tag}")
    for name in ("main", "dense", "dict"):
        b = cases[name][0]
        args_ = (b.wire, b.rec_words, b.rec_off, b.out_lens, 65536, b.hist)
        k_ms = _cuda_ms(torch, lambda: decode_blocks_compact(*args_), 5)
        stats = _group_stats(decode_blocks_compact, f"compact_decode {name}",
                             0)
        p_ms = _cuda_ms(torch, lambda: decode_blocks_compact_plain(*args_),
                        1)
        # wire bytes, records, offsets and lengths in (the dictionary once,
        # not per row), decoded bytes out
        timing[name] = (k_ms, p_ms, _bound_ms(
            _wire_bytes(entries[name]), b.rec_words, b.rec_off, b.out_lens,
            len(d) if b.hist is not None else None, int(b.out_lens.sum())))
        mb = int(b.out_lens.sum()) / 1e6
        print(f"phase 2: {name}: kernel {k_ms:.3f} ms ({mb / k_ms:.1f} "
              f"GB/s of output), plain {p_ms:.1f} ms; {stats} {tag}")

    # -- phase 3: one 64 MiB frame ---------------------------------------
    corpus_b = corpus.tobytes()
    frame = pt.compress_frame(corpus, cfg, device=dev)   # warm-up
    pt.decompress_frame(frame, device=dev)
    decode_blocks_compact.launches = 0
    t_enc, t_dec = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        frame = pt.compress_frame(corpus, cfg, device=dev)
        t1 = time.perf_counter()
        out = pt.decompress_frame(frame, device=dev)
        t2 = time.perf_counter()
        t_enc.append(t1 - t0)
        t_dec.append(t2 - t1)
        if out.tobytes() != corpus_b:
            raise AssertionError("64 MiB round trip is not exact")
    launches = decode_blocks_compact.launches
    if launches < 1:
        raise AssertionError("the main path never launched compact_decode")
    _other_engine_exact(pt, frame, corpus, dev, "pallas",
                        what="64 MiB split frame")
    if len(frame) >= len(corpus):
        raise AssertionError("the 64 MiB frame is not smaller than its input")
    n = len(corpus)
    enc_s, dec_s = statistics.median(t_enc), statistics.median(t_dec)
    print(f"phase 3: 64 MiB frame, {len(frame)} B, ratio vs the "
          f"engine='pallas' frame (reference-identical, same 64 KB "
          f"independent blocks) {len(frame) / len(ref_frame):.4f} "
          f"({len(ref_frame)} B); round trip exact, engine='pallas' decodes "
          f"it exactly; compact_decode launches {launches} {tag}")
    print(f"phase 3: encode {n / enc_s / 1e6:.1f} MB/s, decode "
          f"{n / dec_s / 1e6:.1f} MB/s, round trip "
          f"{n / (enc_s + dec_s) / 1e6:.1f} MB/s (median of 3; "
          f"enc {t_enc}, dec {t_dec} s) {tag}")

    # -- phase 4: 16 x 4 MiB frames in flight ----------------------------
    datas = [corpus[i * 4 * MIB: (i + 1) * 4 * MIB] for i in range(16)]
    t0 = time.perf_counter()
    frames = pt.compress_frames(datas[:14], cfg, device=dev)
    frames += pt.compress_frames(datas[14:15], cfg.with_(block_checksums=True),
                                 device=dev)
    frames += pt.compress_frames(datas[15:], cfg, dictionary=d, device=dev)
    t1 = time.perf_counter()
    outs4 = pt.decompress_frames(frames, dictionary=d, device=dev)
    t2 = time.perf_counter()
    for i, (f, o, x) in enumerate(zip(frames, outs4, datas)):
        if o.tobytes() != x.tobytes():
            raise AssertionError(f"in-flight frame {i} round trip differs")
    _other_engine_exact(pt, frames[15], datas[15], dev, "pallas", d,
                        "the dictionary frame")
    print(f"phase 4: 16 x 4 MiB frames (1 block-checksum, 1 dictionary) "
          f"exact; encode {n / (t1 - t0) / 1e6:.1f} MB/s, decode "
          f"{n / (t2 - t1) / 1e6:.1f} MB/s {tag}")
    peak = torch.cuda.max_memory_allocated() / MIB
    print(f"phase 4: peak device memory {peak:.0f} MiB {tag}")

    chain, wire = _phase5(torch, pt, dev, corpus, args.seed, tag)
    default_frame, chain_launches, wire_launches, chain64 = _phase6(
        torch, pt, dev, corpus, tag)
    _phase7(torch, pt, dev, corpus, d, tag)
    pallas = _phase8(torch, pt, dev, corpus, ref_frame, dict_frame, d,
                     default_frame, args.seed, tag)
    hybrid, hybrid_frame = _phase9(torch, pt, dev, corpus, ref_frame, d,
                                   args.seed, tag)
    split = _phase10(torch, pt, dev, corpus, hybrid_frame, dict_frame, d,
                     args.seed, tag)
    _phase11(torch, pt, dev, corpus, ref_frame, card, tag)
    stream_launches = _phase12(torch, pt, dev, corpus, args.seed, tag)
    sharded_launches = _phase13(torch, pt, dev, corpus, tag)
    cli_launches = _phase14(torch, pt, dev, corpus, tag)
    multihost_launches = _phase15(torch, pt, dev, corpus, tag)
    _phase16(torch, pt, dev, corpus, tag)

    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "divortio_lz4_tpu"))
    if bad:
        raise AssertionError(f"the JAX package or jax was imported: {bad}")
    k_ms, p_ms, b_ms = timing["main"]
    src = "divortio_lz4_tpu_torch/csrc/"
    kernels = [
        dict(name="compact_decode", source="compact_decode.cu",
             replaces="divortio_lz4_tpu/ops/pallas_split_decode.py:689",
             launches=launches, max_abs_err=max_err, ms=k_ms, plain_ms=p_ms,
             bound_ms=b_ms),
        dict(name="chain_decode", source="chain_decode.cu",
             replaces="divortio_lz4_tpu/ops/wave_decode.py:60",
             launches=chain_launches, max_abs_err=chain[0],
             ms=chain64["ms"], plain_ms=chain[2],
             bound_ms=chain64["bound_ms"],
             inputs="ms and bound_ms: the 64 MiB default frame's chain "
                    "(checked against the corpus; its plain walk of 2.7M "
                    "records does not fit the run's time); plain_ms: the "
                    "4 MiB linked frame; max_abs_err: every phase-5 "
                    "batch"),
        dict(name="wire_decode", source="chain_decode.cu",
             replaces="divortio_lz4_tpu/ops/pallas_split_decode.py:565",
             launches=wire_launches, max_abs_err=wire[0], ms=wire[1],
             plain_ms=wire[2], bound_ms=wire[3]),
        dict(name="greedy_encode", source="greedy_encode.cu",
             replaces="divortio_lz4_tpu/ops/pallas_encode.py:66",
             **pallas["greedy_encode"]),
        dict(name="token_decode", source="token_decode.cu",
             replaces="divortio_lz4_tpu/ops/pallas_decode.py:233",
             **pallas["token_decode"]),
        dict(name="token_decode_linked", source="token_decode.cu",
             replaces="divortio_lz4_tpu/ops/pallas_decode.py:410",
             inputs="ms and bound_ms: the 64 MiB default frame (checked "
                    "against the corpus); plain_ms: the linked 64 KB "
                    "frame; max_abs_err: every phase-8 linked batch",
             **pallas["token_decode_linked"]),
        dict(name="hybrid_encode", source="greedy_encode.cu",
             replaces="divortio_lz4_tpu/ops/hybrid_encode.py:366", **hybrid),
        dict(name="split_decode", source="split_decode.cu",
             replaces="divortio_lz4_tpu/ops/pallas_split_decode.py:91",
             **split),
    ]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for k in kernels:
        # no PyTorch call computes an LZ4 encode or decode: library_ms null
        k.update(route="cuda", source=src + k["source"], bound_by="bytes",
                 library_ms=None,
                 path_launches={"stream": stream_launches.get(k["name"], 0),
                                "sharded": sharded_launches.get(k["name"],
                                                                0),
                                "cli": cli_launches[k["name"]],
                                "multihost": multihost_launches[k["name"]]})
        if k["launches"] < 1 or k["max_abs_err"] != 0:
            raise AssertionError(f"{k['name']}: launches {k['launches']}, "
                                 f"max_abs_err {k['max_abs_err']}")
        # split_decode has no frame route, in either package
        if k["name"] != "split_decode" and cli_launches[k["name"]] < 1:
            raise AssertionError(f"{k['name']}: no launch in the CLI runs "
                                 "of phase 14")
    print(json.dumps({"kernels": [{key: k[key] for key in keys
                                   + ("path_launches",)
                                   + (("inputs",) if "inputs" in k else ())}
                                  for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
