#!/usr/bin/env python3
"""Time the port's block decode kernels found in the current directory, on
the 64 MiB corpus.

    python3 chip_decode_steps.py [--inputs DIR] [--name NAME]
                                 [--kernels token,wire,compact,split]

Batches (bench.build_corpus(64 MiB, 0x51E51A), 64 KB independent blocks
with a content checksum unless said otherwise):

- token: token_decode on the engine="pallas" frame's 1024 x 64 KB blocks;
- wire: wire_decode on the engine="pallas" frame's 256 x 256 KB blocks;
- compact: compact_decode on the engine="pallas" frame's 1024 x 64 KB
  compact records (parse_wire_raw, then build_flat_records: the split
  engine's main path), on 32 x 64 KB blocks of a 4-symbol alphabet
  ("dense", the worst case for its dependency levels) and on the split
  engine's frame of the corpus's first 4 MiB with a 32 KB dictionary
  ("dict", 64 blocks, each with its history row);
- split: split_decode on the engine="hybrid" frame's compressed blocks
  (parse_block_batch: literal images and match records), and on the
  "dict" frame's compressed blocks with the dictionary as their history.

Each output is checked against its plaintext, then timed by CUDA events
(one warm-up call, then 3 times the mean of 10 calls), printed with the
kernel's stats where the port has them, and one call's kernels are
listed under torch.profiler. The inputs are made by the first run and
kept under --inputs as numpy files, so that one command can time the same
inputs with several versions of the port: run this script from the root
of each (an unpacked `git archive` of another commit, say) in turn, in one
call on one card. Needs an NVIDIA GPU, nvcc and g++; imports neither jax
nor the JAX package.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

MIB = 1 << 20
B64 = 64 * 1024
TOKEN_FILES = ("comp", "lens")
WIRE_FILES = ("wire", "recs", "counts", "out_lens")
COMPACT_FILES = ("wire", "rec_words", "rec_off", "out_lens")
SPLIT_FILES = ("lit", "recs", "counts", "out_lens")
KERNELS = ("token", "wire", "compact", "split")


def _compact_arrays(entries, prefix: str, window=None) -> dict:
    from divortio_lz4_tpu_torch.ops.split_decode import (build_flat_records,
                                                         parse_wire_raw)
    wire, recs_l, _, out_lens, hist = parse_wire_raw(entries, B64, window)
    rec_words, rec_off = build_flat_records(recs_l)
    out = {f"{prefix}_{k}": v for k, v in
           zip(COMPACT_FILES, (wire, rec_words, rec_off, out_lens))}
    if hist is not None:
        out[f"{prefix}_hist"] = hist
    return out


def _make_inputs(torch, folder: str) -> None:
    """Every batch, and the plaintexts and frames to check them, as .npy."""
    import divortio_lz4_tpu_torch as pt
    from bench import build_corpus
    from divortio_lz4_tpu_torch import FrameConfig
    from divortio_lz4_tpu_torch.ops.split_decode import parse_block_batch
    from divortio_lz4_tpu_torch.ops.wire_decode import parse_wire_batch
    from divortio_lz4_tpu_torch.parallel.device import (parse_block_index,
                                                        stage_token_blocks)

    os.makedirs(folder, exist_ok=True)
    corpus = build_corpus(64 * MIB, 0x51E51A)
    dense = np.random.default_rng(0x51E51A).integers(
        0, 4, 32 * B64).astype(np.uint8)
    arrays = {"corpus": corpus, "dense": dense}

    def frame_of(x, bs, engine, dictionary=None):
        cfg = FrameConfig(block_size=bs, block_independence=True,
                          content_checksum=True)
        frame = pt.compress_frame(x, cfg, dictionary=dictionary,
                                  engine=engine, device="cuda")
        _, blocks, _ = parse_block_index(frame)
        return frame, blocks, [(frame[o: o + n], st) for o, n, st in blocks]

    frame, blocks, entries = frame_of(corpus, B64, "pallas")
    comp, lens, _ = stage_token_blocks(frame, blocks, None, "cuda")
    arrays.update(comp=comp.cpu().numpy(), lens=lens.cpu().numpy(),
                  frame64=frame, blocks64=np.array(blocks, np.int64))
    arrays.update(_compact_arrays(entries, "compact"))
    arrays.update(_compact_arrays(frame_of(dense, B64, "pallas")[2],
                                  "dense"))
    d = corpus[3 * MIB: 3 * MIB + 32768]
    frame, blocks, entries = frame_of(corpus[:4 * MIB], B64, "split", d)
    arrays.update(_compact_arrays(entries, "dict", d))
    comps = [c for c, st in entries if not st]
    arrays.update({f"splitdict_{k}": v for k, v in zip(SPLIT_FILES,
                   parse_block_batch(comps, B64, [d] * len(comps))[:4])},
                  dict=frame, dict_blocks=np.array(blocks, np.int64))
    _, _, entries = frame_of(corpus, 256 * 1024, "pallas")
    arrays.update(zip(WIRE_FILES, parse_wire_batch(entries, 256 * 1024,
                                                   None)[:4]))
    frame, blocks, entries = frame_of(corpus, B64, "hybrid")
    lit, recs, counts, out_lens, _ = parse_block_batch(
        [c for c, st in entries if not st], B64)
    arrays.update({f"split_{k}": v for k, v in
                   zip(SPLIT_FILES, (lit, recs, counts, out_lens))},
                  hybrid=frame, hybrid_blocks=np.array(blocks, np.int64))
    for name, a in arrays.items():
        np.save(os.path.join(folder, f"{name}.npy"), a)


def _time(torch, fn, reps: int = 10):
    fn()
    out = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(stop) / reps)
    return out


def _profile(torch, name: str, fn) -> None:
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or \
            getattr(e, "cuda_time_total", 0)
        if t:
            print(f"{name}:   {t / 1e3:.3f} ms  {e.key[:90]}")


def _block_stats(fn, names) -> str:
    """Sums and maxima of a wrapper's per-block ``last_stats`` (absent on
    trees whose kernel has none)."""
    stats = getattr(fn, "last_stats", None)
    if stats is None:
        return ""
    st = stats.cpu().long()
    return (f"; stats ({', '.join(names)}) sums {st.sum(0).tolist()} "
            f"maxima {st.max(0).values.tolist()}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--inputs", default=os.path.join("_scratch",
                                                     "decode_inputs"))
    ap.add_argument("--name", default=os.path.basename(os.getcwd()))
    ap.add_argument("--kernels", default=",".join(KERNELS))
    args = ap.parse_args()
    kernels = args.kernels.split(",")
    if not set(kernels) <= set(KERNELS):
        ap.error(f"--kernels takes a list of {KERNELS}")
    sys.path.insert(0, os.getcwd())   # the port of this directory

    import torch
    if not torch.cuda.is_available():
        print("chip_decode_steps: torch.cuda.is_available() is False; this "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from divortio_lz4_tpu_torch.ops.compact_decode import \
        decode_blocks_compact
    from divortio_lz4_tpu_torch.ops.split_decode import decode_blocks_split
    from divortio_lz4_tpu_torch.ops.token_decode import decode_blocks_pallas
    from divortio_lz4_tpu_torch.ops.wire_decode import decode_blocks_wire

    folder = os.path.abspath(args.inputs)
    if not os.path.exists(os.path.join(folder, "dict_blocks.npy")):
        _make_inputs(torch, folder)

    def load(name):
        return np.load(os.path.join(folder, f"{name}.npy"))

    def put(*names):
        return [torch.from_numpy(load(f)).to(dev) for f in names]

    dev = torch.device("cuda")
    corpus = load("corpus")
    name = args.name

    if "token" in kernels:
        comp, lens = put(*TOKEN_FILES)
        rows, ols = (x.cpu().numpy() for x in
                     decode_blocks_pallas(comp, lens, B64))
        frame, blocks = load("frame64"), load("blocks64")
        got = np.concatenate([frame[o: o + n] if st else rows[i, : ols[i]]
                              for i, (o, n, st) in enumerate(blocks)])
        ms = _time(torch, lambda: decode_blocks_pallas(comp, lens, B64))
        extra = _block_stats(decode_blocks_pallas, (
            "sequences", "re-walked", "in order", "serial"))
        print(f"{name}: token_decode 1024 x 64 KB: exact "
              f"{got.tobytes() == corpus.tobytes()}, ms {ms}{extra}")
        _profile(torch, name, lambda: decode_blocks_pallas(comp, lens, B64))

    if "wire" in kernels:
        wire, recs, counts = put(*WIRE_FILES[:3])
        out_lens = load("out_lens")
        rows = decode_blocks_wire(wire, recs, counts,
                                  256 * 1024).cpu().numpy()
        got = np.concatenate([rows[i, : out_lens[i]]
                              for i in range(len(out_lens))])
        ms = _time(torch, lambda: decode_blocks_wire(wire, recs, counts,
                                                     256 * 1024))
        last = getattr(decode_blocks_wire, "last", None)
        extra = f"; {last.stats()}" if last is not None else ""
        print(f"{name}: wire_decode 256 x 256 KB: exact "
              f"{got.tobytes() == corpus.tobytes()}, ms {ms}{extra}")
        _profile(torch, name, lambda: decode_blocks_wire(wire, recs, counts,
                                                         256 * 1024))

    stat_names = ("records", "groups", "levels", "most levels", "serial")
    if "compact" in kernels:
        for batch, plain in (("compact", corpus), ("dense", load("dense")),
                             ("dict", corpus[:4 * MIB])):
            cargs = put(*(f"{batch}_{f}" for f in COMPACT_FILES)) + [B64]
            if batch == "dict":
                cargs += put("dict_hist")
            out_lens = load(f"{batch}_out_lens")
            rows = decode_blocks_compact(*cargs).cpu().numpy()
            got = np.concatenate([rows[i, : n]
                                  for i, n in enumerate(out_lens)])
            ms = _time(torch, lambda: decode_blocks_compact(*cargs))
            extra = _block_stats(decode_blocks_compact, stat_names)
            print(f"{name}: compact_decode {batch} {len(out_lens)} x 64 KB: "
                  f"exact {got.tobytes() == plain.tobytes()}, ms "
                  f"{ms}{extra}")
            _profile(torch, name, lambda: decode_blocks_compact(*cargs))

    if "split" in kernels:
        for batch, frame, blocks, plain, uh in (
                ("split", "hybrid", "hybrid_blocks", corpus, False),
                ("splitdict", "dict", "dict_blocks", corpus[:4 * MIB], True)):
            sargs = put(*(f"{batch}_{f}" for f in SPLIT_FILES[:3])) + \
                [B64, uh]
            out_lens = load(f"{batch}_out_lens")
            rows = decode_blocks_split(*sargs).cpu().numpy()
            frame, blocks = load(frame), load(blocks)
            parts, j = [], 0
            for o, n, st in blocks:
                if st:
                    parts.append(frame[o: o + n])
                else:
                    parts.append(rows[j, : out_lens[j]])
                    j += 1
            got = np.concatenate(parts)
            ms = _time(torch, lambda: decode_blocks_split(*sargs))
            extra = _block_stats(decode_blocks_split, stat_names)
            print(f"{name}: split_decode {batch} {len(out_lens)} x 64 KB: "
                  f"exact {got.tobytes() == plain.tobytes()}, ms "
                  f"{ms}{extra}")
            _profile(torch, name, lambda: decode_blocks_split(*sargs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
