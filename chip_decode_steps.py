#!/usr/bin/env python3
"""Time the two independent-block decode kernels of the port found in the
current directory, on the 64 MiB corpus.

    python3 chip_decode_steps.py [--inputs DIR] [--name NAME]

token_decode on the engine="pallas" frame's 1024 x 64 KB blocks and
wire_decode on its 256 x 256 KB blocks (bench.build_corpus(64 MiB,
0x51E51A)): each output checked against the corpus, then timed by CUDA
events (one warm-up call, then 3 times the mean of 10 calls), printed with
the kernel's stats and one call's kernels under torch.profiler. The inputs
are made by the first run and kept under --inputs as numpy files, so that
one command can time the same inputs with several versions of the port:
run this script from the root of each (an unpacked `git archive` of
another commit, say) in turn, in one call on one card. Needs an NVIDIA
GPU, nvcc and g++; imports neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

MIB = 1 << 20
TOKEN_FILES = ("comp", "lens")
WIRE_FILES = ("wire", "recs", "counts", "out_lens")


def _make_inputs(torch, folder: str) -> None:
    """The two batches of the 64 MiB corpus, and the corpus, as .npy."""
    import divortio_lz4_tpu_torch as pt
    from bench import build_corpus
    from divortio_lz4_tpu_torch import FrameConfig
    from divortio_lz4_tpu_torch.ops.wire_decode import parse_wire_batch
    from divortio_lz4_tpu_torch.parallel.device import (parse_block_index,
                                                        stage_token_blocks)

    os.makedirs(folder, exist_ok=True)
    corpus = build_corpus(64 * MIB, 0x51E51A)
    arrays = {"corpus": corpus}
    for bs in (64 * 1024, 256 * 1024):
        frame = pt.compress_frame(corpus, FrameConfig(
            block_size=bs, block_independence=True), engine="pallas",
            device="cuda")
        _, blocks, _ = parse_block_index(frame)
        if bs == 64 * 1024:
            comp, lens, _ = stage_token_blocks(frame, blocks, None, "cuda")
            arrays.update(comp=comp.cpu().numpy(), lens=lens.cpu().numpy(),
                          frame64=frame,
                          blocks64=np.array(blocks, np.int64))
        else:
            entries = [(frame[o: o + n], st) for o, n, st in blocks]
            arrays.update(zip(WIRE_FILES, parse_wire_batch(
                entries, bs, None)[:4]))
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--inputs", default=os.path.join("_scratch",
                                                     "decode_inputs"))
    ap.add_argument("--name", default=os.path.basename(os.getcwd()))
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())   # the port of this directory

    import torch
    if not torch.cuda.is_available():
        print("chip_decode_steps: torch.cuda.is_available() is False; this "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from divortio_lz4_tpu_torch.ops.token_decode import decode_blocks_pallas
    from divortio_lz4_tpu_torch.ops.wire_decode import decode_blocks_wire

    folder = os.path.abspath(args.inputs)
    if not os.path.exists(os.path.join(folder, "out_lens.npy")):
        _make_inputs(torch, folder)

    def load(name):
        return np.load(os.path.join(folder, f"{name}.npy"))

    dev = torch.device("cuda")
    corpus = load("corpus")
    name = args.name

    comp, lens = (torch.from_numpy(load(f)).to(dev) for f in TOKEN_FILES)
    rows, ols = (x.cpu().numpy() for x in
                 decode_blocks_pallas(comp, lens, 65536))
    frame, blocks = load("frame64"), load("blocks64")
    got = np.concatenate([frame[o: o + n] if st else rows[i, : ols[i]]
                          for i, (o, n, st) in enumerate(blocks)])
    ms = _time(torch, lambda: decode_blocks_pallas(comp, lens, 65536))
    stats = getattr(decode_blocks_pallas, "last_stats", None)
    extra = ""
    if stats is not None:
        st = stats.cpu().long()
        extra = (f"; stats (sequences, re-walked, in order, serial) sums "
                 f"{st.sum(0).tolist()} maxima {st.max(0).values.tolist()}")
    print(f"{name}: token_decode 1024 x 64 KB: exact "
          f"{got.tobytes() == corpus.tobytes()}, ms {ms}{extra}")
    _profile(torch, name, lambda: decode_blocks_pallas(comp, lens, 65536))

    wire, recs, counts = (torch.from_numpy(load(f)).to(dev)
                          for f in WIRE_FILES[:3])
    out_lens = load("out_lens")
    rows = decode_blocks_wire(wire, recs, counts, 256 * 1024).cpu().numpy()
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
