#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (divortio_lz4_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printed on its own line:

1. Device and build: the card's name and power limit (nvidia-smi), the
   nvcc builds of csrc/compact_decode.cu and csrc/chain_decode.cu from
   this checkout (started together), their ptxas registers and spills,
   the native host tier.
2. Kernel vs plain: the CUDA compact-decode kernel against its plain
   PyTorch version on the card, byte for byte, on the 64 MiB corpus
   frame's blocks (the main-path shape), dense 64 KB blocks, a dictionary
   batch and a batch with one row of random records; both timed with CUDA
   events.
3. One 64 MiB frame through compress_frame / decompress_frame (64 KB
   independent blocks, content checksum): exact round trip, decodable by
   the host C++ codec, size against the host encoder's, MB/s, and the
   kernel's launch count during the run.
4. 16 frames of 4 MiB in flight through compress_frames /
   decompress_frames, one with block checksums and one with a dictionary.
5. Kernel vs plain for the chain and wide-block kernels, byte for byte,
   both timed with CUDA events: chain_decode on a 4 MiB linked 4 MB-block
   frame, 4 independent 1 MB blocks, a linked frame with a dictionary, a
   giant-RLE block and a batch with one chain of random records;
   wire_decode on the 64 MiB corpus's 256 independent 256 KB blocks (the
   batch phase 6 decodes) and on 32 such blocks with a dictionary.
6. The default frame (FrameConfig(): 4 MB linked blocks) at 64 MiB, with a
   content checksum, through compress_frame / decompress_frame: exact
   round trip, host-decodable, size against the host encoder, MB/s
   (median of 3) and chain_decode's launch count; then once each for
   independent 4 MB, independent 256 KB and linked 64 KB blocks, each with
   its kernel's launch count.
7. 16 default-config frames of 4 MiB in flight, and one decompress_frames
   call over a mixed batch (64 KB and 256 KB independent, 4 MB linked
   with a dictionary).

Then a JSON line describing the kernels, and last the device line. Any
failed check raises and the exit code is non-zero. Needs an NVIDIA GPU,
nvcc and g++; never imports jax.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

MIB = 1 << 20


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


def _compare(torch, name, got, want, tag) -> int:
    """Byte-for-byte kernel vs plain; returns the max abs difference (0)."""
    torch.cuda.synchronize()
    err = int((got.int() - want.int()).abs().max()) if got.numel() else 0
    if err or got.shape != want.shape:
        bad = (got != want).reshape(got.shape[0], -1).any(1).nonzero()
        raise AssertionError(f"{name}: kernel != plain (rows "
                             f"{bad.flatten().tolist()[:8]})")
    print(f"phase 5: {name}: kernel == plain byte for byte {tag}")
    return err


def _phase5(torch, dev, corpus, seed, tag):
    """chain_decode and wire_decode against their plain versions.
    Returns ((max_err, ms, plain_ms) for chain, the same for wire), timed
    on the 4 MiB default-config frame and on the 256 independent 256 KB
    blocks of the 64 MiB corpus (phase 6's batch)."""
    import divortio_lz4_tpu as lz4
    from divortio_lz4_tpu.config import FrameConfig
    from divortio_lz4_tpu_torch.ops.wave_decode import (
        decode_chains, decode_chains_plain)
    from divortio_lz4_tpu_torch.ops.wire_decode import (
        decode_blocks_wire, decode_blocks_wire_plain, parse_wire_batch)
    from bench import build_corpus

    data = build_corpus(8 * MIB, seed + 1)
    d = np.array(data[5 * MIB: 5 * MIB + 32768])
    rng = np.random.default_rng(seed)

    def frame(x, bs, indep, dic=None):
        return np.asarray(lz4.compress(x, dictionary=dic, config=FrameConfig(
            block_size=bs, block_independence=indep)))

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
        print(f"phase 5: chain_decode {name}: {b.wire_off.shape[0] - 1} "
              f"chains, {b.rec_words.shape[0]} records, {b.out_total} B "
              f"{tag}")
    o1, o2 = int(hb.out_off[1]), int(hb.out_off[2])
    for part in (slice(0, o1), slice(o2, None)):
        if not torch.equal(outs["hostile"][part],
                           outs["independent_1m"][part]):
            raise AssertionError("hostile records changed another chain")
    print(f"phase 5: hostile: no fault, the other chains exact {tag}")
    main = cases["linked_4m"]
    chain = (chain_err, _cuda_ms(torch, lambda: decode_chains(main), 5),
             _cuda_ms(torch, lambda: decode_chains_plain(main), 1, False))
    print(f"phase 5: chain_decode linked_4m: kernel {chain[1]:.3f} ms "
          f"({main.out_total / chain[1] / 1e3:.1f} MB/s), plain "
          f"{chain[2]:.1f} ms {tag}")

    # the main-path batch (the 64 MiB corpus at 256 KB, as phase 6 decodes
    # it), then a dictionary batch
    wire_err, timed = 0, None
    for x, dic in ((corpus, None), (data, d)):
        entries = _frame_entries(frame(x, 256 * 1024, True, dic))
        w, recs, counts, _, hist = parse_wire_batch(entries, 256 * 1024, dic)
        args_ = [torch.from_numpy(a).to(dev) for a in (w, recs, counts)]
        args_ += [256 * 1024,
                  None if hist is None else torch.from_numpy(hist).to(dev)]
        name = f"wire_decode {len(entries)} x 256 KB" + \
            (" dictionary" if dic is not None else "")
        wire_err = max(wire_err, _compare(
            torch, name, decode_blocks_wire(*args_),
            decode_blocks_wire_plain(*args_), tag))
        if timed is None:
            timed, timed_name = args_, name
    wire = (wire_err, _cuda_ms(torch, lambda: decode_blocks_wire(*timed), 5),
            _cuda_ms(torch, lambda: decode_blocks_wire_plain(*timed), 1,
                     False))
    print(f"phase 5: {timed_name}: kernel {wire[1]:.3f} ms "
          f"({len(corpus) / wire[1] / 1e3:.1f} MB/s), plain {wire[2]:.1f} "
          f"ms {tag}")
    return chain, wire


def _roundtrip(pt, lz4, corpus, cfg, dev, reps):
    """Encode and decode *corpus* *reps* times; checks and returns (frame,
    encode seconds, decode seconds)."""
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
    if np.asarray(lz4.decompress(frame)).tobytes() != corpus.tobytes():
        raise AssertionError(f"{cfg}: host C++ decode of the port's frame "
                             "differs")
    return frame, t_enc, t_dec


def _phase6(torch, pt, lz4, dev, corpus, tag):
    """The default frame at 64 MiB, then the other block routes once.
    Returns the launch counts of chain_decode (default frame) and
    wire_decode (256 KB blocks)."""
    from divortio_lz4_tpu.config import FrameConfig
    from divortio_lz4_tpu_torch.ops.compact_decode import decode_blocks_compact
    from divortio_lz4_tpu_torch.ops.wave_decode import decode_chains
    from divortio_lz4_tpu_torch.ops.wire_decode import decode_blocks_wire

    n = len(corpus)
    cfg = FrameConfig(content_checksum=True)
    host = np.asarray(lz4.compress(corpus, config=cfg))
    _roundtrip(pt, lz4, corpus, cfg, dev, 1)          # warm-up
    decode_chains.launches = 0
    frame, t_enc, t_dec = _roundtrip(pt, lz4, corpus, cfg, dev, 3)
    chain_launches = decode_chains.launches
    if chain_launches < 1:
        raise AssertionError("the default frame never launched chain_decode")
    enc_s, dec_s = statistics.median(t_enc), statistics.median(t_dec)
    print(f"phase 6: default frame (4 MB linked) 64 MiB, {len(frame)} B, "
          f"ratio vs host encoder {len(frame) / len(host):.4f} "
          f"({len(host)} B); round trip exact, host-decodable; "
          f"chain_decode launches {chain_launches} {tag}")
    print(f"phase 6: default frame: encode {n / enc_s / 1e6:.1f} MB/s, "
          f"decode {n / dec_s / 1e6:.1f} MB/s (median of 3; enc {t_enc}, "
          f"dec {t_dec} s) {tag}")
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
        frame, t_enc, t_dec = _roundtrip(pt, lz4, corpus, c, dev, 1)
        counts[label] = counters[kernel].launches
        if counts[label] < 1:
            raise AssertionError(f"{label} never launched {kernel}")
        print(f"phase 6: {label} 64 MiB, {len(frame)} B: exact, "
              f"host-decodable; encode {n / t_enc[0] / 1e6:.1f} MB/s, decode "
              f"{n / t_dec[0] / 1e6:.1f} MB/s; {kernel} launches "
              f"{counts[label]} {tag}")
    return chain_launches, counts["independent 256 KB"]


def _phase7(torch, pt, lz4, dev, corpus, d, tag):
    """Default-config frames in flight, and a mixed batch in one call."""
    from divortio_lz4_tpu.config import FrameConfig
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
    for (x, c), f, o in zip(mixed, frames, outs):
        if o.tobytes() != x.tobytes():
            raise AssertionError(f"mixed batch: {c} differs")
        if np.asarray(lz4.decompress(f, dictionary=d)).tobytes() \
                != x.tobytes():
            raise AssertionError(f"mixed batch: host decode of {c} differs")
    print(f"phase 7: mixed batch (64 KB, 256 KB independent; 4 MB linked; "
          f"dictionary) exact in one decompress_frames call {tag}")
    peak = torch.cuda.max_memory_allocated() / MIB
    print(f"phase 7: peak device memory {peak:.0f} MiB {tag}")


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
    import divortio_lz4_tpu as lz4
    if not lz4.NATIVE_AVAILABLE:
        raise RuntimeError("divortio_lz4_tpu.NATIVE_AVAILABLE is False: the "
                           "native host tier did not build (g++)")
    import divortio_lz4_tpu_torch as pt
    from divortio_lz4_tpu_torch import _build
    from divortio_lz4_tpu_torch.ops.compact_decode import (
        decode_blocks_compact, decode_blocks_compact_plain)
    from divortio_lz4_tpu.config import FrameConfig
    from bench import build_corpus

    t0 = time.perf_counter()
    sources = ("compact_decode", "chain_decode")
    with ThreadPoolExecutor(len(sources)) as ex:   # one nvcc per source
        list(ex.map(_build.library_path, sources))
    build_s = time.perf_counter() - t0
    print(f"phase 1: built csrc/{{{','.join(sources)}}}.cu for sm_90a in "
          f"{build_s:.2f} s {tag}")
    for name in sources:
        for line in _build.build_log(name).splitlines():
            if any(k in line for k in ("Compiling entry", "registers",
                                       "spill")):
                print(f"phase 1: {name}: ptxas: {line.strip()}")

    # -- phase 2: kernel vs plain ----------------------------------------
    corpus = build_corpus(64 * MIB, args.seed)
    cfg = FrameConfig(block_size=65536, block_independence=True,
                      content_checksum=True)
    host_frame = np.asarray(lz4.compress(corpus, config=cfg))
    rng = np.random.default_rng(args.seed)
    d = np.array(corpus[3 * MIB: 3 * MIB + 32768])
    dict_frame = np.asarray(lz4.compress(corpus[:4 * MIB], config=cfg,
                                         dictionary=d))
    dense = [np.asarray(lz4.compress_raw(rng.integers(0, 4, 65536)
                                         .astype(np.uint8)))
             for _ in range(32)]
    cases = {
        "main": _batch(_frame_entries(host_frame), None, dev),
        "dense": _batch([(c, False) for c in dense], None, dev),
        "dict": _batch(_frame_entries(dict_frame), d, dev),
    }
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
        want = decode_blocks_compact_plain(*args_)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        max_err = max(max_err, err)
        if err:
            bad = (got != want).any(1).nonzero().flatten().tolist()
            raise AssertionError(f"{name}: kernel != plain in rows {bad[:8]}")
        outs[name] = got
        print(f"phase 2: {name}: {b.wire.shape[0]} blocks, <= {max_recs} "
              f"records/block, kernel == plain byte for byte {tag}")
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
        p_ms = _cuda_ms(torch, lambda: decode_blocks_compact_plain(*args_),
                        1)
        timing[name] = (k_ms, p_ms)
        mb = int(b.out_lens.sum()) / 1e6
        print(f"phase 2: {name}: kernel {k_ms:.3f} ms ({mb / k_ms:.1f} "
              f"GB/s of output), plain {p_ms:.1f} ms {tag}")

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
    if np.asarray(lz4.decompress(frame)).tobytes() != corpus_b:
        raise AssertionError("host C++ decode of the port's frame differs")
    if len(frame) >= len(corpus):
        raise AssertionError("the 64 MiB frame is not smaller than its input")
    n = len(corpus)
    enc_s, dec_s = statistics.median(t_enc), statistics.median(t_dec)
    print(f"phase 3: 64 MiB frame, {len(frame)} B, ratio vs host encoder "
          f"{len(frame) / len(host_frame):.4f} ({len(host_frame)} B); "
          f"round trip exact, host-decodable; compact_decode launches "
          f"{launches} {tag}")
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
    if np.asarray(lz4.decompress(frames[15], dictionary=d)).tobytes() \
            != datas[15].tobytes():
        raise AssertionError("host decode of the dictionary frame differs")
    print(f"phase 4: 16 x 4 MiB frames (1 block-checksum, 1 dictionary) "
          f"exact; encode {n / (t1 - t0) / 1e6:.1f} MB/s, decode "
          f"{n / (t2 - t1) / 1e6:.1f} MB/s {tag}")
    peak = torch.cuda.max_memory_allocated() / MIB
    print(f"phase 4: peak device memory {peak:.0f} MiB {tag}")

    chain, wire = _phase5(torch, dev, corpus, args.seed, tag)
    chain_launches, wire_launches = _phase6(torch, pt, lz4, dev, corpus,
                                            tag)
    _phase7(torch, pt, lz4, dev, corpus, d, tag)

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    k_ms, p_ms = timing["main"]
    src = "divortio_lz4_tpu_torch/csrc/"
    print(json.dumps({"kernels": [
        {"name": "compact_decode", "route": "cuda",
         "source": src + "compact_decode.cu",
         "replaces": "divortio_lz4_tpu/ops/pallas_split_decode.py:689",
         "launches": launches, "max_abs_err": max_err,
         "ms": k_ms, "plain_ms": p_ms},
        {"name": "chain_decode", "route": "cuda",
         "source": src + "chain_decode.cu",
         "replaces": "divortio_lz4_tpu/ops/wave_decode.py:60",
         "launches": chain_launches, "max_abs_err": chain[0],
         "ms": chain[1], "plain_ms": chain[2]},
        {"name": "wire_decode", "route": "cuda",
         "source": src + "chain_decode.cu",
         "replaces": "divortio_lz4_tpu/ops/pallas_split_decode.py:565",
         "launches": wire_launches, "max_abs_err": wire[0],
         "ms": wire[1], "plain_ms": wire[2]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
