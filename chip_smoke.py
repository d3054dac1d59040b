#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (divortio_lz4_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printed on its own line:

1. Device and build: the card's name and power limit (nvidia-smi), the
   nvcc build of csrc/compact_decode.cu from this checkout, the native
   host tier.
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

Then a JSON line describing the kernel, and last the device line. Any
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

import numpy as np

MIB = 1 << 20


def _card() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def _cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds per call of fn() over *reps* calls (CUDA events,
    after one warm-up call)."""
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
    _build.load_library("compact_decode")
    build_s = time.perf_counter() - t0
    print(f"phase 1: built csrc/compact_decode.cu for sm_90a in "
          f"{build_s:.2f} s {tag}")
    for line in _build.build_log("compact_decode").splitlines():
        if "registers" in line or "spill" in line:
            print(f"phase 1: ptxas: {line.strip()}")

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

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    k_ms, p_ms = timing["main"]
    print(json.dumps({"kernels": [{
        "name": "compact_decode", "route": "cuda",
        "source": "divortio_lz4_tpu_torch/csrc/compact_decode.cu",
        "replaces": "divortio_lz4_tpu/ops/pallas_split_decode.py:689",
        "launches": launches, "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
