"""Command-line interface: a spec-compliant .lz4 file codec.

    python -m divortio_lz4_tpu_torch compress   <in> [-o out.lz4] [options]
    python -m divortio_lz4_tpu_torch decompress <in.lz4> [-o out] [options]

A port of ``divortio_lz4_tpu/__main__.py`` with its flags and its output
files. ``-`` is stdin/stdout. Without ``--device`` a file is piped through
the port's ``CompressStream`` / ``DecompressStream`` at their default
``backend="device"`` (bursts of full blocks on the card, the rest on the
host block codec). Its frames are JAX's ``CompressStream(...,
backend="device")`` frames fed the same 4 MiB chunks. Where no burst runs
(blocks over 64 KB, or ``-D``) those are JAX CLI's host-stream bytes; at
blocks of up to 64 KB without ``-D`` the bursts' chain encoder writes
other valid bytes than JAX's CLI, and each CLI decodes the other's files.
``--device`` runs the one-shot device codec (``compress_frame`` /
``decompress_frame``) with ``--engine``.

One flag of its own: ``--torch-device`` (default "cuda"), the torch device
of every device path; pass "cpu" on a machine without a GPU, where "cuda"
raises RuntimeError instead of carrying on on the CPU. JAX's ``bench``
subcommand is not ported yet: ``bench.py`` has no tiers for the port.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="divortio_lz4_tpu_torch",
        epilog="The JAX package's 'bench' subcommand is not in this CLI yet: "
               "bench.py has no tiers for the port.")
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("compress", help="compress a file to an LZ4 frame")
    c.add_argument("input")
    c.add_argument("-o", "--output", default=None)
    c.add_argument("-b", "--block-size", type=int, default=4194304)
    c.add_argument("--independent", action="store_true",
                   help="block-independent frame (parallel decode)")
    c.add_argument("--checksum", action="store_true",
                   help="append a content checksum")
    c.add_argument("--block-checksums", action="store_true")
    c.add_argument("-D", "--dictionary", default=None)
    c.add_argument("--device", action="store_true",
                   help="run the one-shot device codec (compress_frame)")
    c.add_argument("--engine", default="split",
                   choices=["split", "hybrid", "pallas", "xla"],
                   help="device engine (with --device)")

    d = sub.add_parser("decompress", help="decompress an LZ4 frame file")
    d.add_argument("input")
    d.add_argument("-o", "--output", default=None)
    d.add_argument("-D", "--dictionary", default=None)
    d.add_argument("--no-verify", action="store_true")
    d.add_argument("--device", action="store_true",
                   help="run the one-shot device codec (decompress_frame)")
    d.add_argument("--engine", default="split",
                   choices=["split", "pallas", "xla"],
                   help="device engine (with --device)")

    for p in (c, d):
        p.add_argument("--torch-device", default="cuda",
                       help="torch device of the device paths (default "
                            "cuda; cpu runs the kernels' plain versions)")

    args = ap.parse_args(argv)

    import numpy as np

    from .config import FrameConfig
    from .stream import CompressStream, DecompressStream

    def _stream_io(in_path, out_path, stream):
        """Pipe in->out through a transform stream; '-' = stdin/stdout."""
        fin = sys.stdin.buffer if in_path == "-" else open(in_path, "rb")
        fout = sys.stdout.buffer if out_path == "-" else open(out_path, "wb")
        total_in = total_out = 0
        try:
            while True:
                chunk = fin.read(1 << 22)
                if not chunk:
                    break
                total_in += len(chunk)
                out = stream.write(chunk)
                total_out += len(out)
                fout.write(out)
            tail = stream.flush()
            total_out += len(tail)
            fout.write(tail)
        finally:
            if in_path != "-":
                fin.close()
            if out_path != "-":
                fout.close()
            else:
                fout.flush()
        return total_in, total_out

    dictionary = None
    if args.dictionary:
        with open(args.dictionary, "rb") as f:
            dictionary = np.frombuffer(f.read(), np.uint8)

    t0 = time.perf_counter()
    if args.cmd == "compress":
        out_path = args.output or (
            "-" if args.input == "-" else args.input + ".lz4")
        cfg = FrameConfig(block_size=args.block_size,
                          block_independence=args.independent,
                          content_checksum=args.checksum,
                          block_checksums=args.block_checksums)
        if args.device:
            from .parallel.device import compress_frame
            with open(args.input, "rb") as f:
                data = np.frombuffer(f.read(), np.uint8)
            # Kept from the JAX CLI: --device compress always writes an
            # independent frame, and it ignores -D.
            frame = compress_frame(
                data, cfg.with_(block_independence=True),
                engine=args.engine, device=args.torch_device)
            with open(out_path, "wb") as f:
                f.write(bytes(frame))
            in_size, out_size = len(data), len(frame)
        else:
            in_size, out_size = _stream_io(
                args.input, out_path,
                CompressStream(cfg, dictionary, device=args.torch_device))
        dt = time.perf_counter() - t0
        print(f"{args.input}: {in_size} -> {out_size} bytes "
              f"({in_size / max(out_size, 1):.2f}x) in {dt * 1e3:.1f} ms "
              f"({in_size / dt / 1e6:.0f} MB/s)", file=sys.stderr)
    else:
        out_path = args.output or (
            "-" if args.input == "-"
            else args.input[:-4] if args.input.endswith(".lz4")
            else args.input + ".out")
        if args.device:
            from .parallel.device import decompress_frame
            with open(args.input, "rb") as f:
                data = np.frombuffer(f.read(), np.uint8)
            # Kept from the JAX CLI: --device decompress ignores -D.
            plain = decompress_frame(data, not args.no_verify,
                                     engine=args.engine,
                                     device=args.torch_device)
            with open(out_path, "wb") as f:
                f.write(bytes(plain))
            in_size, out_size = len(data), len(plain)
        else:
            in_size, out_size = _stream_io(
                args.input, out_path,
                DecompressStream(dictionary, not args.no_verify,
                                 device=args.torch_device))
        dt = time.perf_counter() - t0
        print(f"{args.input}: {in_size} -> {out_size} bytes in "
              f"{dt * 1e3:.1f} ms ({out_size / dt / 1e6:.0f} MB/s)",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
