"""Run one cell of the port's benchmark once and print its result line.

    python3 -m lz4bench --workload cli64k.bulk --seed 7 --seconds 20 --trace 0

The cell's configuration, traffic mix and metrics are found by name from
``BENCHMARK.json`` at the root of the checkout:

- ``lz4bench/configs/<config>.json``: the frame settings and engine;
- ``lz4bench/traffic/<traffic>.json``: the mix, read by ``traffic.py``;
- ``lz4bench/metrics/<metric>.py``: one reader a metric, ``read(run)``.

A run: set up (torch and CUDA, the port's libraries, the seeded corpus,
one warm-up request of each of the cell's sizes); the timed window (one
caller, each request compressed into its own frame, then decompressed,
deck after deck until a deck ends after ``--seconds``, so every run does
whole decks of the same work); the checks (every answer against its
payload, one frame of every request of the deck through the plain
reference, ``checks.py``); the metrics; a last look for modules the run
may not load; the result line. ``--trace 1`` runs the
window under ``torch.profiler``, for whole decks up to ``TRACE_SECONDS``,
and reports the per-layer metrics.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from typing import Optional  # noqa: E402

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from lz4bench import checks, traffic  # noqa: E402
from lz4bench.corpus import make_corpus  # noqa: E402
from lz4bench.metrics import _trace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "divortio_lz4_tpu")
# A traced run traces whole decks for this long at most: the profile of a
# longer window takes minutes to read back.
TRACE_SECONDS = 10.0


@dataclass
class Record:
    """One request of the window."""
    offset: int
    size: int
    frame: Optional[np.ndarray] = None
    out: Optional[np.ndarray] = None
    t_compress: float = 0.0
    t_decompress: Optional[float] = None
    error: Optional[str] = None


@dataclass
class Run:
    """What the metric readers read."""
    records: list
    setup_s: float
    device: object
    trace: object = None       # the traced run's profile: all its records
    hbm_bytes_per_s: Optional[float] = None


class PortCodec:
    """The system under test: the port's one-frame entry points."""

    def __init__(self, frame: dict, engine: str, device):
        import divortio_lz4_tpu_torch as pt

        self.pt = pt
        self.config = pt.FrameConfig(**frame)
        self.engine = engine
        self.device = device

    def compress(self, data) -> np.ndarray:
        return self.pt.compress_frame(data, self.config, engine=self.engine,
                                      device=self.device)

    def decompress(self, frame) -> np.ndarray:
        return self.pt.decompress_frame(frame, engine=self.engine,
                                        device=self.device)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_of(bench: dict, name: str):
    """(workload entry, configuration file, traffic mix) of a cell."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return cell, load_json(os.path.join(ROOT, conf["file"])), \
        traffic.load(cell["traffic"])


def metrics_of(bench: dict, cell: dict, per_layer: bool) -> list:
    """The cell's metric entries: its end-to-end metrics, or with a trace
    its per-layer ones."""
    pool = bench["per_layer" if per_layer else "end_to_end"]
    return [m for m in pool
            if "workloads" not in m or cell["name"] in m["workloads"]]


def reader(name: str):
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"lz4bench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    mod.__package__ = "lz4bench.metrics"
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def window(codec, corpus, decks, seconds: float, marks: bool) -> list:
    """The timed window: requests one after another, deck after deck,
    until a deck ends after *seconds* have passed. *marks* wraps every
    call in a profiler range."""
    from torch.profiler import record_function

    def mark(name):
        return record_function(name) if marks else contextlib.nullcontext()

    records = []
    end = time.perf_counter() + seconds
    reqs = iter(())
    while True:
        req = next(reqs, None)
        if req is None:
            if time.perf_counter() >= end:
                break
            reqs = iter(next(decks))
            continue
        rec = Record(req.offset, req.size)
        payload = corpus[req.offset: req.offset + req.size]
        with mark("lz4bench.compress"):
            t = time.perf_counter()
            try:
                rec.frame = codec.compress(payload)
            except Exception as e:   # a failed call is counted, not fatal
                rec.error = f"compress: {e!r}"
            rec.t_compress = time.perf_counter() - t
        if rec.frame is not None:
            with mark("lz4bench.decompress"):
                t = time.perf_counter()
                try:
                    rec.out = codec.decompress(rec.frame)
                except Exception as e:
                    rec.error = f"decompress: {e!r}"
                rec.t_decompress = time.perf_counter() - t
        records.append(rec)
    return records


def judge(records, corpus, frame: dict, budget: int, seed: int,
          device) -> dict:
    """The numbers that decide ``correct`` (checks.py)."""
    from lz4bench.reference.frame import decode_frame

    numbers = dict.fromkeys(checks.LIMITS, 0)
    for rec in records:
        if rec.error is not None:
            numbers["failed_calls"] += 1
        elif not np.array_equal(rec.out,
                                corpus[rec.offset: rec.offset + rec.size]):
            numbers["wrong_answers"] += 1
    done = [r for r in records if r.frame is not None]
    decode, checksum = traffic.check_sample(
        [(r.offset, r.size) for r in done], budget, seed)
    for i in decode:
        rec = done[i]
        payload = corpus[rec.offset: rec.offset + rec.size]
        out, fr = decode_frame(rec.frame.tobytes(), device,
                               verify_content=i in checksum)
        if out is None or not np.array_equal(out, payload):
            numbers["reference_mismatch"] += 1
        faults = fr.faults + checks.stated_faults(fr, frame) \
            if fr.version else fr.faults
        if faults:
            numbers["frame_faults"] += 1
            print(f"frame fault, request of {rec.size} B: "
                  f"{'; '.join(faults)}", file=sys.stderr)
    return numbers


def power_limit() -> Optional[str]:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 \
        and res.stdout.strip() else None


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool,
             device="cuda", codec=None, scale: int = 1,
             control: Optional[str] = None, t0: float = T0):
    """One run of cell *name*. Returns (result dict, check lines, the Run
    with the window's records). The tests pass *device* "cpu", a faulty
    *codec* and a *scale* that divides every byte count of the mix."""
    import torch

    cell, conf, mix = cell_of(bench, name)
    if scale != 1:
        mix = traffic.scaled(mix, scale)
    frame = dict(conf["frame"])
    if control is not None:
        frame.update(conf["controls"][control]["frame"])
    dev = torch.device(device)
    if codec is None:
        codec = PortCodec(frame, conf["engine"], dev)
    corpus = make_corpus(seed, mix["corpus_bytes"])
    # warm-up: one round trip of each size the cell's deck holds, so the
    # allocator holds what the window's sizes need
    for size in np.unique(traffic.deck_sizes(mix)).tolist():
        codec.decompress(codec.compress(corpus[:size]))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    stream = traffic.decks(mix, seed)
    gc.collect()
    run = Run([], time.perf_counter() - t0, dev)
    t_window = time.perf_counter()
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            run.records = window(codec, corpus, stream,
                                 min(seconds, TRACE_SECONDS), True)
        run.trace = _trace.from_profile(prof)
    else:
        run.records = window(codec, corpus, stream, seconds, False)
    t_checks = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    numbers = judge(run.records, corpus, conf["frame"],
                    mix["checksum_bytes"], seed, dev)
    t_metrics = time.perf_counter()
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    peaks = load_json(os.path.join(HERE, "peaks.json"))
    run.hbm_bytes_per_s = peaks.get(kind, {}).get("hbm_bytes_per_s")
    values = {}
    for m in metrics_of(bench, cell, trace):
        v = reader(m["name"]).read(run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    attempted = len(run.records)
    failed = numbers["failed_calls"] + numbers["wrong_answers"]
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": kind, "count": 1, "memory_peak_bytes": int(peak)}
    if dev.type == "cuda":
        device_info["power_limit"] = power_limit()
    result = {"correct": checks.verdict(numbers, attempted),
              "attempted": attempted, "failed": failed, "metrics": values,
              "device": device_info}
    if trace:
        device_info["busy_s"] = _trace.busy_s(run.trace)
        device_info["window_s"] = (run.trace.end - run.trace.start) / 1e9
        result["breakdown"] = _trace.breakdown(run.trace)
    result["checks"] = checks.as_json(numbers)
    print(f"lz4bench: set-up {run.setup_s:.2f} s, window "
          f"{t_checks - t_window:.2f} s, checks {t_metrics - t_checks:.2f} s, "
          f"metrics {time.perf_counter() - t_metrics:.2f} s", file=sys.stderr)
    return result, checks.lines(numbers), run


def parse_args(argv):
    p = argparse.ArgumentParser(prog="python3 -m lz4bench",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", default=None,
                   help="run a control of the cell's configuration (its "
                        "file's 'controls') in the program's place; the "
                        "benchmark's own runs never do")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell, _, _ = cell_of(bench, args.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark measures the port on the "
              "card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} CUDA devices, "
              f"{torch.cuda.device_count()} seen", file=sys.stderr)
        return 2
    result, lines, _ = run_cell(bench, args.workload, args.seed,
                                args.seconds, bool(args.trace),
                                control=args.control)
    # the last look, after the checks and the metric readers have run
    found = forbidden_modules()
    if found:
        print(f"lz4bench: modules loaded that the run may not load: "
              f"{', '.join(found)}", file=sys.stderr)
        return 1
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
