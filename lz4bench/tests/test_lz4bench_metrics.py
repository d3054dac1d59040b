"""The frozen kernel byte counts, the trace reduction, the import guard,
and a traced cell on the card."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from lz4bench.corpus import make_corpus
from lz4bench.metrics import _bytes, _trace
from lz4bench.reference.frame import frame_blocks, parse_blocks, read_frame

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _count(frame):
    fr = read_frame(frame.tobytes())
    c, st, sz, so = frame_blocks(frame.tobytes(), fr, "cpu")
    seq = parse_blocks(c, st, sz, so, [])
    return fr, sz, int(_bytes.records_per_block(seq, len(sz)).sum())


@pytest.fixture(scope="module")
def data():
    c = make_corpus(21, 1 << 20)
    # text and records, a zero run (offset-1 matches), a short period
    # (offsets under 128), and a tail too short to compress
    return np.concatenate([c[:250_000], np.zeros(70_000, np.uint8),
                           np.tile(np.arange(7, dtype=np.uint8), 3000),
                           c[600_000:600_009]])


@pytest.mark.parametrize("cfg", [
    dict(block_size=65536, block_independence=True, content_checksum=True,
         content_size=False),
    dict(block_size=65536, block_independence=True)])
def test_compact_decode_count_is_the_kernels_arguments(data, cfg):
    import divortio_lz4_tpu_torch as pt
    from divortio_lz4_tpu_torch.ops.split_decode import (
        from_reference_records, parse_wire_raw)
    from divortio_lz4_tpu_torch.parallel.device import parse_block_index

    f = pt.compress_frame(data, pt.FrameConfig(**cfg), engine="split",
                          device="cpu")
    fr, sizes, n_rec = _count(f)
    assert _bytes.route(fr.independent, fr.block_max) == "compact_decode"
    _, blocks, _ = parse_block_index(f, True)
    entries = [(f[o: o + s], t) for o, s, t in blocks]
    wire, recs_l, _, out_lens, hist = parse_wire_raw(entries, 65536, None)
    b = from_reference_records(wire, recs_l, out_lens, hist, "cpu")
    args = (sum(len(e) for e, _ in entries) + b.rec_words.numel() * 4
            + b.rec_off.numel() * 8 + b.out_lens.numel() * 8
            + int(out_lens.sum()))
    assert _bytes.compact_decode_bytes(sizes, n_rec, len(data)) == args


@pytest.mark.parametrize("cfg", [
    dict(), dict(block_size=65536), dict(block_size=262144),
    dict(block_size=1 << 20, block_independence=True)])
def test_chain_decode_count_is_the_kernels_arguments(data, cfg):
    import divortio_lz4_tpu_torch as pt
    from divortio_lz4_tpu_torch.ops.wave_decode import stage_chains
    from divortio_lz4_tpu_torch.parallel.device import parse_block_index

    f = pt.compress_frame(data, pt.FrameConfig(**cfg), engine="split",
                          device="cpu")
    fr, sizes, n_rec = _count(f)
    assert _bytes.route(fr.independent, fr.block_max) == "chain_decode"
    header, blocks, _ = parse_block_index(f, True)
    b = stage_chains(f, blocks, header, None, "cpu")
    args = sum(x.numel() * x.element_size() for x in b[:6]
               if x is not None) + b.out_total
    assert _bytes.chain_decode_bytes(sizes, n_rec, len(data),
                                     fr.independent) == args


def _events():
    ms = 1_000_000
    return [
        ("lz4bench.compress", "user_annotation", False, 0, 10 * ms),
        # device-side copies of ranges: the benchmark's, and one the
        # program could add, which is no device work either
        ("lz4bench.compress", "gpu_user_annotation", True, 0, 10 * ms),
        ("split_encode.serialize", "gpu_user_annotation", True, 5 * ms,
         8 * ms),
        ("aten::copy_", "cpu_op", False, 1 * ms, 2 * ms),
        ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", True, 1 * ms,
         2 * ms),
        ("void (anonymous namespace)::resolve::round_kernel(int*, long)",
         "kernel", True, 3 * ms, 5 * ms),
        ("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", True, 8 * ms,
         9 * ms),
        ("lz4bench.decompress", "user_annotation", False, 10 * ms, 20 * ms),
        ("void (anonymous namespace)::compact_groups_kernel<true>(Blocks)",
         "kernel", True, 12 * ms, 13 * ms),
        ("compact_decode.records", "gpu_user_annotation", True, 11 * ms,
         19 * ms),
        ("cudaDeviceSynchronize", "cuda_runtime", False, 14 * ms, 19 * ms),
    ]


def test_trace_reduction():
    t = _trace.from_events(_events())
    assert [c.name for c in t.calls] == ["compress", "decompress"]
    assert [d.kind for d in t.device] == ["memcpy", "kernel", "memcpy",
                                          "kernel"]
    assert (t.start, t.end) == (0, 20_000_000)
    assert _trace.idle_pct(t, "compress") == pytest.approx(60.0)
    assert _trace.idle_pct(t, "decompress") == pytest.approx(90.0)
    assert _trace.copy_pct(t, "compress") == pytest.approx(20.0)
    assert _trace.copy_pct(t, "decompress") == 0.0
    assert _trace.kernel_ns(t, {"compact_groups_kernel"}, "decompress") \
        == 1_000_000
    assert _trace.kernel_ns(t, {"resolve::round_kernel"}, "decompress") == 0
    assert _trace.busy_s(t) == pytest.approx(0.005)
    b = _trace.breakdown(t)
    assert b["device_ops"][0] == ["void (anonymous namespace)::resolve::"
                                  "round_kernel(int*, long)", 0.002]
    # the longest gap is named by the innermost host op over its middle
    assert b["idle_gaps"][0] == ["cudaDeviceSynchronize", 0.007]
    assert b["idle_gaps"][1] == ["lz4bench.compress", 0.003]
    assert len(b["idle_gaps"]) == 5


class _OldEvent:
    """A profiler event of a torch that gives no activity type."""

    def __init__(self, name, annotation):
        self._name, self._annotation = name, annotation

    def name(self):
        return self._name

    def is_user_annotation(self):
        return self._annotation


@pytest.mark.parametrize("name,annotation,on_device,want", [
    ("lz4bench.compress", True, True, "gpu_user_annotation"),
    ("split_encode.serialize", True, True, "gpu_user_annotation"),
    ("lz4bench.compress", True, False, "user_annotation"),
    ("Memcpy DtoH (Device -> Pageable)", False, True, "gpu_memcpy"),
    ("Memset (Device)", False, True, "gpu_memset"),
    ("void compact_groups_kernel<true>(Blocks)", False, True, "kernel"),
    ("aten::copy_", False, False, "cpu_op")])
def test_activity_without_the_profilers_type(name, annotation, on_device,
                                             want):
    assert _trace.activity(_OldEvent(name, annotation), on_device) == want


def test_no_calls_no_reading():
    t = _trace.from_events([])
    assert _trace.idle_pct(t, "compress") is None
    assert _trace.copy_pct(None, "compress") is None


_GUARD = """
import sys, json, time
sys.path.insert(0, {root!r})
from lz4bench import run
bench = run.load_json({bench!r})
res, lines, _ = run.run_cell(bench, "cli64k.bulk", 5, 0.1, False,
                             device="cpu", scale=1024, t0=time.perf_counter())
found = run.forbidden_modules()
sys.modules["jax.numpy"] = sys.modules["json"]
print(json.dumps([found, run.forbidden_modules(), res["correct"]]))
"""


def test_a_module_loaded_after_the_window_stops_the_result(monkeypatch,
                                                           capsys):
    """A module the run may not load, loaded after the window (here by a
    stand-in for the checks and readers), leaves no result line."""
    import torch

    from lz4bench import run

    def late_import(*args, **kwargs):
        monkeypatch.setitem(sys.modules, "jax", sys.modules["json"])
        return {"correct": True}, [], None

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "run_cell", late_import)
    rc = run.main(["--workload", "cli64k.bulk", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == ""
    assert "jax" in err


def test_a_run_loads_no_jax():
    code = _GUARD.format(root=ROOT, bench=os.path.join(ROOT,
                                                       "BENCHMARK.json"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    found, planted, correct = json.loads(res.stdout.strip().splitlines()[-1])
    assert found == [] and planted == ["jax"] and correct


def test_the_harness_imports_no_jax_by_name():
    import ast

    bad = []
    for base, _, files in os.walk(os.path.join(ROOT, "lz4bench")):
        for f in files:
            if not f.endswith(".py") or "tests" in base:
                continue
            tree = ast.parse(open(os.path.join(base, f)).read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module \
                        and node.level == 0:
                    names = [node.module]
                bad += [(f, n) for n in names if n.split(".")[0] in
                        ("jax", "jaxlib", "flax", "divortio_lz4_tpu",
                         "bench", "benchmark")]
    assert bad == []


@pytest.mark.cuda
def test_traced_cell_on_the_card(card):
    from lz4bench import run

    bench = run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    for name in ("cli64k.bulk", "libdefault4m.bulk"):
        res, _, _ = run.run_cell(bench, name, 17, 1.0, True, scale=16)
        assert res["correct"]
        m = {k: v["value"] for k, v in res["metrics"].items()}
        for k in ("device_idle_pct.compress", "device_idle_pct.decompress",
                  "copy_pct.compress", "copy_pct.decompress"):
            assert 0.0 <= m[k] <= 100.0
        roof = [v for k, v in m.items() if k.endswith("_roofline")]
        assert len(roof) == 1 and 0.0 < roof[0] < 105.0
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
