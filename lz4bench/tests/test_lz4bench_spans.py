"""The readers of the port's spans and copy counters: self time on a
hand-built trace, nesting, spans partly outside a call, no reading without
the spans or the counters' module, and a traced cell on the card."""

import os
import sys
import types

import pytest

from lz4bench.metrics import _spans, _trace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MS = 1_000_000
SPAN_READERS = ["chain_build_pct.compress", "serialize_pct.compress",
                "splice_pct.compress", "decode_host_pct.decompress",
                "frame_host_pct.compress", "frame_host_pct.decompress",
                "device_wait_pct.compress", "device_wait_pct.decompress"]
COUNT_READERS = ["copy_bytes_per_byte.compress",
                 "copy_bytes_per_byte.decompress"]
COMPRESS_SHARES = ["chain_build_pct.compress", "serialize_pct.compress",
                   "splice_pct.compress", "frame_host_pct.compress",
                   "device_wait_pct.compress"]
DECOMPRESS_SHARES = ["decode_host_pct.decompress",
                     "frame_host_pct.decompress",
                     "device_wait_pct.decompress"]


def _host(name, s, e):
    return (name, "user_annotation", False, s * MS, e * MS)


def _events():
    """A compress call (0-100 ms) and a decompress call (100-200 ms), each
    with its root span and steps; a benchmark range from another source
    and a device kernel, neither of which is a port span."""
    return [
        _host("lz4bench.compress", 0, 100),
        _host("lz4t.compress_frames", 2, 98),
        _host("lz4t.encode.rows", 4, 10),
        _host("lz4t.encode.chains", 10, 30),
        _host("lz4t.frame.put", 12, 16),
        _host("lz4t.frame.put", 20, 28),
        _host("aten::copy_", 21, 27),
        _host("lz4t.frame.fetch", 30, 50),
        _host("lz4t.encode.serialize", 50, 70),
        _host("lz4t.encode.splice", 70, 80),
        _host("lz4t.frame.assemble", 80, 96),
        _host("lz4t.frame.xxh32", 90, 95),
        ("kernel_a", "kernel", True, 31 * MS, 49 * MS),
        _host("lz4bench.decompress", 100, 200),
        _host("lz4t.decompress_frames", 101, 199),
        _host("lz4t.frame.index", 101, 105),
        _host("lz4t.decode.parse", 105, 140),
        _host("lz4t.decode.records", 140, 150),
        _host("lz4t.frame.put", 150, 152),
        _host("lz4t.decode.kernel", 152, 160),
        _host("lz4t.frame.fetch", 160, 170),
        _host("lz4t.frame.join", 170, 190),
        _host("lz4t.frame.xxh32", 190, 198),
    ]


def _run(events, records=()):
    return types.SimpleNamespace(trace=_trace.from_events(events),
                                 records=list(records))


def _read(name, run):
    from lz4bench import run as harness

    return harness.reader(name).read(run)


def test_self_time_leaves_out_the_children():
    own = _spans.self_intervals(
        _spans.port_spans(_trace.from_events(_events())))
    assert own["encode.chains"] == [(10 * MS, 12 * MS), (16 * MS, 20 * MS),
                                    (28 * MS, 30 * MS)]
    assert own["frame.assemble"] == [(80 * MS, 90 * MS), (95 * MS, 96 * MS)]
    assert own["frame.put"] == [(12 * MS, 16 * MS), (20 * MS, 28 * MS),
                                (150 * MS, 152 * MS)]
    # the root's own time: before, between and after its steps
    assert own["compress_frames"] == [(2 * MS, 4 * MS), (96 * MS, 98 * MS)]
    assert sum(e - s for s, e in own["decompress_frames"]) == 1 * MS
    # a host op that is not a port span takes nothing from its parent
    assert "aten::copy_" not in own


def test_each_reader_reads_its_spans():
    run = _run(_events())
    got = {name: _read(name, run) for name in SPAN_READERS}
    assert got == pytest.approx({
        "chain_build_pct.compress": 6 + 8,
        "serialize_pct.compress": 20,
        "splice_pct.compress": 10,
        "frame_host_pct.compress": 4 + 11 + 5,
        "device_wait_pct.compress": 12 + 20,
        "decode_host_pct.decompress": 35 + 10 + 8,
        "frame_host_pct.decompress": 1 + 4 + 20 + 8,
        "device_wait_pct.decompress": 2 + 10})
    # the spans tile the root, so the shares sum to the root's share of
    # the calls' wall time
    assert sum(got[k] for k in COMPRESS_SHARES) == pytest.approx(96)
    assert sum(got[k] for k in DECOMPRESS_SHARES) == pytest.approx(98)


def test_a_span_partly_outside_its_call_counts_inside_only():
    events = [_host("lz4bench.compress", 0, 100),
              _host("lz4t.compress_frames", 0, 100),
              _host("lz4t.encode.serialize", 90, 120),
              _host("lz4t.encode.serialize", 130, 140),
              _host("lz4bench.decompress", 200, 300)]
    assert _read("serialize_pct.compress", _run(events)) \
        == pytest.approx(10)
    # a direction without calls gives no reading
    assert _spans.self_pct(_trace.from_events(events[:4]), "decompress",
                           ("decode.parse",)) is None


def test_nested_spans_of_one_name_are_counted_once():
    events = [_host("lz4bench.decompress", 0, 100),
              _host("lz4t.decompress_frames", 0, 100),
              _host("lz4t.decode.parse", 10, 60),
              _host("lz4t.decode.parse", 20, 30),
              _host("lz4t.decode.records", 40, 50)]
    assert _read("decode_host_pct.decompress", _run(events)) \
        == pytest.approx(50)


@pytest.mark.parametrize("name", SPAN_READERS)
def test_no_port_spans_no_reading(name):
    events = [e for e in _events() if not e[0].startswith("lz4t.")]
    assert _read(name, _run(events)) is None
    assert _read(name, types.SimpleNamespace(trace=None, records=[])) \
        is None


def _records():
    rec = types.SimpleNamespace
    return [rec(size=1000, t_decompress=0.1), rec(size=3000,
                                                    t_decompress=None)]


def test_copy_bytes_per_byte_reads_each_directions_counters(monkeypatch):
    from divortio_lz4_tpu_torch import tracing

    monkeypatch.setattr(tracing, "counters", lambda: {
        "compress_frames": {"h2d_bytes": 6000, "d2h_bytes": 2000},
        "decompress_frames": {"h2d_bytes": 1500}})
    run = _run(_events(), _records())
    assert _read("copy_bytes_per_byte.compress", run) == pytest.approx(2.0)
    # only calls that were decompressed count as plaintext
    assert _read("copy_bytes_per_byte.decompress", run) \
        == pytest.approx(1.5)
    monkeypatch.setattr(tracing, "counters", lambda: {})
    for name in COUNT_READERS:
        assert _read(name, run) is None


@pytest.mark.parametrize("name", COUNT_READERS)
def test_no_counters_module_no_reading(name, monkeypatch):
    import divortio_lz4_tpu_torch
    from divortio_lz4_tpu_torch import tracing

    monkeypatch.setattr(tracing, "counters", lambda: {
        root: {"h2d_bytes": 1} for root in _spans.ROOT.values()})
    run = _run(_events(), _records())
    assert _read(name, run) is not None
    # a program without the module
    monkeypatch.delattr(divortio_lz4_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "divortio_lz4_tpu_torch.tracing", None)
    assert _read(name, run) is None


@pytest.mark.cuda
def test_traced_cells_read_the_port_spans(card):
    from divortio_lz4_tpu_torch import tracing
    from lz4bench import run

    bench = run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    for name in ("cli64k.bulk", "libdefault4m.bulk"):
        tracing.reset()
        res, _, _ = run.run_cell(bench, name, 2**31 + 29, 1.0, True,
                                 scale=16)
        assert res["correct"]
        m = {k: v["value"] for k, v in res["metrics"].items()}
        shares = [k for k in SPAN_READERS if k in m]
        assert set(SPAN_READERS) - set(shares) == (
            {"splice_pct.compress"} if name == "cli64k.bulk" else set())
        for k in shares:
            assert 0.0 <= m[k] <= 100.0, (k, m[k])
        assert sum(m.get(k, 0.0) for k in COMPRESS_SHARES) >= 97.0
        assert sum(m[k] for k in DECOMPRESS_SHARES) >= 97.0
        for k in COUNT_READERS:
            assert 1.0 <= m[k] <= 10.0, (k, m[k])
        gaps = [g for g, _ in res["breakdown"]["idle_gaps"]]
        assert not {"lz4bench.compress", "lz4bench.decompress"} & set(gaps)
