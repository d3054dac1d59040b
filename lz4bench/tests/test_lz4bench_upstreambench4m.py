"""The upstream benchmark's configuration (``upstream-bench4m``: 4 MB
independent blocks, content size) in the harness: its frames under the
plain reference, its controls and planted faults against ``correct``, the
two readers of its chain route and splice on a hand-built trace and on a
profile recorded on the CPU, and its cell traced on the card."""

import os
import types

import numpy as np
import pytest

from lz4bench import checks, run
from lz4bench.corpus import make_corpus
from lz4bench.metrics import _trace
from lz4bench.reference.frame import decode_frame
from lz4bench.tests.test_lz4bench_control import _Broken, _codec, _run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
CELL = "upstream-bench4m.bulk"
NEW = ["decode_host_us_per_chain.decompress", "splice_us_per_block.compress"]
BS = 4 << 20
MS = 1_000_000


def _frame_settings():
    _, conf, _ = run.cell_of(BENCH, CELL)
    return conf["frame"]


def _blocks(size):
    return max(1, -(-size // BS))


@pytest.mark.parametrize("codec", ["host", "split"])
def test_port_frames_decode_exactly(codec):
    import divortio_lz4_tpu_torch as pt

    frame = _frame_settings()
    cfg = pt.FrameConfig(**frame)
    c = make_corpus(3, 1 << 20)
    payloads = [c[:300_000], c[5000:6500], np.zeros(200_000, np.uint8)]
    if codec == "host":
        # two blocks, the second one short: each decodes without the other
        payloads.append(make_corpus(5, 8 << 20)[: BS + 12345])
    for data in payloads:
        f = pt.compress(data, config=cfg) if codec == "host" else \
            pt.compress_frame(data, cfg, engine="split", device="cpu")
        out, fr = decode_frame(np.asarray(f).tobytes())
        assert out.tobytes() == data.tobytes()
        assert fr.faults == [] and checks.stated_faults(fr, frame) == []


def test_a_sound_run_is_correct():
    ok, numbers = _run(CELL)
    assert ok and not any(numbers.values())


@pytest.mark.parametrize("control", ["linked_blocks", "no_content_size"])
def test_each_control_is_not_correct(control):
    ok, numbers = _run(CELL, control=control)
    assert not ok
    assert numbers["frame_faults"] >= 1
    assert numbers["wrong_answers"] == numbers["failed_calls"] == 0


@pytest.mark.parametrize("fault", ["unchanged", "half", "answer", "token"])
def test_a_broken_timed_path_is_not_correct(fault):
    ok, numbers = _run(CELL, codec=_Broken(_codec(CELL), fault, CELL))
    assert not ok
    assert numbers["wrong_answers"] + numbers["failed_calls"] \
        + numbers["reference_mismatch"] >= 1


def _host(name, s, e):
    return (name, "user_annotation", False, s * MS, e * MS)


def _events():
    """A compress call (0-100 ms) with its splice, and a decompress call
    (100-200 ms) with its decode steps."""
    return [_host("lz4bench.compress", 0, 100),
            _host("lz4t.compress_frames", 2, 98),
            _host("lz4t.encode.rows", 4, 30),
            _host("lz4t.encode.chains", 30, 50),
            _host("lz4t.frame.put", 32, 40),
            _host("lz4t.encode.serialize", 50, 70),
            _host("lz4bench.decompress", 100, 200),
            _host("lz4t.decompress_frames", 101, 199),
            _host("lz4t.decode.parse", 105, 140),
            _host("lz4t.decode.parse", 110, 120),
            _host("lz4t.decode.records", 140, 170),
            _host("lz4t.frame.put", 150, 152),
            _host("lz4t.decode.kernel", 170, 175),
            _host("lz4t.encode.splice", 70, 94),
            _host("lz4t.frame.put", 90, 92),
            _host("lz4bench.compress", 300, 400)]


def _fake_run(events):
    rec = types.SimpleNamespace
    return types.SimpleNamespace(
        trace=_trace.from_events(events),
        records=[rec(size=1500, t_decompress=0.1),
                 rec(size=2500, t_decompress=None)])


def _counters(monkeypatch, got):
    from divortio_lz4_tpu_torch import tracing

    monkeypatch.setattr(tracing, "counters", lambda: got)


def test_the_readers_read_their_spans_and_counters(monkeypatch):
    _counters(monkeypatch, {
        "compress_frames": {"h2d_bytes": 9000, "splice_blocks": 3},
        "decompress_frames": {"decode_blocks": 4, "decode_chains": 2}})
    got = {name: run.reader(name).read(_fake_run(_events()))
           for name in NEW}
    # decode: 35 + 30 - 2 + 5 ms of self time over 2 chains; splice:
    # 24 - 2 ms of self time over 3 blocks
    assert got == pytest.approx({
        "decode_host_us_per_chain.decompress": 68_000 / 2,
        "splice_us_per_block.compress": 22_000 / 3})


def test_no_span_or_counter_no_reading(monkeypatch):
    # a program without the two counters: the parent of this
    # configuration's cell, whose spans and copies are there
    fake = _fake_run(_events())
    _counters(monkeypatch, {"compress_frames": {"h2d_bytes": 9000},
                            "decompress_frames": {"decode_blocks": 4}})
    assert [run.reader(n).read(fake) for n in NEW] == [None, None]
    # counters at 0: no chain staged, no block spliced
    _counters(monkeypatch, {"compress_frames": {"splice_blocks": 0},
                            "decompress_frames": {"decode_chains": 0}})
    assert [run.reader(n).read(fake) for n in NEW] == [None, None]
    # no trace
    _counters(monkeypatch, {"compress_frames": {"splice_blocks": 1},
                            "decompress_frames": {"decode_chains": 1}})
    no_trace = types.SimpleNamespace(trace=None, records=fake.records)
    assert [run.reader(n).read(no_trace) for n in NEW] == [None, None]


def test_no_counters_module_no_reading(monkeypatch):
    import sys

    import divortio_lz4_tpu_torch

    _counters(monkeypatch, {"compress_frames": {"splice_blocks": 1},
                            "decompress_frames": {"decode_chains": 1}})
    fake = _fake_run(_events())
    assert None not in [run.reader(n).read(fake) for n in NEW]
    monkeypatch.delattr(divortio_lz4_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "divortio_lz4_tpu_torch.tracing", None)
    assert [run.reader(n).read(fake) for n in NEW] == [None, None]


def test_a_recorded_profile_reports_the_readers():
    """The cell traced on the CPU at 1/256 of its sizes: the readers find
    the port's spans and counters in a real profile, one chain and one
    spliced block a frame."""
    from divortio_lz4_tpu_torch import tracing

    tracing.reset()
    res, _, rn = run.run_cell(BENCH, CELL, 2**31 + 45, 0.1, True,
                              device="cpu", scale=256)
    got = tracing.counters()
    tracing.reset()
    assert res["correct"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(m) == set(NEW)
    blocks = sum(_blocks(r.size) for r in rn.records)
    assert got["decompress_frames"]["decode_chains"] == \
        got["decompress_frames"]["decode_blocks"] == blocks
    assert got["compress_frames"]["splice_blocks"] == blocks
    assert m["decode_host_us_per_chain.decompress"] > 0.0
    assert m["splice_us_per_block.compress"] > 0.0


@pytest.mark.cuda
def test_traced_cell_on_the_card(card):
    """At 1/4 of the cell's sizes (1.3-12.8 MB) most frames hold several
    blocks, so the chain route stages several chains a frame."""
    from divortio_lz4_tpu_torch import tracing

    tracing.reset()
    res, _, rn = run.run_cell(BENCH, CELL, 2**31 + 47, 1.0, True, scale=4)
    got = tracing.counters()
    tracing.reset()
    assert res["correct"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(m) == set(NEW)
    blocks = sum(_blocks(r.size) for r in rn.records)
    assert blocks > len(rn.records)
    assert got["decompress_frames"]["decode_chains"] == \
        got["decompress_frames"]["decode_blocks"] == blocks
    assert got["compress_frames"]["splice_blocks"] == blocks
    assert 0.0 < m["decode_host_us_per_chain.decompress"] < 1e6
    assert 0.0 < m["splice_us_per_block.compress"] < 1e6
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
