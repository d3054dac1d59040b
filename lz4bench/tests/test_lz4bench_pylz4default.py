"""The python-lz4 default configuration (``pylz4default``: 64 KB linked
blocks, content size) in the harness: its frames under the plain
reference, its controls and planted faults against ``correct``, the three
readers of its linked route on a hand-built trace and on a profile
recorded on the CPU, and its cell traced on the card."""

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
CELL = "pylz4default.bulk"
NEW = ["history_pct.compress", "history_h2d_per_byte.compress",
       "decode_host_us_per_block.decompress"]
# the span shares of each direction, which tile the calls' wall time
COMPRESS_SHARES = ["chain_build_pct.compress", "history_pct.compress",
                   "serialize_pct.compress", "splice_pct.compress",
                   "frame_host_pct.compress", "device_wait_pct.compress"]
DECOMPRESS_SHARES = ["decode_host_pct.decompress",
                     "frame_host_pct.decompress",
                     "device_wait_pct.decompress"]
MS = 1_000_000


def _frame_settings():
    _, conf, _ = run.cell_of(BENCH, CELL)
    return conf["frame"]


@pytest.mark.parametrize("codec", ["host", "split"])
def test_port_frames_decode_exactly(codec):
    import divortio_lz4_tpu_torch as pt

    frame = _frame_settings()
    cfg = pt.FrameConfig(**frame)
    c = make_corpus(3, 1 << 20)
    for data in (c[:300_000], c[5000:6500], np.zeros(200_000, np.uint8)):
        f = pt.compress(data, config=cfg) if codec == "host" else \
            pt.compress_frame(data, cfg, engine="split", device="cpu")
        out, fr = decode_frame(np.asarray(f).tobytes())
        assert out.tobytes() == data.tobytes()
        assert fr.faults == [] and checks.stated_faults(fr, frame) == []


def test_a_sound_run_is_correct():
    ok, numbers = _run(CELL)
    assert ok and not any(numbers.values())


@pytest.mark.parametrize("control", ["independent_blocks",
                                     "no_content_size"])
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


def _events(history=True):
    """A compress call (0-100 ms) whose rows step holds the history build,
    and a decompress call (100-200 ms) with its decode steps."""
    ev = [_host("lz4bench.compress", 0, 100),
          _host("lz4t.compress_frames", 2, 98),
          _host("lz4t.encode.rows", 4, 30),
          _host("lz4t.encode.chains", 30, 50),
          _host("lz4t.frame.put", 32, 40),
          _host("lz4t.encode.serialize", 50, 90),
          _host("lz4bench.decompress", 100, 200),
          _host("lz4t.decompress_frames", 101, 199),
          _host("lz4t.decode.parse", 105, 140),
          _host("lz4t.decode.parse", 110, 120),
          _host("lz4t.decode.records", 140, 170),
          _host("lz4t.frame.put", 150, 152),
          _host("lz4t.decode.kernel", 170, 175),
          _host("lz4bench.compress", 300, 400)]
    if history:
        ev.append(_host("lz4t.encode.history", 6, 24))
    return ev


def _fake_run(events):
    rec = types.SimpleNamespace
    return types.SimpleNamespace(
        trace=_trace.from_events(events),
        records=[rec(size=1500, t_decompress=0.1),
                 rec(size=2500, t_decompress=None)])


def _counters(monkeypatch, got):
    from divortio_lz4_tpu_torch import tracing

    monkeypatch.setattr(tracing, "counters", lambda: got)


def test_the_readers_read_their_span_and_counters(monkeypatch):
    _counters(monkeypatch, {
        "compress_frames": {"h2d_bytes": 9000, "hist_h2d_bytes": 4200},
        "decompress_frames": {"decode_blocks": 4}})
    got = {name: run.reader(name).read(_fake_run(_events()))
           for name in NEW}
    # history: 18 ms of the 200 ms of compress calls (the second call
    # has no spans); the history bytes over every compress call's
    # plaintext; decode: 35 + 30 - 2 + 5 ms of self time over 4 blocks
    assert got == pytest.approx({
        "history_pct.compress": 9.0,
        "history_h2d_per_byte.compress": 4200 / 4000,
        "decode_host_us_per_block.decompress": 68_000 / 4})
    # the history build is taken out of the rows step's self time
    assert run.reader("chain_build_pct.compress").read(
        _fake_run(_events())) == pytest.approx((26 - 18 + 20 - 8) / 2)


def test_no_span_or_counter_no_reading(monkeypatch):
    # a program without encode.history or the new counters: the parent
    # of this configuration's cell, whose other spans and copies are there
    _counters(monkeypatch, {"compress_frames": {"h2d_bytes": 9000},
                            "decompress_frames": {"h2d_bytes": 100}})
    fake = _fake_run(_events(history=False))
    assert [run.reader(n).read(fake) for n in NEW] == [None] * 3
    no_trace = types.SimpleNamespace(trace=None, records=fake.records)
    _counters(monkeypatch, {"compress_frames": {"hist_h2d_bytes": 1},
                            "decompress_frames": {"decode_blocks": 1}})
    assert run.reader(NEW[0]).read(no_trace) is None
    assert run.reader(NEW[2]).read(no_trace) is None


def test_no_counters_module_no_reading(monkeypatch):
    import sys

    import divortio_lz4_tpu_torch

    _counters(monkeypatch, {"compress_frames": {"hist_h2d_bytes": 1},
                            "decompress_frames": {"decode_blocks": 1}})
    fake = _fake_run(_events())
    assert None not in [run.reader(n).read(fake) for n in NEW[1:]]
    monkeypatch.delattr(divortio_lz4_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "divortio_lz4_tpu_torch.tracing", None)
    assert [run.reader(n).read(fake) for n in NEW[1:]] == [None, None]


def _rows(size):
    return -(-size // 65536)


def test_a_recorded_profile_reports_the_readers():
    """The cell traced on the CPU at 1/256 of its sizes: the readers find
    the port's span and counters in a real profile, the history bytes are
    64 KB a block and the decoded blocks those of the frames."""
    from divortio_lz4_tpu_torch import tracing

    tracing.reset()
    res, _, rn = run.run_cell(BENCH, CELL, 2**31 + 41, 0.1, True,
                              device="cpu", scale=256)
    got = tracing.counters()
    tracing.reset()
    assert res["correct"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(m) == set(NEW)
    sizes = [r.size for r in rn.records]
    assert got["decompress_frames"]["decode_blocks"] == \
        sum(_rows(s) for s in sizes)
    assert m["history_h2d_per_byte.compress"] == pytest.approx(
        sum(65536 * _rows(s) for s in sizes) / sum(sizes))
    assert 0.0 < m["history_pct.compress"] < 100.0
    assert m["decode_host_us_per_block.decompress"] > 0.0


@pytest.mark.cuda
def test_traced_cell_on_the_card(card):
    from divortio_lz4_tpu_torch import tracing

    tracing.reset()
    res, _, rn = run.run_cell(BENCH, CELL, 2**31 + 43, 1.0, True, scale=16)
    got = tracing.counters()
    tracing.reset()
    assert res["correct"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(m) == set(NEW)
    sizes = [r.size for r in rn.records]
    assert got["decompress_frames"]["decode_blocks"] == \
        sum(_rows(s) for s in sizes)
    assert m["history_h2d_per_byte.compress"] == pytest.approx(
        sum(65536 * _rows(s) for s in sizes) / sum(sizes))
    assert 0.0 < m["history_pct.compress"] < 100.0
    assert 0.0 < m["decode_host_us_per_block.decompress"] < 1e5
    # the older readers run on this cell's trace all the same: the span
    # shares still tile each direction's calls
    shares = {k: run.reader(k).read(rn)
              for k in COMPRESS_SHARES + DECOMPRESS_SHARES}
    assert sum(shares[k] for k in COMPRESS_SHARES) >= 97.0
    assert sum(shares[k] for k in DECOMPRESS_SHARES) >= 97.0
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
