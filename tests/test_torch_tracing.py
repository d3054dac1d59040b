"""The port's spans and copy counters (divortio_lz4_tpu_torch/tracing.py).

With no profiler recording, a span never reaches ``record_function`` and
nothing is counted. Under ``torch.profiler`` a CPU round trip in the two
benchmark deployments' frame settings (lz4bench/configs) opens every span
of its route as a ``lz4t.*`` range, nested under its root and all on the
calling thread, and the counters equal the bytes of the arrays uploaded
and fetched, worked out from their shapes, the history columns among the
uploads, the blocks of the frame decoded and spliced, the records the
compact staging packed, and the chains staged.
"""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import divortio_lz4_tpu_torch as pt
from _torch_port import cuda, mixed_payload, one_torch_thread  # noqa: F401
from divortio_lz4_tpu_torch import tracing
from divortio_lz4_tpu_torch.ops.split_decode import (build_flat_records,
                                                     parse_wire_raw)
from divortio_lz4_tpu_torch.ops.wave_decode import (build_chain_arrays,
                                                    plan_blocks)
from divortio_lz4_tpu_torch.parallel.bigblock import SEG, history_rows
from divortio_lz4_tpu_torch.parallel.device import parse_block_index
from lz4bench.metrics import _trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 100_000
DEPLOYMENTS = ("cli64k", "libdefault4m", "pylz4default")

# Each span of the route with the span it opens under.
TREE = {
    "cli64k": {
        "compress": {"encode.rows": "compress_frames",
                     "encode.chains": "compress_frames",
                     "frame.put": "encode.chains",
                     "frame.fetch": "compress_frames",
                     "encode.serialize": "compress_frames",
                     "frame.assemble": "compress_frames",
                     "frame.xxh32": "frame.assemble"},
        "decompress": {"frame.index": "decompress_frames",
                       "decode.parse": "decompress_frames",
                       "decode.records": "decompress_frames",
                       "frame.put": "decompress_frames",
                       "decode.kernel": "decompress_frames",
                       "frame.fetch": "decompress_frames",
                       "frame.join": "decompress_frames",
                       "frame.xxh32": "decompress_frames"}},
    "libdefault4m": {
        "compress": {"encode.rows": "compress_frames",
                     "encode.chains": "compress_frames",
                     "frame.put": "encode.chains",
                     "frame.fetch": "compress_frames",
                     "encode.serialize": "compress_frames",
                     "encode.splice": "compress_frames",
                     "frame.assemble": "compress_frames"},
        "decompress": {"frame.index": "decompress_frames",
                       "decode.parse": "decompress_frames",
                       "decode.records": "decompress_frames",
                       "frame.put": "decompress_frames",
                       "decode.kernel": "decompress_frames",
                       "frame.fetch": "decompress_frames",
                       "frame.join": "decompress_frames"}},
    "pylz4default": {
        "compress": {"encode.rows": "compress_frames",
                     "encode.history": "encode.rows",
                     "encode.chains": "compress_frames",
                     "frame.put": "encode.chains",
                     "frame.fetch": "compress_frames",
                     "encode.serialize": "compress_frames",
                     "frame.assemble": "compress_frames"},
        "decompress": {"frame.index": "decompress_frames",
                       "decode.parse": "decompress_frames",
                       "decode.records": "decompress_frames",
                       "frame.put": "decompress_frames",
                       "decode.kernel": "decompress_frames",
                       "frame.fetch": "decompress_frames",
                       "frame.join": "decompress_frames"}},
}


# The counters of each root: the copies, the history columns among the
# compress uploads, the blocks decoded, on the big-block compress the
# plaintext that the splice's boundary extension compared and the blocks
# spliced, on the compact route (64 KB independent blocks) the records its
# native staging packed, and on the chain route (linked frames) the
# records whose words it packed and the chains it staged.
ENCODE = {"h2d_bytes", "d2h_bytes", "hist_h2d_bytes"}
DECODE = {"h2d_bytes", "d2h_bytes", "decode_blocks"}
CHAIN = DECODE | {"chain_records", "decode_chains"}
COUNTERS = {
    "cli64k": {"compress_frames": ENCODE,
               "decompress_frames": DECODE | {"compact_records"}},
    "libdefault4m": {"compress_frames": ENCODE | {"splice_cmp_bytes",
                                                  "splice_blocks"},
                     "decompress_frames": CHAIN},
    "pylz4default": {"compress_frames": ENCODE,
                     "decompress_frames": CHAIN}}


def _config(name):
    with open(os.path.join(REPO, "lz4bench", "configs", name + ".json")) as f:
        return pt.FrameConfig(**json.load(f)["frame"])


def _traced_round_trip(cfg, data):
    """compress then decompress *data* under a CPU profile, each call in a
    benchmark range. Returns (frame, the profile)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("lz4bench.compress"):
            frame = pt.compress_frame(data, cfg, device="cpu")
        with record_function("lz4bench.decompress"):
            out = pt.decompress_frame(frame, device="cpu")
    np.testing.assert_array_equal(out, data)
    return frame, prof


def _parents(spans):
    """{span: the name of the innermost span that encloses it, or None}."""
    got = {}
    for s in spans:
        outer = [p for p in spans if p is not s
                 and p.start <= s.start and s.end <= p.end]
        got[s] = min(outer, key=lambda p: p.end - p.start).name \
            if outer else None
    return got


def test_untraced_calls_open_no_range_and_count_nothing(monkeypatch,
                                                        one_torch_thread):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function reached with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    tracing.reset()
    assert tracing.span("encode.rows") is tracing.span("frame.put")
    data = mixed_payload(SIZE, 3)
    for name in DEPLOYMENTS:
        cfg = _config(name)
        out = pt.decompress_frame(pt.compress_frame(data, cfg, device="cpu"),
                                  device="cpu")
        np.testing.assert_array_equal(out, data)
    assert tracing.counters() == {}


@pytest.mark.parametrize("name", DEPLOYMENTS)
def test_spans_nest_under_their_root_on_the_calling_thread(
        name, one_torch_thread):
    _, prof = _traced_round_trip(_config(name), mixed_payload(SIZE, 5))
    events = list(prof.profiler.kineto_results.events())
    threads = {e.start_thread_id() for e in events
               if e.name().startswith(("lz4t.", "lz4bench."))}
    assert len(threads) == 1
    trace = _trace.from_profile(prof)
    spans = [h for h in trace.host if h.name.startswith("lz4t.")]
    calls = [_trace.Span("lz4bench." + c.name, c.start, c.end)
             for c in trace.calls]
    parents = _parents(spans + calls)
    assert [c.name for c in calls] == ["lz4bench.compress",
                                       "lz4bench.decompress"]
    assert all(parents[s] is not None for s in spans)
    for call in calls:
        kind = call.name[len("lz4bench."):]
        want = {("lz4t." + k, "lz4t." + v)
                for k, v in TREE[name][kind].items()}
        want.add(("lz4t." + kind + "_frames", call.name))
        assert {(s.name, parents[s]) for s in spans
                if call.start <= s.start and s.end <= call.end} == want


def _padded(n):
    return -(-n // 8) * 8


def _expected_bytes(name, data, frame):
    """The counters of each direction, worked out from the arrays that the
    route uploads and fetches and from the frame's blocks."""
    n = len(data)
    header, blocks, _ = parse_block_index(frame, True)
    if name == "libdefault4m":
        lens = history_rows(data, 4194304, SEG, None, True).lens
        rows, hist = len(lens), 65536
    elif name == "pylz4default":
        rows, hist = -(-n // 65536), 65536
    else:
        rows, hist = -(-n // 65536), 0
    # rows u8[rows, hist + 64 KB] ([history | payload]), lengths and
    # history starts as i64; chains u16[rows, 64 KB]
    up_c = rows * (hist + 65536) + 2 * 8 * rows
    down_c = _padded(rows * 65536 * 2)
    encode = {"h2d_bytes": up_c, "d2h_bytes": down_c,
              "hist_h2d_bytes": rows * hist}
    if name == "libdefault4m":
        encode["splice_blocks"] = len(blocks)
    decode = {"decode_blocks": len(blocks)}
    if name == "cli64k":
        entries = [(frame[o: o + s], st) for o, s, st in blocks]
        wire, recs_l, _, out_lens, _ = parse_wire_raw(entries, 65536, None)
        words, rec_off = build_flat_records(recs_l)
        up_d = wire.nbytes + words.nbytes + rec_off.nbytes + out_lens.nbytes
        decode["compact_records"] = int(rec_off[-1])
    else:
        out_lens, recs_l = plan_blocks(frame, blocks, header, None)
        arrays = build_chain_arrays(frame, blocks, False, out_lens, recs_l)
        up_d = sum(a.nbytes for a in arrays)
        decode["chain_records"] = int(arrays[3][-1])
        decode["decode_chains"] = 1         # a linked frame is one chain
    down_d = _padded(-(-n // 65536) * 65536 if name == "cli64k" else n)
    return {"compress_frames": encode,
            "decompress_frames": {"h2d_bytes": up_d, "d2h_bytes": down_d,
                                  **decode}}


@pytest.mark.parametrize("name", DEPLOYMENTS)
def test_copy_counters_are_the_arrays_bytes(name, one_torch_thread):
    data = mixed_payload(SIZE + 3, 7)
    tracing.reset()
    frame, _ = _traced_round_trip(_config(name), data)
    got = tracing.counters()
    tracing.reset()
    assert {root: set(c) for root, c in got.items()} == COUNTERS[name]
    for root, want in _expected_bytes(name, data, frame).items():
        for key, n in want.items():
            assert got[root][key] == n
    assert got["decompress_frames"]["d2h_bytes"] % 8 == 0


@pytest.mark.parametrize("name", ["cli64k", "pylz4default"])
def test_compact_records_count_the_staged_records(name, one_torch_thread):
    """``compact_records`` counts the records of a 64 KB independent
    frame's native staging (rec_off[-1]) only while a profiler records; a
    linked frame takes the chain route and counts none."""
    data = mixed_payload(SIZE + 3, 11)
    frame = pt.compress_frame(data, _config(name), device="cpu")
    tracing.reset()
    pt.decompress_frame(frame, device="cpu")
    assert tracing.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        out = pt.decompress_frame(frame, device="cpu")
    got = tracing.counters()["decompress_frames"]
    tracing.reset()
    np.testing.assert_array_equal(out, data)
    if name == "pylz4default":
        assert "compact_records" not in got
        return
    _, blocks, _ = parse_block_index(frame, True)
    _, recs_l, _, _, _ = parse_wire_raw(
        [(frame[o: o + s], st) for o, s, st in blocks], 65536, None)
    assert got["compact_records"] == \
        int(build_flat_records(recs_l)[1][-1]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", DEPLOYMENTS)
def test_chain_kernel_rows_count_the_cards_rows(name, cuda):
    """On the card every chain row goes through the CUDA builder, which
    counts it (``chain_kernel_rows``; on the CPU the counter is absent,
    test_copy_counters_are_the_arrays_bytes)."""
    data = mixed_payload(SIZE + 3, 7)
    cfg = _config(name)
    rows = -(-len(data) // 65536)        # 64 KB rows on every route
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        frame = pt.compress_frame(data, cfg, device=cuda)
    got = tracing.counters()
    tracing.reset()
    assert got["compress_frames"]["chain_kernel_rows"] == rows
    out = pt.decompress_frame(frame, device=cuda)
    np.testing.assert_array_equal(out, data)
