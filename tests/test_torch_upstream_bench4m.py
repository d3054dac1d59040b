"""The upstream benchmark's frame on the split engine (4 MB independent
blocks, the content size; lz4bench/configs/upstream-bench4m.json).

The split encoder splices each block's 64 KB segments with matches that
never reach before the block, and the decoder stages one chain a block
for the chain kernel. The plain reference of the benchmark decodes each
block without history, the stated settings hold, the port decodes its own
frame, and the counters ``splice_blocks`` and ``decode_chains`` count one
a block, the short last block included.
"""

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

import divortio_lz4_tpu_torch as pt
from _torch_port import one_torch_thread  # noqa: F401
from divortio_lz4_tpu_torch import tracing
from divortio_lz4_tpu_torch.ops.wave_decode import stage_chains
from divortio_lz4_tpu_torch.parallel.device import parse_block_index
from lz4bench import checks
from lz4bench.corpus import make_corpus
from lz4bench.reference.frame import decode_frame

BS = 4 << 20
FRAME = {"block_size": BS, "block_independence": True,
         "content_checksum": False, "content_size": True,
         "block_checksums": False}


def _counted(root, name, call):
    """Run *call* under a CPU profile; the total of counter *name* under
    *root*, and what *call* returned."""
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        got = call()
    n = tracing.counters().get(root, {}).get(name)
    tracing.reset()
    return n, got


@pytest.mark.parametrize("size,blocks", [(BS + 12345, 2), (40_000, 1)],
                         ids=["two_blocks", "short"])
def test_independent_4m_frame_decodes_block_by_block(size, blocks,
                                                     one_torch_thread):
    data = make_corpus(11, 8 << 20)[777: 777 + size]
    spliced, frame = _counted(
        "compress_frames", "splice_blocks",
        lambda: pt.compress_frame(data, pt.FrameConfig(**FRAME),
                                  engine="split", device="cpu"))
    frame = np.asarray(frame)
    out, fr = decode_frame(frame.tobytes())
    assert fr.faults == [] and checks.stated_faults(fr, FRAME) == []
    assert len(fr.blocks) == blocks
    np.testing.assert_array_equal(out, data)
    np.testing.assert_array_equal(
        pt.decompress_frame(frame, engine="split", device="cpu"), data)
    # the decode's staging of the same frame, under its root as in
    # decompress_frame (whose plain chain decode is left out of the
    # profile: its events take longer to read back than the decode)
    header, index, _ = parse_block_index(frame, True)

    def stage():
        with tracing.span("decompress_frames"):
            return stage_chains(frame, index, header, None, "cpu")

    chains, batch = _counted("decompress_frames", "decode_chains", stage)
    assert spliced == chains == len(index) == blocks
    assert batch.out_total == size
