"""What decides ``correct`` fails where it must: each configuration's
controls (the program's own paths that break a stated guarantee), and a
run whose timed path is broken underneath, once for each fault a codec
cell can have. Driven on the CPU, at a size a test run can hold; the
chip runs the controls at the cells' own sizes with
``python3 -m lz4bench ... --control <name>``."""

import os

import numpy as np
import pytest

from lz4bench import run, traffic

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
CELLS = ["cli64k.bulk", "libdefault4m.bulk"]


def _run(cell, codec=None, control=None, seed=2**31 + 9):
    res, _, _ = run.run_cell(BENCH, cell, seed, 0.1, False,
                                 device="cpu", codec=codec, scale=256,
                                 control=control)
    return res["correct"], {k: v["value"] for k, v in res["checks"].items()}


def _codec(cell):
    _, conf, _ = run.cell_of(BENCH, cell)
    return run.PortCodec(conf["frame"], conf["engine"], "cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    ok, numbers = _run(cell)
    assert ok and not any(numbers.values())


@pytest.mark.parametrize("cell,control", [
    ("cli64k.bulk", "linked_blocks"), ("cli64k.bulk", "no_content_checksum"),
    ("libdefault4m.bulk", "no_content_size"),
    ("libdefault4m.bulk", "blocks_64k")])
def test_each_control_is_not_correct(cell, control):
    ok, numbers = _run(cell, control=control)
    assert not ok
    # the program decodes its own frames right: only the plain reference's
    # look at the stated settings catches the control
    assert numbers["frame_faults"] >= 1
    assert numbers["wrong_answers"] == numbers["failed_calls"] == 0


class _Broken:
    """The port with a fault planted in the timed path: the warm-up's
    round trips, one of each size of the deck, go through unharmed."""

    def __init__(self, inner, fault, cell):
        _, _, mix = run.cell_of(BENCH, cell)
        self.warm = len(np.unique(traffic.deck_sizes(mix)))
        self.inner, self.fault, self.calls = inner, fault, 0

    def compress(self, data):
        f = self.inner.compress(data)
        if self.fault == "token" and self.calls >= self.warm:
            f = f.copy()
            flg = f[4]
            head = 7 + 8 * ((flg >> 3) & 1) + 4 * (flg & 1)
            f[head + 4] ^= 0x40     # the first block's first token
        return f

    def decompress(self, frame):
        self.calls += 1
        if self.calls <= self.warm:
            return self.inner.decompress(frame)
        if self.fault == "unchanged":
            return np.asarray(frame)        # the state handed back as is
        out = self.inner.decompress(frame)
        if self.fault == "half":
            return out[: len(out) // 2]     # half of the answer left out
        if self.fault == "answer":
            out = out.copy()
            out[len(out) // 3] ^= 0x01
        return out


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half", "answer", "token"])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    ok, numbers = _run(cell, codec=_Broken(_codec(cell), fault, cell))
    assert not ok
    assert numbers["wrong_answers"] + numbers["failed_calls"] \
        + numbers["reference_mismatch"] >= 1
