"""The seeded corpus and the traffic generator: same seed, same bytes;
the stated shares; the bulk deck's Silesia sizes; the log-normal law's
median, tail and clip; the reference's sample."""

import json
import math
import os
import zlib
from statistics import NormalDist

import numpy as np
import pytest

from lz4bench import corpus, traffic

SIZE = 256 * 1024 * 4          # 1 MiB: 4 KiB segments


def test_same_seed_same_bytes_other_seed_other_bytes():
    a = corpus.make_corpus(2**31 + 5, SIZE)
    assert np.array_equal(a, corpus.make_corpus(2**31 + 5, SIZE))
    b = corpus.make_corpus(2**31 + 6, SIZE)
    assert (a != b).mean() > 0.5


def test_every_quarter_holds_the_stated_shares():
    kinds = corpus.segment_kinds()
    assert len(kinds) == corpus.SEGMENTS
    q = corpus.SEGMENTS_PER_QUARTER
    assert sum(corpus.SHARES.values()) == q
    for i in range(4):
        part = kinds[i * q: (i + 1) * q]
        assert {k: part.count(k) for k in corpus.SHARES} == corpus.SHARES


def test_segments_are_of_their_kind():
    seg = SIZE // corpus.SEGMENTS
    data = corpus.make_corpus(9, SIZE)
    kinds = corpus.segment_kinds()

    def ratio(i):
        s = data[i * seg: (i + 1) * seg].tobytes()
        return len(zlib.compress(s, 6)) / len(s), s

    for i, kind in enumerate(kinds):
        r, s = ratio(i)
        if kind == "random":
            assert r > 0.98
        elif kind == "runs":
            assert r < 0.1
        elif kind == "json":
            lines = s.split(b"\n")[1:-1]
            assert lines and all(json.loads(x)["path"].startswith("/v1/")
                                 for x in lines)
        elif kind in ("text", "source"):
            assert all(32 <= c < 127 or c == 10 for c in s)
            assert r < 0.7
        else:
            assert 0.3 < r < 0.95


def test_the_models_do_not_change_with_the_seed():
    # the ratio of a kind's bytes is a property of its model, not of the
    # seed: the seed may not change the work
    for maker in (corpus.natural_text, corpus.source_text,
                  corpus.binary_records, corpus.json_events):
        r = [len(zlib.compress(maker(s, 1 << 20).tobytes(), 1))
             for s in (1, 2**40 + 3)]
        assert abs(r[0] - r[1]) / r[0] < 0.01


# the log-normal size law of the generator, at the parameters a mix of
# messages would state
MESSAGES = {"corpus_bytes": 1 << 28, "deck": 256, "offsets": "drawn",
            "checksum_bytes": 1 << 24,
            "sizes": {"kind": "lognormal", "median": 32768, "sigma": 1.6,
                      "min": 1024, "max": 4194304}}
MIXES = sorted(f[:-5] for f in os.listdir(os.path.join(
    os.path.dirname(traffic.__file__), "traffic")) if f.endswith(".json"))


def test_message_sizes_keep_their_median_tail_and_clip():
    mix = MESSAGES
    sizes = traffic.deck_sizes(mix)
    assert len(sizes) == mix["deck"]
    assert abs(np.median(sizes) - 32768) <= 1
    assert sizes.min() >= 1024 and sizes.max() <= 4 << 20
    p95 = np.percentile(sizes, 95)
    z95 = NormalDist().inv_cdf(0.95)
    assert abs(p95 - 32768 * math.exp(1.6 * z95)) / p95 < 0.03
    assert 100_000 < sizes.mean() < 130_000


@pytest.mark.parametrize("name", MIXES + ["messages"])
def test_every_seed_gets_the_same_deck_in_another_order(name):
    mix = MESSAGES if name == "messages" else traffic.load(name)
    a = next(traffic.decks(mix, 1))
    b = next(traffic.decks(mix, 2**33 + 1))
    assert sorted(a) == sorted(b) == sorted(traffic.deck(mix))
    assert a != b
    assert all(r.offset + r.size <= mix["corpus_bytes"] for r in a)
    d = traffic.decks(mix, 3)
    assert next(d) == next(traffic.decks(mix, 3))


def test_bulk_holds_the_silesia_member_sizes():
    mix = traffic.load("bulk")
    d = traffic.deck(mix)
    # dickens .. x-ray, as the Silesia corpus lists them
    assert [r.size for r in d] == [
        10192446, 51220480, 9970564, 33553445, 6152192, 10085684, 6627202,
        21606400, 7251944, 41458703, 5345280, 8474240]
    # end to end: no two requests share a byte
    assert [r.offset for r in d] == np.cumsum([0] + [r.size for r in d])[
        :-1].tolist()
    assert d[-1].offset + d[-1].size == 211_938_580 <= mix["corpus_bytes"]


def test_check_sample_decodes_every_request_and_hashes_within_budget():
    reqs = [(0, 10), (10, 500), (0, 10), (510, 30), (10, 500), (540, 40)]
    decode, checksum = traffic.check_sample(reqs, 560, 7)
    # one frame of each distinct request
    assert sorted({reqs[i] for i in decode}) == sorted(set(reqs))
    assert len(decode) == len(set(reqs))
    assert set(checksum) <= set(decode)
    assert sum(reqs[i][1] for i in checksum) <= 560
    assert (decode, checksum) == traffic.check_sample(reqs, 560, 7)
    # at least one frame is hashed, whatever the budget
    assert traffic.check_sample([(0, 5)], 1, 0) == ([0], [0])
    # over seeds, every request is hashed now and then
    seen = set()
    for seed in range(40):
        _, c = traffic.check_sample(reqs, 100, seed)
        seen |= {reqs[i] for i in c}
    assert seen == set(reqs)
