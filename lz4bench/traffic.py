"""The one generator that every traffic mix's data file drives.

A mix is ``lz4bench/traffic/<name>.json``. Its keys:

``corpus_bytes``
    Size of the seeded corpus (``corpus.make_corpus``) the payloads are
    cut from.
``sizes``
    ``{"kind": "list", "bytes": [n, ...]}``: a deck holds these sizes; or
    ``{"kind": "lognormal", "median": m, "sigma": s, "min": lo, "max":
    hi}``: a deck holds the sizes at ``deck`` evenly spaced quantiles,
    clipped to [min, max].
``deck``
    How many requests make one deck (a list's length).
``offsets``
    ``"packed"``: the deck's requests lie end to end from the corpus's
    start, in list order, so no two share a byte; ``"drawn"``: each
    request starts at an offset drawn once, the same for every seed.
``checksum_bytes``
    How many plaintext bytes of the window's frames the plain reference
    hashes again to check a stated content checksum (plain-Python xxh32,
    about 7 MB/s), in frames drawn from the seed, at least one.

A deck is the same set of (offset, size) requests for every seed, and the
corpus holds the same kinds of data at each offset for every seed
(``corpus.py``), so the seed changes the order of each deck (a shuffle)
and the bytes, and never the work. A run's window is a whole number of
decks. After the window the plain reference decodes one frame of every
request of the deck, drawn from the seed (``check_sample``).

Requests are closed loop, one caller: each is one payload compressed into
its own frame, then that frame decompressed.
"""

from __future__ import annotations

import json
import os
from statistics import NormalDist
from typing import Iterator, NamedTuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


class Request(NamedTuple):
    offset: int
    size: int


def load(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", name + ".json")) as f:
        return json.load(f)


def scaled(mix: dict, scale: int) -> dict:
    """The mix with every byte count divided by *scale* (a power of two):
    the CPU tests drive the same generator at a size a test can hold."""
    out = json.loads(json.dumps(mix))
    out["corpus_bytes"] //= scale
    out["checksum_bytes"] = max(1, out["checksum_bytes"] // scale)
    sizes = out["sizes"]
    for key in ("median", "min", "max"):
        if key in sizes:
            sizes[key] = max(1, sizes[key] // scale)
    if "bytes" in sizes:
        sizes["bytes"] = [max(1, n // scale) for n in sizes["bytes"]]
    return out


def deck_sizes(mix: dict) -> np.ndarray:
    """The sizes of one deck, in quantile order (before any shuffle)."""
    s, n = mix["sizes"], int(mix["deck"])
    if s["kind"] == "list":
        if len(s["bytes"]) != n:
            raise ValueError("a list deck holds as many requests as sizes")
        return np.asarray(s["bytes"], np.int64)
    if s["kind"] != "lognormal":
        raise ValueError(f"unknown size kind {s['kind']!r}")
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    sizes = np.rint(s["median"] * np.exp(s["sigma"] * z)).astype(np.int64)
    return np.clip(sizes, int(s["min"]), int(s["max"]))


# the drawn offsets, the same for every seed
_OFFSET_SEED = 0x0FF5E7


def deck(mix: dict) -> list:
    """The requests of one deck, before the seed orders them."""
    sizes = deck_sizes(mix)
    corpus = int(mix["corpus_bytes"])
    if sizes.max() > corpus:
        raise ValueError("a request is larger than the corpus")
    if mix["offsets"] == "packed":
        offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        if sizes.sum() > corpus:
            raise ValueError("the packed deck is larger than the corpus")
    elif mix["offsets"] == "drawn":
        rng = np.random.default_rng(_OFFSET_SEED)
        offs = rng.integers(0, corpus - sizes + 1)
    else:
        raise ValueError(f"unknown offsets {mix['offsets']!r}")
    return [Request(int(o), int(s)) for o, s in zip(offs, sizes)]


def decks(mix: dict, seed: int) -> Iterator[list]:
    """The endless stream of decks of *mix* for *seed*."""
    rng = np.random.default_rng([int(seed) & (2**64 - 1), 0x7AFF1C])
    reqs = deck(mix)
    while True:
        yield [reqs[i] for i in rng.permutation(len(reqs)).tolist()]


def check_sample(requests: list, budget: int, seed: int) -> tuple:
    """Which frames of the window the plain reference reads. *requests*
    are the (offset, size) of the requests the window completed, in
    order. Returns (decode, checksum): the indices of one frame of every
    distinct request, drawn from the seed, and those of them, taken in an
    order drawn from the seed, whose content checksum is hashed again
    while the hashed bytes stay within *budget* (at least one)."""
    if not requests:
        return [], []
    rng = np.random.default_rng([int(seed) & (2**64 - 1), 0xC4EC])
    where = {}
    for i, r in enumerate(requests):
        where.setdefault(tuple(r), []).append(i)
    decode = sorted(int(ix[rng.integers(0, len(ix))])
                    for ix in where.values())
    checksum, total = [], 0
    for i in rng.permutation(decode).tolist():
        size = requests[i][1]
        if not checksum or total + size <= budget:
            checksum.append(i)
            total += size
    return decode, sorted(checksum)
