"""The seeded corpus every traffic mix cuts its payloads from.

A silesia-like mix made from the seed alone, reading no file of the
machine, so the same seed gives the same bytes on any host. The corpus is
cut into segments (1 MiB at the full 256 MiB) of six kinds, in fixed
shares in every quarter:

=============================  ======  ======================================
kind                           share   stands in for (Silesia file)
=============================  ======  ======================================
natural text (Zipf words)      3/16    dickens, webster, reymont
source-like text               3/16    samba, xml
binary-like records            4/16    mozilla, ooffice, sao
JSON event log                 4/16    the upstream benchmark's corpus
512-byte runs                  1/16    x-ray backgrounds
incompressible bytes           1/16    already compressed members
=============================  ======  ======================================

Each quarter holds the same count of segments of each kind, in one fixed
order that does not depend on the seed, so every quarter is the same
mix, and a payload cut at a given offset is of the
same kinds for every seed. The models behind the kinds (the
vocabularies, the opcode and offset tables) are fixed too; the seed
draws the text, the records, the events and the random bytes from them.
So the seed changes the bytes, never the work. Every draw uses uniform
integers or floats from ``numpy.random.Generator`` and maps them by hand,
so no distribution sampler whose algorithm may change between numpy
versions is involved.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

# kind -> segments of each 64-segment quarter
SHARES = {"text": 12, "source": 12, "binary": 16, "json": 16, "runs": 4,
          "random": 4}
SEGMENTS_PER_QUARTER = 64
SEGMENTS = 4 * SEGMENTS_PER_QUARTER
_STREAMS = {**{kind: i + 1 for i, kind in enumerate(SHARES)}, "order": 99}

_LETTERS = b"etaoinshrdlcumwfgypbvkjxqz"
# English letter frequencies (percent), in _LETTERS order
_LETTER_FREQ = np.array([12.7, 9.1, 8.2, 7.5, 7.0, 6.7, 6.3, 6.1, 6.0, 4.3,
                         4.0, 2.8, 2.8, 2.4, 2.4, 2.2, 2.0, 2.0, 1.9, 1.5,
                         1.0, 0.8, 0.2, 0.2, 0.1, 0.1])
_KEYWORDS = [b"def", b"return", b"if", b"else", b"for", b"in", b"while",
             b"self", b"None", b"import", b"from", b"class", b"int", b"len",
             b"const", b"static", b"void", b"struct", b"char", b"true",
             b"false", b"break", b"continue", b"try", b"except", b"with",
             b"as", b"not", b"and", b"or", b"0", b"1", b"2", b"i", b"n",
             b"x", b"+=", b"==", b"!=", b"<=", b"->", b"{", b"}", b"[]"]


def _rng(seed: int, kind: str) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2**64 - 1), _STREAMS[kind]])


# the models' seed and the segments' order, the same for every seed
_FIXED = 0x51E51A


def _model(kind: str) -> np.random.Generator:
    return np.random.default_rng([_FIXED, 100 + _STREAMS[kind]])


_TABLE_BITS = 20


def _draw(rng, n: int, p) -> np.ndarray:
    """n ids drawn with probabilities *p*, through an inverse-CDF table of
    2**20 entries (one gather a draw)."""
    cdf = np.cumsum(np.asarray(p, np.float64) / np.sum(p))
    grid = (np.arange(1 << _TABLE_BITS) + 0.5) / (1 << _TABLE_BITS)
    table = np.minimum(np.searchsorted(cdf, grid), len(cdf) - 1)
    table = table.astype(np.int32)
    return table[rng.integers(0, 1 << _TABLE_BITS, n, dtype=np.int32)]


def _zipf_ids(rng, n: int, vocab: int, s: float) -> np.ndarray:
    """n ids in [0, vocab) with P(i) proportional to 1 / (i + 2.7) ** s."""
    return _draw(rng, n, 1.0 / (np.arange(vocab) + 2.7) ** s)


def _words(rng, vocab: int) -> list:
    """A seeded vocabulary of lowercase words, 1-13 letters long."""
    lens = 1 + np.minimum(rng.integers(0, 5, vocab) + rng.integers(0, 5, vocab)
                          + rng.integers(0, 4, vocab), 12)
    letters = np.frombuffer(_LETTERS, np.uint8)[
        _draw(rng, int(lens.sum()), _LETTER_FREQ)]
    ends = np.cumsum(lens)
    return [letters[e - k: e].tobytes() for e, k in zip(ends, lens)]


def _token_stream(rng, size: int, vocab: list, ids: np.ndarray,
                  seps: list, sep_p: list) -> np.ndarray:
    """Join vocab[ids] with separators drawn from *seps* into *size*
    bytes (the ids are drawn long enough by the caller)."""
    table = vocab + seps
    blob = np.frombuffer(b"".join(table), np.uint8)
    lens = np.array([len(t) for t in table], np.int32)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    sep_ids = len(vocab) + _draw(rng, len(ids), sep_p)
    toks = np.empty(2 * len(ids), np.int32)
    toks[0::2] = ids
    toks[1::2] = sep_ids
    tl = lens[toks]
    keep = int(np.searchsorted(np.cumsum(tl), size)) + 1
    toks, tl = toks[:keep], tl[:keep]
    ends = np.cumsum(tl, dtype=np.int32)
    idx = np.repeat(starts[toks] - ends + tl, tl)
    idx += np.arange(int(ends[-1]), dtype=np.int32)
    out = blob[idx]
    if len(out) < size:
        raise ValueError("token stream too short")
    return out[:size]


def natural_text(seed: int, size: int) -> np.ndarray:
    """Text from a Zipf word model over a seeded vocabulary."""
    rng = _rng(seed, "text")
    vocab = _words(_model("text"), 20000)
    ids = _zipf_ids(rng, size // 5 + 64, len(vocab), 1.07)
    seps = [b" ", b", ", b". ", b".\n", b"; ", b"\n\n"]
    return _token_stream(rng, size, vocab, ids, seps,
                         [0.84, 0.06, 0.05, 0.03, 0.01, 0.01])


def source_text(seed: int, size: int) -> np.ndarray:
    """Source-like text: keywords and seeded identifiers, punctuation,
    indented lines."""
    rng, model = _rng(seed, "source"), _model("source")
    idents = [b"_".join(p) for p in zip(_words(model, 3000),
                                        _words(model, 3000))]
    vocab = _KEYWORDS + idents
    ids = _zipf_ids(rng, size // 5 + 64, len(vocab), 1.0)
    seps = [b" ", b"(", b")", b", ", b".", b" = ", b"\n", b"\n    ",
            b"\n        ", b"\n            ", b":\n        ", b");\n    ",
            b"[", b"]"]
    return _token_stream(rng, size, vocab, ids, seps,
                         [0.30, 0.10, 0.08, 0.08, 0.08, 0.06, 0.04, 0.06,
                          0.06, 0.03, 0.03, 0.03, 0.025, 0.025])


def binary_records(seed: int, size: int) -> np.ndarray:
    """Machine-code-like records: a Zipf set of opcodes, a few ModRM
    bytes, 32-bit offsets from a small repeated pool, immediates, and
    zero padding."""
    rng, model = _rng(seed, "binary"), _model("binary")
    n = size // 4 + 16
    opcodes = model.integers(0, 256, 64).astype(np.uint8)
    modrm = model.integers(0, 256, 12).astype(np.uint8)
    pool = model.integers(0, 1 << 24, 512).astype(np.uint32)
    kind = _draw(rng, n, [0.35, 0.35, 0.2, 0.1])
    word = np.where(kind == 1, pool[_zipf_ids(rng, n, 512, 1.1)],
                    rng.integers(0, 4096, n, dtype=np.uint32))
    slot = opcodes[_zipf_ids(rng, n, 64, 1.2)].astype(np.uint64)
    slot |= modrm[_zipf_ids(rng, n, 12, 1.0)].astype(np.uint64) << 8
    slot |= word.astype(np.uint64) << 16
    slot[kind == 3] = 0                        # 8 bytes of padding
    slots = slot.astype("<u8").view(np.uint8)
    lens = np.array([2, 6, 5, 8], np.int32)[kind]
    ends = np.cumsum(lens, dtype=np.int32)
    keep = int(np.searchsorted(ends, size)) + 1
    lens, ends = lens[:keep], ends[:keep]
    idx = np.repeat(8 * np.arange(keep, dtype=np.int32) - ends + lens, lens)
    idx += np.arange(int(ends[-1]), dtype=np.int32)
    out = slots[idx]
    if len(out) < size:
        raise ValueError("record stream too short")
    return out[:size]


def json_events(seed: int, size: int) -> np.ndarray:
    """The upstream benchmark's JSON event record (``benchUtils.js:7-22``)
    with its fields varied from the seed."""
    rng = _rng(seed, "json")
    n = size // 110 + 16
    levels = ["info", "info", "info", "info", "debug", "warn", "error"]
    services = ["api-gateway", "auth", "billing", "search", "cart"]
    msgs = ["request completed", "request completed", "cache miss",
            "upstream timeout", "user login"]
    statuses = [200, 200, 200, 200, 201, 204, 304, 400, 404, 500]
    ts = 1700000000 + np.cumsum(rng.integers(0, 3, n))
    lv = rng.integers(0, len(levels), n)
    sv = rng.integers(0, len(services), n)
    ms = rng.integers(0, len(msgs), n)
    st = rng.integers(0, len(statuses), n)
    lat = rng.integers(0, 900, n)
    user = rng.integers(0, 100000, n)
    text = "".join(
        f'{{"ts":{t},"level":"{levels[a]}","service":"{services[b]}",'
        f'"msg":"{msgs[c]}","status":{statuses[d]},"latency_ms":{e},'
        f'"path":"/v1/users/{u}"}}\n'
        for t, a, b, c, d, e, u in zip(ts.tolist(), lv.tolist(),
                                       sv.tolist(), ms.tolist(),
                                       st.tolist(), lat.tolist(),
                                       user.tolist()))
    out = np.frombuffer(text.encode(), np.uint8)
    if len(out) < size:
        raise ValueError("json stream too short")
    return out[:size]


def runs(seed: int, size: int) -> np.ndarray:
    """512-byte runs of seeded bytes."""
    rng = _rng(seed, "runs")
    return np.repeat(rng.integers(0, 256, -(-size // 512), dtype=np.uint8),
                     512)[:size]


def incompressible(seed: int, size: int) -> np.ndarray:
    return np.frombuffer(_rng(seed, "random").bytes(size), np.uint8)


_MAKERS = {"text": natural_text, "source": source_text,
           "binary": binary_records, "json": json_events, "runs": runs,
           "random": incompressible}


def segment_kinds() -> list:
    """The kind of each segment: every quarter has SHARES of each, in a
    fixed order."""
    rng = _rng(_FIXED, "order")
    quarter = [k for k, n in SHARES.items() for _ in range(n)]
    kinds = []
    for _ in range(4):
        kinds += [quarter[i] for i in rng.permutation(len(quarter))]
    return kinds


def make_corpus(seed: int, size: int) -> np.ndarray:
    """*size* bytes (a multiple of 256 * 1024) of the mix, from *seed*."""
    if size % (SEGMENTS * 1024) or size <= 0:
        raise ValueError(f"corpus size {size} must be a positive multiple "
                         f"of {SEGMENTS * 1024}")
    seg = size // SEGMENTS
    kinds = segment_kinds()
    out = np.empty(size, np.uint8)

    def fill(kind):
        where = [i for i, k in enumerate(kinds) if k == kind]
        data = _MAKERS[kind](seed, seg * len(where)).reshape(len(where), seg)
        for j, i in enumerate(where):
            out[i * seg: (i + 1) * seg] = data[j]

    # numpy releases the interpreter lock in the bulk steps, so the kinds
    # are made side by side; each draws from its own stream.
    with ThreadPoolExecutor(len(_MAKERS)) as pool:
        list(pool.map(fill, _MAKERS))
    return out
