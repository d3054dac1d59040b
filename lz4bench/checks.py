"""What decides ``correct``: the numbers compared, and their limits.

Every number is a count of faults, compared exactly, so every limit is 0
(a control and each planted fault read 1 or more; PERF.md gives the
readings):

``failed_calls``
    Calls of the window that raised.
``wrong_answers``
    Round trips of the window whose decompressed bytes are not the
    payload, every one compared once the window has closed.
``reference_mismatch``
    Frames of the sample (``traffic.check_sample``: one frame of every
    request of the deck) that the plain reference cannot decode, or
    decodes to other bytes than the payload.
``frame_faults``
    Frames of the sample that break the block or frame format, or a
    setting that the configuration states (``frame`` in its file): the
    header's flags and block size, a content size equal to its length, no
    block over the block size, blocks that decode without history where
    the configuration states independent blocks, and, on the frames whose
    checksum the sample hashes again, a content checksum equal to the
    payload's xxh32.
"""

from __future__ import annotations

LIMITS = {"failed_calls": 0, "wrong_answers": 0, "reference_mismatch": 0,
          "frame_faults": 0}

_BLOCK_ID = {1 << 16: 4, 1 << 18: 5, 1 << 20: 6, 1 << 22: 7}


def stated_faults(fr, frame: dict) -> list:
    """How the frame's header departs from the configuration's *frame*
    settings."""
    out = []
    want_max = min((m for m in _BLOCK_ID if m >= frame["block_size"]),
                   default=1 << 22)
    if fr.block_max != want_max:
        out.append(f"block maximum {fr.block_max}, stated {want_max}")
    if fr.independent != frame["block_independence"]:
        out.append("block independence flag differs from the stated one")
    if (fr.content_checksum is not None) != frame["content_checksum"]:
        out.append("content checksum present or absent against the "
                   "stated setting")
    if (fr.content_size is not None) != frame["content_size"]:
        out.append("content size present or absent against the stated "
                   "setting")
    if fr.block_checksums != frame["block_checksums"]:
        out.append("block checksums present or absent against the stated "
                   "setting")
    return out


def verdict(numbers: dict, attempted: int) -> bool:
    return attempted > 0 and all(numbers[k] <= v for k, v in LIMITS.items())


def lines(numbers: dict) -> list:
    return [f"check {k}: {numbers[k]} (limit {v})" for k, v in LIMITS.items()]


def as_json(numbers: dict) -> dict:
    return {k: {"value": numbers[k], "limit": v} for k, v in LIMITS.items()}
