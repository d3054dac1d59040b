"""String and JSON-object helpers over the host frame codec.

A copy of ``divortio_lz4_tpu/types.py``: UTF-8 text and JSON objects
through ``frame.compress_frame`` / ``frame.decompress_frame`` (the host
codec, never the device one), with JAX's errors.
"""

from __future__ import annotations

import json
from typing import Any

from .config import DEFAULT_CONFIG, FrameConfig
from .frame import compress_frame, decompress_frame


def compress_string(text: str, dictionary=None,
                    config: FrameConfig = DEFAULT_CONFIG, **kw):
    """UTF-8 encode *text* and compress it into an LZ4 frame."""
    return compress_frame(text.encode("utf-8"), dictionary, config, **kw)


def decompress_string(data, dictionary=None, verify_checksum: bool = True,
                      **kw) -> str:
    """Decompress an LZ4 frame and decode it as UTF-8."""
    return bytes(decompress_frame(data, dictionary, verify_checksum, **kw)
                 ).decode("utf-8")


def compress_object(obj: Any, dictionary=None,
                    config: FrameConfig = DEFAULT_CONFIG, **kw):
    """JSON-serialize *obj* and compress it into an LZ4 frame."""
    try:
        text = json.dumps(obj)
    except (TypeError, ValueError) as e:
        raise ValueError(f"LZ4: Input cannot be serialized to JSON ({e})")
    return compress_frame(text.encode("utf-8"), dictionary, config, **kw)


def decompress_object(data, dictionary=None, verify_checksum: bool = True,
                      **kw) -> Any:
    """Decompress an LZ4 frame and parse it as JSON."""
    return json.loads(bytes(
        decompress_frame(data, dictionary, verify_checksum, **kw)))
