"""Streaming frame machines and stream wrappers, with device bursts.

Port of ``divortio_lz4_tpu/stream.py``:

- ``LZ4Encoder``: chunked frame encoder with a rolling 64 KB linked-block
  window (``add``/``update``, ``finish``, ``stats``, ``state_dict``,
  ``from_state``);
- ``LZ4Decoder``: the incremental frame-parsing FSM (any fragments, even
  single bytes; skippable frames, dictID checks, header, block and content
  checksums, concatenated frames);
- ``CompressStream`` / ``DecompressStream``, ``create_*_stream``,
  ``compress_file`` / ``decompress_file``.

The host parts are copies; their frames and "LZ4: ..." errors are JAX's.
``backend`` picks the block codec:

- ``"device"``, the port's default (JAX's is the host codec): an ``add``
  holding at least ``_DEVICE_MIN_BLOCKS`` full blocks (<= 64 KB, a
  multiple of 1 KB, no dictionary) encodes them as one burst on *device*:
  the split engine's chain builder over every block's row, independent or
  ``[history | payload]`` for linked frames (``parallel/bigblock.py
  :queue_frame_big``), one fetch, then the host serializer per block on the
  host pool (``splice_blocks_big``). The decoder gathers at least
  ``_DEVICE_MIN_BLOCKS`` complete buffered blocks of an independent frame
  without a dictionary (blocks <= 256 KB) into one burst:
  ``ops/stream_decode.decode_wire_blocks2``
  (compact kernel up to 64 KB, wire kernel at 256 KB), one fetch. A burst
  holds at most ``_BURST_BYTES`` of plaintext. Every other block (the
  carried remainder, linked frames of the decoder, dictionaries, bigger
  blocks, feeds of fewer blocks) goes to the "native" host codec, as in
  JAX; ``stats`` counts which path served each block. A burst that fails
  raises; nothing falls back to the host.
- ``"native"`` (the port's C++ block codec) or ``"python"`` (the scalar
  oracle): JAX's host codecs. ``None`` is the default host codec,
  "native".

``device`` ("cuda" unless the caller asks for the CPU, where the kernels'
plain versions run) is read by the device bursts only; with
``backend="device"`` it is resolved when the stream is built, so "cuda"
without a GPU raises RuntimeError there. Dropped from JAX: the 32-row
chunks of the encoder's bursts and the decoder's 64-block power-of-two
bucket, both TPU compile shapes. The bytes do not change (the chain
builder and the serializer work row by row); ``stats`` can (a burst here
takes every complete block up to its cap).
"""

from __future__ import annotations

from typing import Iterable, Iterator, List, Optional

import numpy as np

from ._device import resolve_device
from .backends import get_backend
from .config import DEFAULT_CONFIG, FrameConfig
from .constants import (
    BLOCK_MAX_SIZES,
    BLOCK_SIZE_MASK,
    FLG_BLOCK_CHECKSUM,
    FLG_BLOCK_INDEPENDENCE,
    FLG_CONTENT_CHECKSUM,
    FLG_CONTENT_SIZE,
    FLG_DICT_ID,
    FLG_VERSION_MASK,
    LZ4_VERSION,
    MAGIC_NUMBER,
    SKIPPABLE_MAGIC_MAX,
    SKIPPABLE_MAGIC_MIN,
    UNCOMPRESSED_FLAG,
    WINDOW_SIZE,
    block_bound,
)
from .ops.block_ref import new_hash_table
from .ops.hybrid_encode import hybrid_max_bs
from .ops.stream_decode import decode_wire_blocks2
from .parallel.bigblock import queue_frame_big, splice_blocks_big
from .parallel.device import WIRE_MAX_BS
from .utils import ensure_buffer, read_u32le, write_u32le
from .xxh import XXHash32, xxhash32

# Minimum full blocks for a device burst (below it, a launch and a fetch
# lose to the host codec), JAX's _DEVICE_MIN_BLOCKS.
_DEVICE_MIN_BLOCKS = 4
# Plaintext bytes one burst holds at most: the frame path's 1024 x 64 KB
# batch (256 blocks of 256 KB). A decode burst's output rows and an encode
# burst's rows and chains stay within a few times this on the card.
_BURST_BYTES = 1024 * 65536


def _burst_blocks(block_size: int) -> int:
    return max(_DEVICE_MIN_BLOCKS, _BURST_BYTES // block_size)


class LZ4Encoder:
    """Chunked LZ4 frame encoder with a rolling 64 KB linked-block window.

    ``add(chunk)`` returns a list of encoded byte chunks ready to emit;
    ``finish()`` flushes the remainder, EndMark, and optional content
    checksum. The carried state is {pending input, 64 KB window, hasher,
    framing flags}. See the module docstring for *backend* and *device*.
    """

    def __init__(self,
                 config: FrameConfig = DEFAULT_CONFIG,
                 dictionary=None,
                 backend: Optional[str] = "device", *,
                 device="cuda"):
        # Streaming cannot know the total size up front; content_size is
        # forced off.
        self.config = config.with_(content_size=False)
        self._device = backend == "device"
        self._dev = resolve_device(device) if self._device else None
        self._be = get_backend(None if self._device else backend)
        self._block_size = self.config.resolved_block_size
        # Which path served each flushed block, and the device bursts.
        self.stats = {"host_blocks": 0, "device_blocks": 0,
                      "device_bursts": 0}
        self._pending = bytearray()
        self._header_sent = False
        self._finished = False
        self._hasher = XXHash32(0) if self.config.content_checksum else None
        self._dict_id = None
        self._history = b""
        if dictionary is not None:
            dict_buf = ensure_buffer(dictionary)
            if len(dict_buf) > 0:
                self._dict_id = xxhash32(dict_buf, 0)
                self._history = bytes(dict_buf[-WINDOW_SIZE:])

    # -- header -------------------------------------------------------------

    def _frame_header(self) -> bytes:
        cfg = self.config
        out = np.empty(19, dtype=np.uint8)
        out[0], out[1], out[2], out[3] = 0x04, 0x22, 0x4D, 0x18
        flg = LZ4_VERSION << 6
        if cfg.block_independence:
            flg |= FLG_BLOCK_INDEPENDENCE
        if cfg.content_checksum:
            flg |= FLG_CONTENT_CHECKSUM
        if cfg.block_checksums:
            flg |= FLG_BLOCK_CHECKSUM
        if self._dict_id is not None:
            flg |= FLG_DICT_ID
        out[4] = flg
        out[5] = (cfg.block_id & 0x07) << 4
        pos = 6
        if self._dict_id is not None:
            write_u32le(out, pos, self._dict_id)
            pos += 4
        out[pos] = (xxhash32(out[4:pos], 0) >> 8) & 0xFF
        pos += 1
        return bytes(out[:pos])

    # -- block flush --------------------------------------------------------

    def _flush_block(self, payload) -> bytes:
        """One block through the host codec. payload: np.uint8 array
        (zero-copy view from add) or bytes."""
        if isinstance(payload, (bytes, bytearray)):
            payload = np.frombuffer(bytes(payload), dtype=np.uint8)
        n = len(payload)
        hist = b"" if self.config.block_independence else self._history
        hist_len = len(hist)
        if hist_len > 0:
            working = np.empty(hist_len + n, dtype=np.uint8)
            working[:hist_len] = np.frombuffer(hist, dtype=np.uint8)
            working[hist_len:] = payload
        else:
            working = payload
        table = new_hash_table()
        if hist_len > 0:
            self._be.warm_table(table, working, hist_len)
        out = np.empty(4 + block_bound(n) + 4, dtype=np.uint8)
        comp = self._be.compress_block(working, out, hist_len, n, table, 4)
        if 0 < comp < n:
            write_u32le(out, 0, comp)
            end = 4 + comp
        else:
            write_u32le(out, 0, n | UNCOMPRESSED_FLAG)
            out[4: 4 + n] = payload
            end = 4 + n
        if self.config.block_checksums:
            write_u32le(out, end, xxhash32(out[4:end], 0))
            end += 4
        if not self.config.block_independence:
            # Keep only the last 64 KB.
            if n >= WINDOW_SIZE:
                self._history = payload[-WINDOW_SIZE:].tobytes()
            else:
                self._history = (hist + payload.tobytes())[-WINDOW_SIZE:]
        self.stats["host_blocks"] += 1
        return bytes(out[:end])

    # -- public API ---------------------------------------------------------

    def add(self, chunk) -> List[bytes]:
        """Feed a chunk; returns zero or more encoded output chunks."""
        if self._finished:
            raise RuntimeError("LZ4: Stream is closed")
        buf = ensure_buffer(chunk)
        outputs: List[bytes] = []
        if len(buf) == 0:
            return outputs
        if self._hasher is not None:
            self._hasher.update(buf)
        if not self._header_sent:
            self._header_sent = True
            outputs.append(self._frame_header())
        bs = self._block_size
        pos = 0
        if self._pending:
            # Top the carried remainder up to one block, then flush it.
            take = min(bs - len(self._pending), len(buf))
            self._pending += buf[:pos + take].tobytes()
            pos = take
            if len(self._pending) < bs:
                return outputs
            outputs.append(self._flush_block(bytes(self._pending)))
            self._pending.clear()
        # Whole blocks encode straight from the caller's buffer.
        nfull = (len(buf) - pos) // bs
        if (self._device and nfull >= _DEVICE_MIN_BLOCKS
                and self._device_enc_ok()):
            cap = _burst_blocks(bs)
            for first in range(0, nfull, cap):
                nb = min(cap, nfull - first)
                outputs.extend(self._flush_blocks_device(
                    buf[pos: pos + nb * bs], nb))
                pos += nb * bs
        while len(buf) - pos >= bs:
            outputs.append(self._flush_block(buf[pos: pos + bs]))
            pos += bs
        if pos < len(buf):
            self._pending += buf[pos:].tobytes()
        return outputs

    def _device_enc_ok(self) -> bool:
        return (self._block_size <= hybrid_max_bs()
                and self._block_size % 1024 == 0 and self._dict_id is None)

    def _flush_blocks_device(self, payload: np.ndarray,
                             nfull: int) -> List[bytes]:
        """Encode *nfull* full blocks as one burst on the device (JAX
        ``_flush_blocks_device`` and ``_flush_blocks_device_linked``).

        The chain builder runs over every block's row at once: independent
        rows, or, for a linked frame, ``[history | payload]`` rows whose
        64 KB window is the known plaintext before the block (the carried
        history, then the burst's own earlier blocks) with each row's first
        valid history index; one fetch of the chains, then the host
        serializer per block on the host pool. A linked burst's carried
        window advances past the whole burst."""
        linked = not self.config.block_independence
        window = None
        if linked and self._history:
            window = np.frombuffer(self._history, np.uint8)
        st = queue_frame_big(payload, self._block_size, window, linked,
                             self._dev)
        comps = splice_blocks_big(st, st.chains.cpu().numpy())
        bs = self._block_size
        outputs = [self._frame_block_bytes(comps[i],
                                           payload[i * bs: (i + 1) * bs])
                   for i in range(nfull)]
        if linked:
            W = WINDOW_SIZE
            if len(payload) >= W:
                self._history = payload[-W:].tobytes()
            else:
                self._history = (self._history + payload.tobytes())[-W:]
        self.stats["device_blocks"] += nfull
        self.stats["device_bursts"] += 1
        return outputs

    def _frame_block_bytes(self, comp: np.ndarray,
                           payload: np.ndarray) -> bytes:
        """Wire framing for one already-compressed block: size word,
        stored fallback, optional block checksum (the same tail
        _flush_block composes in place around its compress destination)."""
        n = len(payload)
        clen = len(comp)
        out = np.empty(4 + max(clen, n) + 4, np.uint8)
        if 0 < clen < n:
            write_u32le(out, 0, clen)
            out[4: 4 + clen] = comp
            end = 4 + clen
        else:
            write_u32le(out, 0, n | UNCOMPRESSED_FLAG)
            out[4: 4 + n] = payload
            end = 4 + n
        if self.config.block_checksums:
            write_u32le(out, end, xxhash32(out[4:end], 0))
            end += 4
        return bytes(out[:end])

    # Alias for drop-in familiarity with the reference's test-suite name.
    update = add

    # -- checkpoint/resume ---------------------------------------------------
    # Snapshots are plain dicts (bytes fields), safe to pickle; the keys and
    # values are JAX's, so a snapshot resumes in either package.

    def state_dict(self) -> dict:
        return {
            "config": self.config.__dict__.copy(),
            "pending": bytes(self._pending),
            "header_sent": self._header_sent,
            "finished": self._finished,
            "dict_id": self._dict_id,
            "history": self._history,
            "hasher": self._hasher.state_dict() if self._hasher else None,
        }

    @classmethod
    def from_state(cls, state: dict, backend: Optional[str] = "device", *,
                   device="cuda") -> "LZ4Encoder":
        cfg = FrameConfig(**state["config"])
        enc = cls(cfg, None, backend, device=device)
        enc._pending = bytearray(state["pending"])
        enc._header_sent = state["header_sent"]
        enc._finished = state["finished"]
        enc._dict_id = state["dict_id"]
        enc._history = state["history"]
        if state["hasher"] is not None:
            enc._hasher = XXHash32.from_state(state["hasher"])
        return enc

    def finish(self) -> List[bytes]:
        """Flush remaining data, EndMark, and optional content checksum."""
        if self._finished:
            raise RuntimeError("LZ4: Stream is closed")
        self._finished = True
        outputs: List[bytes] = []
        if not self._header_sent:
            self._header_sent = True
            outputs.append(self._frame_header())
        while self._pending:
            payload = bytes(self._pending[: self._block_size])
            del self._pending[: self._block_size]
            outputs.append(self._flush_block(payload))
        tail = np.empty(8, dtype=np.uint8)
        write_u32le(tail, 0, 0)
        end = 4
        if self._hasher is not None:
            write_u32le(tail, 4, self._hasher.digest())
            end = 8
        outputs.append(bytes(tail[:end]))
        return outputs


# FSM states, plus SKIP for skippable frames.
_S_MAGIC = 0
_S_HEADER = 1
_S_BLOCK_SIZE = 2
_S_BLOCK_BODY = 3
_S_CHECKSUM = 4
_S_SKIP = 5


class LZ4Decoder:
    """Incremental LZ4 frame decoder FSM.

    Feed arbitrary fragments (even single bytes) via ``update``; decoded
    chunks (np.uint8, one a block) are returned as they complete. After a
    frame's checksum the state returns to MAGIC so concatenated frames
    decode seamlessly. See the module docstring for *backend* and *device*.
    """

    def __init__(self, dictionary=None, verify_checksum: bool = True,
                 backend: Optional[str] = "device", *, device="cuda"):
        self._device = backend == "device"
        self._dev = resolve_device(device) if self._device else None
        self._be = get_backend(None if self._device else backend)
        # Which path served each block, and the device bursts.
        self.stats = {"host_blocks": 0, "device_blocks": 0,
                      "device_bursts": 0}
        self.verify_checksum = verify_checksum
        self._dict = ensure_buffer(dictionary) if dictionary is not None else None
        self._buf = bytearray()
        self._state = _S_MAGIC
        self._hasher = XXHash32(0)
        # Per-frame output bound (refined from the header's BD byte).
        self._block_max = BLOCK_MAX_SIZES[7]
        self._reset_frame_state()

    def _reset_frame_state(self):
        self._skip_remaining = 0
        self._flg = 0
        self._has_block_checksum = False
        self._has_content_size = False
        self._has_content_checksum = False
        self._has_dict_id = False
        self._block_word = 0
        self._window = np.zeros(WINDOW_SIZE, dtype=np.uint8)
        self._window_pos = 0
        if self._dict is not None:
            d = len(self._dict)
            take = min(d, WINDOW_SIZE)
            self._window[:take] = self._dict[d - take:]
            self._window_pos = take
        self._hasher.reset()

    def update(self, chunk) -> List[np.ndarray]:
        """Feed bytes; returns decoded chunks (possibly empty)."""
        buf = ensure_buffer(chunk)
        self._buf += buf.tobytes()
        outputs: List[np.ndarray] = []

        while True:
            if self._state == _S_MAGIC:
                if len(self._buf) < 4:
                    break
                word = read_u32le(self._buf, 0)
                if SKIPPABLE_MAGIC_MIN <= word <= SKIPPABLE_MAGIC_MAX:
                    if len(self._buf) < 8:
                        break
                    self._skip_remaining = read_u32le(self._buf, 4)
                    del self._buf[:8]
                    self._state = _S_SKIP
                    continue
                if word != MAGIC_NUMBER:
                    raise ValueError("LZ4: Invalid Magic Number")
                del self._buf[:4]
                self._state = _S_HEADER

            elif self._state == _S_SKIP:
                take_n = min(self._skip_remaining, len(self._buf))
                del self._buf[:take_n]
                self._skip_remaining -= take_n
                if self._skip_remaining > 0:
                    break
                self._state = _S_MAGIC

            elif self._state == _S_HEADER:
                if len(self._buf) < 2:
                    break
                flg = self._buf[0]
                version = (flg & FLG_VERSION_MASK) >> 6
                if version != LZ4_VERSION:
                    raise ValueError(f"LZ4: Unsupported Version {version}")
                hdr_len = 2 + 1  # FLG + BD + header checksum
                if flg & FLG_CONTENT_SIZE:
                    hdr_len += 8
                if flg & FLG_DICT_ID:
                    hdr_len += 4
                if len(self._buf) < hdr_len:
                    break
                self._flg = flg
                self._block_max = BLOCK_MAX_SIZES.get(
                    (self._buf[1] >> 4) & 0x07, BLOCK_MAX_SIZES[7])
                self._has_block_checksum = bool(flg & FLG_BLOCK_CHECKSUM)
                self._has_content_size = bool(flg & FLG_CONTENT_SIZE)
                self._has_content_checksum = bool(flg & FLG_CONTENT_CHECKSUM)
                self._has_dict_id = bool(flg & FLG_DICT_ID)
                pos = 2
                if self._has_content_size:
                    pos += 8  # streaming decode never pre-allocates from it
                if self._has_dict_id:
                    frame_dict_id = read_u32le(self._buf, pos)
                    pos += 4
                    if self._dict is None:
                        raise ValueError("LZ4: Frame requires a Dictionary")
                    if xxhash32(self._dict, 0) != frame_dict_id:
                        raise ValueError("LZ4: Dictionary ID Mismatch")
                # Header-checksum byte, verified so a corrupted descriptor
                # raises instead of misparsing the frame.
                if self.verify_checksum:
                    desc = np.frombuffer(
                        bytes(self._buf[: hdr_len - 1]), np.uint8)
                    if ((xxhash32(desc, 0) >> 8) & 0xFF) \
                            != self._buf[hdr_len - 1]:
                        raise ValueError("LZ4: Header Checksum Error")
                del self._buf[:hdr_len]
                self._state = _S_BLOCK_SIZE

            elif self._state == _S_BLOCK_SIZE:
                if len(self._buf) < 4:
                    break
                if self._device and (self._flg & FLG_BLOCK_INDEPENDENCE) \
                        and self._dict is None \
                        and self._block_max <= WIRE_MAX_BS \
                        and self._try_batch_decode(outputs):
                    continue
                word = read_u32le(self._buf, 0)
                del self._buf[:4]
                if word == 0:
                    # EndMark.
                    if self._has_content_checksum:
                        self._state = _S_CHECKSUM
                    else:
                        self._state = _S_MAGIC
                        self._reset_frame_state()
                else:
                    self._block_word = word
                    self._state = _S_BLOCK_BODY

            elif self._state == _S_BLOCK_BODY:
                bsize = self._block_word & BLOCK_SIZE_MASK
                need = bsize + (4 if self._has_block_checksum else 0)
                if len(self._buf) < need:
                    break
                # Zero-copy view of the wire bytes; released before the
                # buffer mutates (a bytearray cannot shrink with exported
                # views). Stored blocks copy out, compressed blocks only
                # ever read through it.
                mv = memoryview(self._buf)[:bsize]
                data = np.frombuffer(mv, dtype=np.uint8)
                if self._has_block_checksum:
                    stored_bc = read_u32le(self._buf, bsize)
                    if self.verify_checksum and \
                            stored_bc != xxhash32(data, 0):
                        raise ValueError("LZ4: Block Checksum Error")
                if self._block_word & UNCOMPRESSED_FLAG:
                    chunk_out = np.array(data)
                else:
                    if self._flg & FLG_BLOCK_INDEPENDENCE:
                        # An independent block's window resets: its
                        # history is the dictionary only.
                        hist = self._dict
                    else:
                        hist = (self._window[: self._window_pos]
                                if self._window_pos > 0 else None)
                    # Fresh per-block buffer: the returned chunk is a view,
                    # safe because nothing reuses it.
                    dst = np.empty(self._block_max, dtype=np.uint8)
                    n = self._be.decompress_block(
                        data, 0, bsize, dst, 0, hist)
                    chunk_out = dst[:n]
                data = None
                mv.release()
                del self._buf[:need]
                if self._has_content_checksum:
                    self._hasher.update(chunk_out)
                self._update_window(chunk_out)
                outputs.append(chunk_out)
                self.stats["host_blocks"] += 1
                self._state = _S_BLOCK_SIZE

            elif self._state == _S_CHECKSUM:
                if len(self._buf) < 4:
                    break
                stored = read_u32le(self._buf, 0)
                del self._buf[:4]
                if self.verify_checksum and stored != self._hasher.digest():
                    raise ValueError("LZ4: Content Checksum Error")
                self._state = _S_MAGIC
                self._reset_frame_state()

        return outputs

    def _try_batch_decode(self, outputs: List[np.ndarray]) -> bool:
        """Scan the buffered complete blocks of an independent frame and
        decode them as one burst on the device when at least
        _DEVICE_MIN_BLOCKS are there, at most _burst_blocks(block max) of
        them; the rest stays buffered for the FSM. Block checksums are
        verified on the host before the launch. Returns True when it
        consumed input (the state stays _S_BLOCK_SIZE)."""
        spans = []  # (data_off, bsize, stored, ck_off)
        p = 0
        n = len(self._buf)
        ck = 4 if self._has_block_checksum else 0
        cap = _burst_blocks(self._block_max)
        while p + 4 <= n and len(spans) < cap:
            word = read_u32le(self._buf, p)
            if word == 0:
                break
            bsize = word & BLOCK_SIZE_MASK
            if bsize > self._block_max or p + 4 + bsize + ck > n:
                break
            spans.append((p + 4, bsize, bool(word & UNCOMPRESSED_FLAG),
                          p + 4 + bsize))
            p += 4 + bsize + ck
        if len(spans) < _DEVICE_MIN_BLOCKS:
            return False
        buf_np = np.frombuffer(bytes(self._buf[:p]), np.uint8)
        if self._has_block_checksum and self.verify_checksum:
            for off, bsize, _, cko in spans:
                if read_u32le(buf_np, cko) \
                        != xxhash32(buf_np[off: off + bsize], 0):
                    raise ValueError("LZ4: Block Checksum Error")
        comp_idx = [i for i, s in enumerate(spans) if not s[2]]
        decoded = decode_wire_blocks2(
            [buf_np[spans[i][0]: spans[i][0] + spans[i][1]]
             for i in comp_idx], self._block_max, device=self._dev)
        dec_map = dict(zip(comp_idx, decoded))
        for i, (off, bsize, stored, _) in enumerate(spans):
            chunk = (np.array(buf_np[off: off + bsize]) if stored
                     else dec_map[i])
            if self._has_content_checksum:
                self._hasher.update(chunk)
            self._update_window(chunk)
            outputs.append(chunk)
        del self._buf[:p]
        self.stats["device_blocks"] += len(spans)
        self.stats["device_bursts"] += 1
        return True

    def _update_window(self, chunk: np.ndarray) -> None:
        """Three-case rolling window update."""
        cl = len(chunk)
        if cl >= WINDOW_SIZE:
            self._window[:] = chunk[cl - WINDOW_SIZE:]
            self._window_pos = WINDOW_SIZE
        elif self._window_pos + cl <= WINDOW_SIZE:
            self._window[self._window_pos: self._window_pos + cl] = chunk
            self._window_pos += cl
        else:
            keep = WINDOW_SIZE - cl
            self._window[:keep] = self._window[self._window_pos - keep:
                                               self._window_pos]
            self._window[keep:] = chunk
            self._window_pos = WINDOW_SIZE

    @property
    def finished_frame(self) -> bool:
        """True when positioned at a frame boundary (safe resume point)."""
        return self._state == _S_MAGIC and not self._buf

    # -- checkpoint/resume ---------------------------------------------------

    def state_dict(self) -> dict:
        return {
            "verify": self.verify_checksum,
            "dict": None if self._dict is None else bytes(self._dict),
            "buf": bytes(self._buf),
            "state": self._state,
            "flags": (self._flg, self._has_block_checksum,
                      self._has_content_size, self._has_content_checksum,
                      self._has_dict_id),
            "block_word": self._block_word,
            "window": bytes(self._window[: self._window_pos]),
            "hasher": self._hasher.state_dict(),
        }

    @classmethod
    def from_state(cls, state: dict, backend: Optional[str] = "device", *,
                   device="cuda") -> "LZ4Decoder":
        dec = cls(state["dict"], state["verify"], backend, device=device)
        dec._buf = bytearray(state["buf"])
        dec._state = state["state"]
        (dec._flg, dec._has_block_checksum, dec._has_content_size,
         dec._has_content_checksum, dec._has_dict_id) = state["flags"]
        dec._block_word = state["block_word"]
        w = np.frombuffer(state["window"], np.uint8)
        dec._window[: len(w)] = w
        dec._window_pos = len(w)
        dec._hasher = XXHash32.from_state(state["hasher"])
        return dec


class CompressStream:
    """Transform-stream style wrapper around LZ4Encoder.

    ``write`` returns encoded bytes; ``flush`` terminates the frame. Also
    usable as a pipe over any byte-chunk iterable.
    """

    def __init__(self, config: FrameConfig = DEFAULT_CONFIG, dictionary=None,
                 backend: Optional[str] = "device", *, device="cuda"):
        self._enc = LZ4Encoder(config, dictionary, backend, device=device)

    def write(self, chunk) -> bytes:
        return b"".join(self._enc.add(chunk))

    def flush(self) -> bytes:
        return b"".join(self._enc.finish())

    def pipe(self, chunks: Iterable) -> Iterator[bytes]:
        for c in chunks:
            out = self.write(c)
            if out:
                yield out
        tail = self.flush()
        if tail:
            yield tail


class DecompressStream:
    """Transform-stream style wrapper around LZ4Decoder."""

    def __init__(self, dictionary=None, verify_checksum: bool = True,
                 backend: Optional[str] = "device", *, device="cuda"):
        self._dec = LZ4Decoder(dictionary, verify_checksum, backend,
                               device=device)

    def write(self, chunk) -> bytes:
        return b"".join(bytes(c) for c in self._dec.update(chunk))

    def flush(self) -> bytes:
        # Frames self-terminate; flush is a no-op.
        return b""

    def pipe(self, chunks: Iterable) -> Iterator[bytes]:
        for c in chunks:
            out = self.write(c)
            if out:
                yield out


def create_compress_stream(config: FrameConfig = DEFAULT_CONFIG,
                           dictionary=None,
                           backend: Optional[str] = "device", *,
                           device="cuda") -> CompressStream:
    return CompressStream(config, dictionary, backend, device=device)


def create_decompress_stream(dictionary=None, verify_checksum: bool = True,
                             backend: Optional[str] = "device", *,
                             device="cuda") -> DecompressStream:
    return DecompressStream(dictionary, verify_checksum, backend,
                            device=device)


def compress_file(src_path: str, dst_path: str,
                  config: FrameConfig = DEFAULT_CONFIG,
                  dictionary=None, chunk_size: int = 1 << 22,
                  backend: Optional[str] = "device", *,
                  device="cuda") -> int:
    """Stream-compress a file; returns compressed byte count."""
    total = 0
    stream = CompressStream(config, dictionary, backend, device=device)
    with open(src_path, "rb") as fin, open(dst_path, "wb") as fout:
        while True:
            chunk = fin.read(chunk_size)
            if not chunk:
                break
            out = stream.write(chunk)
            total += len(out)
            fout.write(out)
        tail = stream.flush()
        total += len(tail)
        fout.write(tail)
    return total


def decompress_file(src_path: str, dst_path: str, dictionary=None,
                    verify_checksum: bool = True, chunk_size: int = 1 << 22,
                    backend: Optional[str] = "device", *,
                    device="cuda") -> int:
    """Stream-decompress a file; returns plaintext byte count."""
    total = 0
    stream = DecompressStream(dictionary, verify_checksum, backend,
                              device=device)
    with open(src_path, "rb") as fin, open(dst_path, "wb") as fout:
        while True:
            chunk = fin.read(chunk_size)
            if not chunk:
                break
            out = stream.write(chunk)
            total += len(out)
            fout.write(out)
    return total
