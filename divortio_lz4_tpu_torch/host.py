"""ctypes bindings of the port's host library, ``csrc/host_kernels.cpp``.

The wrappers and the error table are copies of
``divortio_lz4_tpu/native/__init__.py`` (``xxhash32_native``,
``scan_pieces_native``, ``parse_records_native``, ``parse_records2_native``,
``chain_serialize16_native``, ``chain_serialize16_meta_native``,
``warm_table_native``, ``compress_frame_body_native``,
``decompress_frame_body_native``, ``xxh32_round4_native``,
``compress_block_native``, ``decompress_block_native``), with JAX's
``_nthreads`` rule (``LZ4T_THREADS``, default min(cores, 16)). The
library is built with g++ at its first use (``_build.py``), never at
import. Every function validates its buffers in Python before passing
pointers, and raises "LZ4: ..." ValueErrors on the C error codes.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from ._build import load_library

_ERRORS = {
    -1: "LZ4: Output Buffer Too Small",
    -2: "LZ4: Malformed Input",
    -3: "LZ4: Invalid Offset 0",
    -4: "LZ4: Dictionary Offset Out of Bounds",
    -5: "LZ4: Block Checksum Error",
}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library("host_kernels")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    lib.lz4t_xxhash32.restype = ctypes.c_uint32
    lib.lz4t_xxhash32.argtypes = [p, i64, ctypes.c_uint32]
    lib.lz4t_scan_pieces.restype = i64
    lib.lz4t_scan_pieces.argtypes = [p, i64, i64, p, p, p, i64]
    lib.lz4t_parse_records.restype = i64
    lib.lz4t_parse_records.argtypes = [p, i64, p, i64, p, i64, i64,
                                       ctypes.POINTER(i64)]
    lib.lz4t_parse_records2.restype = i64
    lib.lz4t_parse_records2.argtypes = [p, i64, i64, p, i64, i64,
                                        ctypes.POINTER(i64)]
    lib.lz4t_chain_serialize16.restype = i64
    lib.lz4t_chain_serialize16.argtypes = [p, i64, i64, p, p]
    lib.lz4t_chain_serialize16m.restype = i64
    lib.lz4t_chain_serialize16m.argtypes = [p, i64, i64, p, p,
                                            ctypes.POINTER(i64)]
    lib.lz4t_warm_table.restype = None
    lib.lz4t_warm_table.argtypes = [p, p, i64]
    lib.lz4t_compress_frame_body.restype = i64
    lib.lz4t_compress_frame_body.argtypes = [p, i64, i64, p, i64, i64, p,
                                             ctypes.c_int32, ctypes.c_int32]
    lib.lz4t_compress_frame_body_mt.restype = i64
    lib.lz4t_compress_frame_body_mt.argtypes = [p, i64, i64, p, i64, i64,
                                                p, i32, i32]
    lib.lz4t_decompress_frame_body.restype = i64
    lib.lz4t_decompress_frame_body.argtypes = [p, i64, i64, p, i64, p, i64,
                                               i32, i32, i32,
                                               ctypes.POINTER(i64)]
    lib.lz4t_decompress_frame_body_mt.restype = i64
    lib.lz4t_decompress_frame_body_mt.argtypes = [p, i64, i64, p, i64, p,
                                                  i64, i64, i32, i32, i32,
                                                  ctypes.POINTER(i64)]
    lib.lz4t_xxh32_round4.restype = None
    lib.lz4t_xxh32_round4.argtypes = [p, p, i64]
    lib.lz4t_compress_block.restype = i64
    lib.lz4t_compress_block.argtypes = [p, p, i64, i64, p, i64]
    lib.lz4t_decompress_block.restype = i64
    lib.lz4t_decompress_block.argtypes = [p, i64, i64, p, i64, i64, p, i64]
    return lib


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_void_p)


def xxhash32_native(buf: np.ndarray, seed: int = 0) -> int:
    buf = np.ascontiguousarray(buf)
    return int(_lib().lz4t_xxhash32(_ptr(buf), buf.nbytes,
                                    seed & 0xFFFFFFFF))


def scan_pieces_native(src: np.ndarray, target: int):
    """Split a block's sequence stream at sequence boundaries into pieces of
    >= target output bytes (see lz4t_scan_pieces). Returns int64 arrays
    (wire_off, wire_len, out_len); raises the host error taxonomy on
    malformed streams."""
    src = np.ascontiguousarray(src, dtype=np.uint8)
    n = len(src)
    # Every piece but the last outputs >= target >= 4 bytes and costs >= 3
    # wire bytes, so n//3 + 2 bounds the count.
    cap = n // 3 + 2
    wo = np.empty(cap, np.int64)
    wl = np.empty(cap, np.int64)
    ol = np.empty(cap, np.int64)
    rc = int(_lib().lz4t_scan_pieces(_ptr(src), n, target,
                                     _ptr(wo), _ptr(wl), _ptr(ol), cap))
    if rc < 0:
        raise ValueError(_ERRORS.get(rc, "LZ4: Malformed Input"))
    return wo[:rc], wl[:rc], ol[:rc]


def parse_records_native(src: np.ndarray, lit: np.ndarray, out_cap: int,
                         dict_len: int = 0):
    """Placed-literal record parse (see lz4t_parse_records): place the
    block's literal bytes into *lit* at their output offsets and return
    (recs u32[nrec, 2], out_len), recs[k] = (offset | mlen<<16, dst), each
    match record at most 128 bytes with its source written before it runs.
    Raises the host error taxonomy on malformed streams."""
    src = np.ascontiguousarray(src, dtype=np.uint8)
    if lit.dtype != np.uint8 or not lit.flags.c_contiguous \
            or not lit.flags.writeable:
        raise ValueError("lit must be a writable contiguous uint8 array")
    if len(lit) < out_cap:
        raise ValueError(f"lit holds {len(lit)} bytes < out_cap={out_cap}")
    n = len(src)
    # Every match (>= 3 wire bytes) emits <= 7 doubling records (1+2+...+64
    # covers 127 bytes); everything past a match's first 127 output bytes
    # arrives as 128-byte far splits, bounded by out_cap // 128 overall.
    cap = (n // 3) * 7 + out_cap // 128 + 8
    recs = np.empty((cap, 2), np.uint32)
    out_len = ctypes.c_int64(0)
    rc = int(_lib().lz4t_parse_records(
        _ptr(src), n, _ptr(lit), out_cap, _ptr(recs), cap, dict_len,
        ctypes.byref(out_len)))
    if rc < 0:
        raise ValueError(_ERRORS.get(rc, "LZ4: Malformed Input"))
    return recs[:rc], int(out_len.value)


def parse_records2_native(src: np.ndarray, out_cap: int, dict_len: int = 0):
    """Wire-direct record parse (see lz4t_parse_records2). Returns (recs
    u32[nrec, 2], out_len), recs[k] = (src, offset | ll<<16 | ml<<24), the
    record's output position being the running sum of (ll+ml). Raises the
    host error taxonomy on malformed streams."""
    src = np.ascontiguousarray(src, dtype=np.uint8)
    n = len(src)
    # <= 1 combined + literal chunks + 7 doubling + far chunks per sequence
    # (>= 3 wire bytes each); full 128-byte chunks are also bounded by
    # out_cap // 128 overall.
    cap = (n // 3 + 1) * 9 + out_cap // 128 + 8
    recs = np.empty((cap, 2), np.uint32)
    out_len = ctypes.c_int64(0)
    rc = int(_lib().lz4t_parse_records2(
        _ptr(src), n, out_cap, _ptr(recs), cap, dict_len,
        ctypes.byref(out_len)))
    if rc < 0:
        raise ValueError(_ERRORS.get(rc, "LZ4: Malformed Input"))
    return recs[:rc], int(out_len.value)


def _check_serialize(work, hist_len, src_len, dist16, out):
    if work.dtype != np.uint8 or not work.flags.c_contiguous:
        raise ValueError("work must be a contiguous uint8 array")
    if dist16.dtype != np.uint16 or not dist16.flags.c_contiguous:
        raise ValueError("dist16 must be a contiguous uint16 array")
    if out.dtype != np.uint8 or not out.flags.c_contiguous:
        raise ValueError("out must be a contiguous uint8 array")
    if len(work) < hist_len + src_len + 8 or len(dist16) < src_len:
        raise ValueError("work needs 8 readable bytes past hist_len + "
                         "src_len, and dist16 src_len entries")
    if len(out) < src_len + src_len // 255 + 16:
        raise ValueError("out is smaller than block_bound(src_len)")


def chain_serialize16_native(work: np.ndarray, hist_len: int, src_len: int,
                             dist16: np.ndarray, out: np.ndarray) -> int:
    """Greedy select + exact extension + serialize over a u16 distance
    chain (see lz4t_chain_serialize16). Returns bytes written."""
    _check_serialize(work, hist_len, src_len, dist16, out)
    return int(_lib().lz4t_chain_serialize16(
        _ptr(work), hist_len, src_len, _ptr(dist16), _ptr(out)))


def chain_serialize16_meta_native(work: np.ndarray, hist_len: int,
                                  src_len: int, dist16: np.ndarray,
                                  out: np.ndarray):
    """chain_serialize16_native plus the big-block splicer's meta lanes
    (trailing-token position, trailing literal count, last match stream
    offset or -1, last match output anchor or -1). Returns (bytes written,
    meta i64[4])."""
    _check_serialize(work, hist_len, src_len, dist16, out)
    meta = (ctypes.c_int64 * 4)()
    n = int(_lib().lz4t_chain_serialize16m(
        _ptr(work), hist_len, src_len, _ptr(dist16), _ptr(out), meta))
    return n, np.array(meta[:], np.int64)


def warm_table_native(table: np.ndarray, buf: np.ndarray, limit: int) -> None:
    """Insert positions [0, limit - 4] of *buf* into the greedy encoder's
    hash table (i32[16384], entries pos + 1): a dictionary's warm-up."""
    if table.dtype != np.int32 or not table.flags.c_contiguous \
            or len(table) != 1 << 14:
        raise ValueError("table must be a contiguous int32[16384]")
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    if limit > len(buf):
        raise ValueError(f"limit {limit} > buffer length {len(buf)}")
    _lib().lz4t_warm_table(_ptr(table), _ptr(buf), limit)


def _nthreads() -> int:
    """Threads of the whole-frame loops: LZ4T_THREADS, else min(cores,
    16)."""
    env = os.environ.get("LZ4T_THREADS")
    if env is not None:
        return max(1, int(env))
    return min(os.cpu_count() or 1, 16)


def compress_frame_body_native(working: np.ndarray, input_start: int,
                               total_end: int, out: np.ndarray, dst_off: int,
                               block_size: int, table: np.ndarray,
                               independent: bool,
                               block_checksums: bool) -> int:
    """Every block of a frame in one native call (see
    lz4t_compress_frame_body): size words, greedy blocks or their stored
    fallback, block checksums, the EndMark. Independent frames compress
    their blocks on ``_nthreads()`` threads (lz4t_compress_frame_body_mt,
    the serial path's bytes). *working* = [dictionary | payload] with >= 16
    readable bytes past total_end (the literal copies run in 16-byte
    chunks); *out* holds the body's worst case plus 16 bytes past dst_off.
    Returns bytes written."""
    if working.dtype != np.uint8 or not working.flags.c_contiguous \
            or len(working) < total_end + 16:
        raise ValueError("working must be contiguous uint8 with 16 readable "
                         "bytes past total_end")
    if table.dtype != np.int32 or not table.flags.c_contiguous \
            or len(table) != 1 << 14:
        raise ValueError("table must be a contiguous int32[16384]")
    n = total_end - input_start
    nblocks = max(1, -(-n // block_size))
    need = nblocks * 8 + n + n // 255 + 16 * nblocks + 4 + 16
    if out.dtype != np.uint8 or not out.flags.c_contiguous \
            or len(out) - dst_off < need:
        raise ValueError(f"out needs {need} bytes past dst_off")
    if independent:
        return int(_lib().lz4t_compress_frame_body_mt(
            _ptr(working), input_start, total_end, _ptr(out), dst_off,
            block_size, _ptr(table), int(block_checksums), _nthreads()))
    return int(_lib().lz4t_compress_frame_body(
        _ptr(working), input_start, total_end, _ptr(out), dst_off,
        block_size, _ptr(table), 0, int(block_checksums)))


def decompress_frame_body_native(buf: np.ndarray, pos: int, n: int,
                                 result: np.ndarray, dictionary,
                                 independent: bool, block_checksums: bool,
                                 verify: bool,
                                 block_max: int = 4194304) -> tuple[int, int]:
    """Every block of a frame, direct-write, in one native call (see
    lz4t_decompress_frame_body) into *result*, sized by the frame's
    content size. Independent frames decode their blocks on threads when
    ``_nthreads()`` is 4 or more (below that the extra scratch pass loses,
    as JAX measured). Returns (plaintext bytes, wire position past the
    EndMark); raises the host error taxonomy."""
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    if result.dtype != np.uint8 or not result.flags.c_contiguous \
            or not result.flags.writeable:
        raise ValueError("result must be a writable contiguous uint8 array")
    if not 0 <= pos <= n <= len(buf):
        raise ValueError(f"need 0 <= pos <= n <= {len(buf)}")
    if dictionary is not None:
        dictionary = np.ascontiguousarray(dictionary, dtype=np.uint8)
        dptr, dlen = _ptr(dictionary), len(dictionary)
    else:
        dptr, dlen = None, 0
    wire_end = ctypes.c_int64(pos)
    if independent and _nthreads() >= 4:
        rc = int(_lib().lz4t_decompress_frame_body_mt(
            _ptr(buf), pos, n, _ptr(result), len(result), dptr, dlen,
            block_max, int(block_checksums), int(verify), _nthreads(),
            ctypes.byref(wire_end)))
    else:
        rc = int(_lib().lz4t_decompress_frame_body(
            _ptr(buf), pos, n, _ptr(result), len(result), dptr, dlen,
            int(independent), int(block_checksums), int(verify),
            ctypes.byref(wire_end)))
    if rc < 0:
        raise ValueError(_ERRORS.get(rc, f"LZ4: native error {rc}"))
    return rc, int(wire_end.value)


def xxh32_round4_native(v1, v2, v3, v4, words: np.ndarray):
    """Consume len(words) // 4 full 16-byte stripes (u32 lanes) into the
    streaming hasher's accumulators; returns the new (v1, v2, v3, v4)."""
    v = np.array([v1, v2, v3, v4], dtype=np.uint32)
    words = np.ascontiguousarray(words, dtype=np.uint32)
    _lib().lz4t_xxh32_round4(_ptr(v), _ptr(words), len(words))
    return int(v[0]), int(v[1]), int(v[2]), int(v[3])


def compress_block_native(src, dst: np.ndarray, src_start: int,
                          src_len: int, hash_table: np.ndarray,
                          dst_off: int) -> int:
    """Greedy-compress src[src_start : src_start + src_len] into *dst* at
    dst_off (see lz4t_compress_block), matches reaching back into
    src[:src_start] through the warmed *hash_table*. Returns bytes
    written."""
    src = np.ascontiguousarray(src, dtype=np.uint8)
    if dst.dtype != np.uint8 or not dst.flags.c_contiguous \
            or not dst.flags.writeable:
        raise ValueError("dst must be a writable contiguous uint8 array")
    if hash_table.dtype != np.int32 or not hash_table.flags.c_contiguous \
            or len(hash_table) != 1 << 14:
        raise ValueError("hash_table must be a contiguous int32[16384]")
    if src_start + src_len > len(src):
        raise ValueError(f"src holds {len(src)} bytes < src_start + src_len")
    if len(dst) - dst_off < src_len + src_len // 255 + 16:
        raise ValueError("dst is smaller than block_bound(src_len)")
    return int(_lib().lz4t_compress_block(
        _ptr(src), _ptr(dst), src_start, src_len, _ptr(hash_table),
        dst_off))


def decompress_block_native(src, src_off: int, src_len: int,
                            dst: np.ndarray, dst_off: int,
                            dictionary=None) -> int:
    """Decode the block src[src_off : src_off + src_len] into *dst* at
    dst_off, back-references before index 0 of *dst* reading *dictionary*
    from its end (see lz4t_decompress_block). Returns bytes written;
    raises the host error taxonomy on malformed blocks."""
    src = np.ascontiguousarray(src, dtype=np.uint8)
    if dst.dtype != np.uint8 or not dst.flags.c_contiguous \
            or not dst.flags.writeable:
        raise ValueError("dst must be a writable contiguous uint8 array")
    if src_off + src_len > len(src):
        raise ValueError(f"src holds {len(src)} bytes < src_off + src_len")
    if dictionary is not None:
        dictionary = np.ascontiguousarray(dictionary, dtype=np.uint8)
        dptr, dlen = _ptr(dictionary), len(dictionary)
    else:
        dptr, dlen = None, 0
    rc = int(_lib().lz4t_decompress_block(
        _ptr(src), src_off, src_len, _ptr(dst), len(dst), dst_off, dptr,
        dlen))
    if rc < 0:
        raise ValueError(_ERRORS.get(rc, f"LZ4: native error {rc}"))
    return rc
