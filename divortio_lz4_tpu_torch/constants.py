"""LZ4 frame and block constants the port reads.

Copied from ``divortio_lz4_tpu/constants.py`` (values and helpers
unchanged), so the port does not import the JAX package.
"""

# Frame magic (little-endian on the wire) and version.
MAGIC_NUMBER = 0x184D2204
LZ4_VERSION = 1
# Skippable frames: any magic in this range, then a u32 length.
SKIPPABLE_MAGIC_MIN = 0x184D2A50
SKIPPABLE_MAGIC_MAX = 0x184D2A5F

# FLG byte bit masks.
FLG_VERSION_MASK = 0xC0
FLG_BLOCK_INDEPENDENCE = 0x20
FLG_BLOCK_CHECKSUM = 0x10
FLG_CONTENT_SIZE = 0x08
FLG_CONTENT_CHECKSUM = 0x04
FLG_DICT_ID = 0x01

# BD byte: block max sizes by id.
BLOCK_MAX_SIZES = {
    4: 65536,      # 64 KB
    5: 262144,     # 256 KB
    6: 1048576,    # 1 MB
    7: 4194304,    # 4 MB
}
DEFAULT_BLOCK_SIZE = BLOCK_MAX_SIZES[7]

# High bit of a block-size word marks a stored (uncompressed) block.
UNCOMPRESSED_FLAG = 0x80000000
BLOCK_SIZE_MASK = 0x7FFFFFFF

# Block codec constants of the reference encoder.
MIN_MATCH = 4
LAST_LITERALS = 5       # final bytes of a block must be literals
MF_LIMIT = 12           # match search stops MF_LIMIT bytes before block end
HASH_LOG = 14
HASH_SHIFT = 18
HASH_TABLE_SIZE = 1 << HASH_LOG     # 16384 entries
HASH_MASK = HASH_TABLE_SIZE - 1
HASH_MULTIPLIER = 2654435761
# The skip stride grows by one every 1 << SKIP_TRIGGER misses.
SKIP_TRIGGER = 6

# LZ4 match window: back-references reach at most 65535 bytes.
WINDOW_SIZE = 65536


def block_bound(n: int) -> int:
    """Worst-case compressed size of one n-byte block."""
    return n + (n // 255) + 16


def frame_bound(n: int, block_size: int = DEFAULT_BLOCK_SIZE) -> int:
    """Worst-case whole-frame size for an n-byte payload."""
    nblocks = max(1, -(-n // block_size))
    # max header: magic(4)+FLG(1)+BD(1)+size(8)+dictId(4)+HC(1) = 19
    return 19 + nblocks * 4 + n + (n // 255) + 16 * nblocks + 4 + 4


def get_block_id(nbytes: int) -> int:
    """Quantize a requested max block size to an LZ4 BD id (4..7)."""
    if not nbytes or nbytes <= 65536:
        return 4
    if nbytes <= 262144:
        return 5
    if nbytes <= 1048576:
        return 6
    return 7
