"""Data-parallel frame codec over a list of torch devices.

Port of ``divortio_lz4_tpu/parallel/sharding.py:37-306`` (``make_mesh``,
``ShardedCodec``). A frame's block rows split into contiguous shards, one
per device (``parallel/device.py:shard_spans``, JAX's padded split without
the padding rows); each device runs the batched block kernels on its
shard, and the outputs join in block order on the host. Blocks are
independent, so nothing crosses devices: there is no ``shard_map``, psum
or padding-row analog, and a device whose shard would hold only padding
is skipped. Linked frames shard at encode time as in JAX: every block's
row carries its 64 KB window of known plaintext (``[history | payload]``
rows, JAX ``_compress_linked``), so the chain disappears. Linked decode is
sequential and runs on the first device, as JAX runs it on one.

Routes, as JAX takes them:

- ``engine="xla"`` (the default): encode through ``encode_blocks_batch``
  a shard; decode of independent frames through ``decode_blocks_batch`` a
  shard, linked frames through ``decode_linked_scan`` on ``devices[0]``.
- ``engine="best"``, blocks up to 64 KB (otherwise "xla"): encode through
  ``encode_blocks_hybrid`` (chains, then the walk kernel) a shard; decode
  as the split engine: independent frames with blocks up to 256 KB go
  shard by shard to the compact (<= 64 KB) or the wire kernel, sized by
  the frame header's block size, not the codec's; other frames take the
  split engine's single-device routes on ``devices[0]``.

Linked frames with block checksums encode on the host frame encoder, as
in JAX. A dictionary feeds every row's history. The TPU planning JAX
wraps around the split kernels (``stage_sharded_compact``,
``stage_sharded_tiers``: interleave ways, SMEM tiers) is not ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from .._device import resolve_device
from ..config import FrameConfig
from ..frame import compress_frame as compress_frame_host
from ..ops.hybrid_encode import hybrid_max_bs
from ..utils import ensure_buffer
from .device import (_dict_window, _fetch_all, _finish_frame,
                     _queue_compress_rows, _stage_frame)

ENGINES = ("xla", "best")


def make_mesh(n_devices: Optional[int] = None) -> list:
    """The first *n_devices* CUDA devices (default: every one) as a list of
    torch.device. Raises RuntimeError where there are fewer; never hands
    back the CPU (pass ``["cpu"] * n`` to ShardedCodec for that)."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    want = have if n_devices is None else n_devices
    if want < 1 or want > have:
        raise RuntimeError(f"make_mesh({n_devices}) needs "
                           f"{max(want, 1)} CUDA device(s); torch sees "
                           f"{have}")
    return [torch.device("cuda", i) for i in range(want)]


class ShardedCodec:
    """Data-parallel frame codec over a list of devices.

    compress/decompress mirror the one-shot frame API but run every block
    kernel sharded across *devices* (any torch devices, repeats allowed;
    default ``make_mesh()``, every CUDA device). Frames are byte-identical
    to the JAX ``ShardedCodec``'s with the same configuration and engine.
    """

    def __init__(self, devices=None, config: Optional[FrameConfig] = None,
                 use_fingerprints: bool = True, engine: str = "xla"):
        """engine: "xla" (the data-parallel torch-op codec on every device)
        or "best" (hybrid encoder + split decoder on every device, blocks
        up to 64 KB; the XLA codec for bigger ones)."""
        if engine not in ENGINES:
            raise ValueError(f"ShardedCodec has no engine={engine!r}; "
                             f"{', '.join(repr(e) for e in ENGINES)} are the "
                             "engines")
        devices = make_mesh() if devices is None else list(devices)
        if not devices:
            raise ValueError("ShardedCodec needs at least one device")
        self.devices = [resolve_device(d) for d in devices]
        self.ndev = len(self.devices)
        self.config = (config if config is not None
                       else FrameConfig(block_size=65536,
                                        block_independence=True))
        self.use_fingerprints = use_fingerprints
        self.engine = engine
        self._use_best = (engine == "best" and
                          self.config.resolved_block_size <= hybrid_max_bs())

    def compress(self, data, dictionary=None):
        """Compress to a spec-exact LZ4 frame (np.uint8), block rows
        sharded over the devices; linked frames shard too (per-row
        windows of known plaintext)."""
        cfg = self.config
        raw = ensure_buffer(data)
        if not cfg.block_independence and cfg.block_checksums:
            return compress_frame_host(raw, dictionary, cfg)
        window, dict_id = _dict_window(dictionary)
        tensors, finish = _queue_compress_rows(
            raw, cfg, window, dict_id, self.devices[0],
            "hybrid" if self._use_best else "xla", self.use_fingerprints,
            "host", shards=self.devices)
        return finish(_fetch_all(tensors))

    def decompress(self, data, verify_checksum: bool = True,
                   dictionary=None):
        """Decompress a frame (np.uint8): an independent frame's blocks
        sharded over the devices, anything else on the first device. The
        kernels' output capacity is the frame header's block size."""
        window, dict_id = _dict_window(dictionary)
        state = _stage_frame(ensure_buffer(data), verify_checksum, window,
                             dict_id, self.devices[0],
                             "split" if self._use_best else "xla",
                             shards=self.devices)
        return _finish_frame(state, _fetch_all(state.tensors),
                             verify_checksum)
