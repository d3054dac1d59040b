"""The PyTorch/CUDA port's device path: the frame codec on one device, the
sharded codec over several, and single blocks on the device.

The counterpart of 06_tpu_device.py for divortio_lz4_tpu_torch. It runs on
the GPU by default; pass --device cpu to run the kernels' plain PyTorch
versions on the CPU instead.

    python examples/12_torch_device.py [--device cuda|cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import divortio_lz4_tpu_torch as lz4
from divortio_lz4_tpu_torch.parallel import ShardedCodec, make_mesh

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda",
                help="torch device: cuda (default) or cpu")
dev = ap.parse_args().device

data = np.frombuffer(b"device-side compression payload " * 8000, np.uint8)
cfg = lz4.FrameConfig(block_size=65536, block_independence=True)

# --- one device: the batched block kernels + host frame assembly ---
frame = lz4.compress_frame(data, cfg, device=dev)
out = lz4.decompress_frame(frame, device=dev)
assert bytes(out) == bytes(data)
print(f"device frame on {dev}: {len(data)} -> {len(frame)}")

# Frames interoperate with the host codec:
assert bytes(lz4.decompress(frame)) == bytes(data)

# --- sharded: blocks data-parallel across devices ---
devices = ["cpu", "cpu"] if dev == "cpu" else make_mesh()  # every GPU
codec = ShardedCodec(devices)
frame2 = codec.compress(data)
out2 = codec.decompress(frame2)
assert bytes(out2) == bytes(data)
print(f"sharded over {codec.ndev} device(s): {len(frame2)} bytes")

# --- one raw block on the device (ops/) ---
from divortio_lz4_tpu_torch.ops.decode_xla import decode_block_host
from divortio_lz4_tpu_torch.ops.encode_xla import encode_block_host

comp = encode_block_host(data[:4096], device=dev)
plain = decode_block_host(comp, 4096, device=dev)
assert bytes(plain) == bytes(data[:4096])
print(f"raw device block: 4096 -> {len(comp)}")
