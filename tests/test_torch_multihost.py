"""The port's MultiHostCodec (divortio_lz4_tpu_torch.parallel.multihost)
held against the JAX package's on the CPU.

``shard_bounds`` and ``split_frames`` are host copies and must give JAX's
spans. The single-process codec over ``["cpu"] * 2`` must give the stream
of JAX's ``MultiHostCodec`` (its mesh: the suite's 8 virtual CPU
devices), and a real two-process run on gloo must give, on rank 0, JAX's
two shard frames joined in order, with both ranks decoding the corpus.
Tolerance 0: bytes are compared.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import divortio_lz4_tpu as lz4
from _torch_port import cuda, mixed_payload  # noqa: F401  (cuda: fixture)
from _torch_port import one_torch_thread  # noqa: F401  (fixture)
from divortio_lz4_tpu.config import FrameConfig
from divortio_lz4_tpu.parallel import multihost as jmh
from divortio_lz4_tpu_torch.parallel import multihost as pmh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = FrameConfig(block_size=65536, block_independence=True)


@pytest.mark.parametrize("total", [0, 1, 7, 1_000_003])
def test_shard_bounds_match_jax(total):
    for nshards in (1, 2, 3, 7, 8):
        spans = [pmh.shard_bounds(total, nshards, i) for i in range(nshards)]
        assert spans == [jmh.shard_bounds(total, nshards, i)
                         for i in range(nshards)]
        assert spans[0][0] == 0 and spans[-1][1] == total


def test_split_frames_match_jax():
    a = mixed_payload(120_000, 1)
    b = mixed_payload(50_000, 2)[::-1].copy()
    f1 = lz4.compress(a, config=FrameConfig(block_size=65536,
                                            content_checksum=True))
    f2 = lz4.compress(b, config=FrameConfig(block_size=65536,
                                            block_independence=True,
                                            block_checksums=True))
    skip = np.frombuffer(b"\x50\x2a\x4d\x18\x04\x00\x00\x00PAYL", np.uint8)
    stream = np.concatenate([skip, f1, skip, f2, skip])
    spans = pmh.split_frames(stream)
    assert spans == jmh.split_frames(stream)
    assert len(spans) == 2
    with pytest.raises(ValueError, match="LZ4: Malformed Input"):
        pmh.split_frames(np.concatenate([f1, skip[:6]]))


def test_maybe_distributed_init_single_process(monkeypatch):
    for name in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert pmh.maybe_distributed_init() is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert pmh.maybe_distributed_init() is False
    assert not torch.distributed.is_initialized()


def test_single_process_matches_jax(one_torch_thread):  # noqa: F811
    """One process: the port's stream over two CPU devices == JAX's
    MultiHostCodec stream over its 8 CPU devices; each package decodes
    the other's."""
    data = mixed_payload(300_000, 3)
    jc = jmh.MultiHostCodec(CFG)
    pc = pmh.MultiHostCodec(CFG, devices=["cpu"] * 2)
    assert (pc.nproc, pc.pid) == (1, 0)
    want = jc.compress_corpus(data)
    got = pc.compress_corpus(data)
    assert isinstance(got, bytes) and got == want
    assert pc.decompress_corpus(want).tobytes() == data.tobytes()
    assert np.asarray(jc.decompress_corpus(got)).tobytes() == data.tobytes()
    assert np.asarray(lz4.decompress(np.frombuffer(got, np.uint8))) \
        .tobytes() == data.tobytes()


def test_simulated_two_process_decode(one_torch_thread):  # noqa: F811
    """JAX's simulated two-process decode (tests/test_multihost.py) on the
    port: each rank's share of the frames, decoded and joined in order."""
    pc = pmh.MultiHostCodec(CFG, devices=["cpu"])
    data = mixed_payload(300_000, 5)
    half = len(data) // 2
    stream = np.concatenate([pc.codec.compress(data[:half]),
                             pc.codec.compress(data[half:])])
    frames = pmh.split_frames(stream)
    assert len(frames) == 2
    parts = []
    for pid in range(2):
        lo, hi = pmh.shard_bounds(len(frames), 2, pid)
        parts += [pc.codec.decompress(np.array(stream[a:b]))
                  for a, b in frames[lo:hi]]
    assert np.concatenate(parts).tobytes() == data.tobytes()


RANK_MAIN = """
import sys
import numpy as np
import torch
from divortio_lz4_tpu_torch import FrameConfig
from divortio_lz4_tpu_torch.parallel.multihost import (
    MultiHostCodec, maybe_distributed_init)
torch.set_num_threads(1)
out_dir, n = sys.argv[1], int(sys.argv[2])
assert maybe_distributed_init() is True
assert maybe_distributed_init() is True
data = np.fromfile(out_dir + "/corpus.bin", np.uint8)
codec = MultiHostCodec(FrameConfig(block_size=65536, block_independence=True),
                       devices=["cpu"])
rank = codec.pid
assert codec.nproc == 2
stream = codec.compress_corpus(data)
assert (stream is None) == (rank != 0)
if rank == 0:
    open(out_dir + "/stream.lz4", "wb").write(stream)
    obj = [stream]
else:
    obj = [None]
torch.distributed.broadcast_object_list(obj, src=0)
plain = codec.decompress_corpus(obj[0])
open(f"{out_dir}/plain{rank}.bin", "wb").write(plain.tobytes())
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes_on_gloo(tmp_path):
    """Two real processes (torch's env names, gloo): rank 0's stream ==
    JAX's two shard frames joined in order, and both ranks decode the
    corpus. A hung rendezvous fails at the 120 s timeout."""
    data = mixed_payload(400_000, 9)
    data.tofile(tmp_path / "corpus.bin")
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=REPO, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(rank),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_MAIN, str(tmp_path), str(len(data))],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], outs
    codec = lz4.parallel.ShardedCodec(lz4.parallel.make_mesh(), CFG)
    half = pmh.shard_bounds(len(data), 2, 0)[1]
    want = b"".join(np.asarray(codec.compress(x)).tobytes()
                    for x in (data[:half], data[half:]))
    assert (tmp_path / "stream.lz4").read_bytes() == want
    for rank in range(2):
        assert (tmp_path / f"plain{rank}.bin").read_bytes() == data.tobytes()


@pytest.mark.cuda
def test_cuda_multihost_matches_cpu(cuda):  # noqa: F811
    """MultiHostCodec on the card: the CPU devices' stream, decoded
    exactly."""
    data = mixed_payload(2_000_000, 11)
    want = pmh.MultiHostCodec(CFG, devices=["cpu"]).compress_corpus(data)
    codec = pmh.MultiHostCodec(CFG, devices=[cuda])
    assert codec.compress_corpus(data) == want
    assert codec.decompress_corpus(want).tobytes() == data.tobytes()
    assert pmh.MultiHostCodec(CFG).codec.devices == \
        [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
