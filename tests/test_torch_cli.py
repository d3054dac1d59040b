"""The port's CLI (python -m divortio_lz4_tpu_torch) and its device example
held against the JAX package's on the CPU.

Both CLIs run on the same files: the port's with ``--torch-device cpu``,
JAX's on its CPU platform. Most cases call each ``main(argv)`` in this
process; stdin/stdout, the module entry and the no-GPU error run as
subprocesses. Output files are compared byte for byte (tolerance 0):

- ``--device`` files equal JAX's ``--device`` files on every engine;
- stream-path files equal JAX's stream frames with ``backend="device"``
  fed the CLI's 4 MiB chunks (the port's streams default to the device
  bursts). Where no burst runs (blocks over 64 KB, a dictionary) that is
  JAX's CLI file itself; with 64 KB blocks the burst's chain encoder
  writes other (valid) bytes than JAX's host-stream CLI, and each CLI
  decodes the other's file;
- decompressed files equal the corpus, through each route and engine.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import divortio_lz4_tpu.stream as jstream
from _torch_port import cuda, mixed_payload  # noqa: F401  (cuda: fixture)
from _torch_port import one_torch_thread  # noqa: F401  (fixture)
from divortio_lz4_tpu.__main__ import main as jax_main
from divortio_lz4_tpu.config import FrameConfig
from divortio_lz4_tpu_torch.__main__ import main as port_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = mixed_payload(300_000, 41)
DICT = mixed_payload(40_000, 43)

# name: (flags, FrameConfig of the stream path or None for --device)
COMPRESS = {
    "default": ([], FrameConfig()),
    "64k_indep_checksum": (["-b", "65536", "--independent", "--checksum"],
                           FrameConfig(block_size=65536,
                                       block_independence=True,
                                       content_checksum=True)),
    "block_checksums": (["--block-checksums"],
                        FrameConfig(block_checksums=True)),
    "64k_linked_block_checksums": (["-b", "65536", "--block-checksums"],
                                   FrameConfig(block_size=65536,
                                               block_checksums=True)),
    "256k_dictionary": (["-b", "262144", "-D", "DICT"],
                        FrameConfig(block_size=262144)),
    "64k_dictionary": (["-b", "65536", "--checksum", "-D", "DICT"],
                       FrameConfig(block_size=65536, content_checksum=True)),
    "device_split": (["--device", "-b", "65536", "--checksum"], None),
    "device_split_4m": (["--device", "--checksum", "-D", "DICT"], None),
    "device_hybrid": (["--device", "--engine", "hybrid", "-b", "65536"],
                      None),
    "device_pallas": (["--device", "--engine", "pallas", "-b", "65536",
                       "--block-checksums"], None),
    "device_xla": (["--device", "--engine", "xla", "-b", "65536",
                    "--checksum"], None),
}


def _files(tmp_path):
    src = tmp_path / "corpus.bin"
    src.write_bytes(DATA.tobytes())
    d = tmp_path / "dict.bin"
    d.write_bytes(DICT.tobytes())
    return str(src), str(d)


def _flags(flags, d):
    return [d if f == "DICT" else f for f in flags]


def _device_stream(cfg, dictionary):
    """JAX's stream frame with backend="device", fed 4 MiB chunks as the
    CLI feeds them."""
    cs = jstream.CompressStream(cfg, dictionary, "device")
    data = DATA.tobytes()
    return b"".join([cs.write(data[i: i + (1 << 22)])
                     for i in range(0, len(data), 1 << 22)] + [cs.flush()])


@pytest.mark.parametrize("name", list(COMPRESS))
def test_compress_matches_jax_cli(name, tmp_path, one_torch_thread):  # noqa: F811
    src, d = _files(tmp_path)
    flags, cfg = COMPRESS[name]
    flags = _flags(flags, d)
    j, p = str(tmp_path / "j.lz4"), str(tmp_path / "p.lz4")
    assert jax_main(["compress", src, "-o", j, *flags]) == 0
    assert port_main(["compress", src, "-o", p, *flags,
                      "--torch-device", "cpu"]) == 0
    got, jax_file = open(p, "rb").read(), open(j, "rb").read()
    if cfg is None:
        assert got == jax_file
    else:
        want = _device_stream(cfg, DICT if "-D" in COMPRESS[name][0]
                              else None)
        assert got == want
        if cfg.resolved_block_size > 65536 or "-D" in COMPRESS[name][0]:
            assert got == jax_file
    # each CLI decodes the other's file
    dflags = ["-D", d] if "-D" in flags and cfg is not None else []
    for tool, path, out in ((port_main, j, "pj.out"),
                            (jax_main, p, "jp.out")):
        extra = ["--torch-device", "cpu"] if tool is port_main else []
        assert tool(["decompress", path, "-o", str(tmp_path / out),
                     *dflags, *extra]) == 0
        assert (tmp_path / out).read_bytes() == DATA.tobytes()


DECOMPRESS = {
    "stream": [],
    "device_split": ["--device"],
    "device_pallas": ["--device", "--engine", "pallas"],
    "device_xla": ["--device", "--engine", "xla"],
}
FRAMES = {
    "64k_indep_checksum": ["-b", "65536", "--independent", "--checksum"],
    "256k_indep": ["-b", "262144", "--independent"],
    "default_linked": ["--checksum"],
}


@pytest.mark.parametrize("frame", list(FRAMES))
@pytest.mark.parametrize("route", list(DECOMPRESS))
def test_decompress_matches_jax_cli(route, frame, tmp_path,
                                    one_torch_thread):  # noqa: F811
    """JAX CLI's files decompress to the corpus through the port CLI's
    stream path and its --device engines. A successful decode has one
    right output, the corpus, so JAX's CLI decodes only on the stream
    route here, as the check that it gives the same."""
    src, _ = _files(tmp_path)
    comp = str(tmp_path / "c.lz4")
    assert jax_main(["compress", src, "-o", comp, *FRAMES[frame]]) == 0
    flags = DECOMPRESS[route]
    p = str(tmp_path / "p.out")
    assert port_main(["decompress", comp, "-o", p, *flags,
                      "--torch-device", "cpu"]) == 0
    assert open(p, "rb").read() == DATA.tobytes()
    if route == "stream":
        j = str(tmp_path / "j.out")
        assert jax_main(["decompress", comp, "-o", j]) == 0
        assert open(j, "rb").read() == DATA.tobytes()


@pytest.mark.parametrize("route", ["stream", "device_split"])
def test_no_verify_matches_jax_cli(route, tmp_path,
                                   one_torch_thread):  # noqa: F811
    """A flipped content checksum: both CLIs raise JAX's error, and with
    --no-verify both write the corpus."""
    src, _ = _files(tmp_path)
    comp = tmp_path / "c.lz4"
    assert jax_main(["compress", src, "-o", str(comp), "-b", "65536",
                     "--independent", "--checksum"]) == 0
    bad = bytearray(comp.read_bytes())
    bad[-1] ^= 0x01
    comp.write_bytes(bytes(bad))
    flags = DECOMPRESS[route]
    errors = []
    for tool, extra in ((jax_main, []), (port_main, ["--torch-device",
                                                     "cpu"])):
        with pytest.raises(ValueError) as e:
            tool(["decompress", str(comp), "-o", str(tmp_path / "x"),
                  *flags, *extra])
        errors.append(str(e.value))
        out = tmp_path / f"{len(errors)}.out"
        assert tool(["decompress", str(comp), "-o", str(out), "--no-verify",
                     *flags, *extra]) == 0
        assert out.read_bytes() == DATA.tobytes()
    assert errors[0] == errors[1] == "LZ4: Content Checksum Error"


def _run(args, data, env=None):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               **(env or {}))
    return subprocess.run([sys.executable, "-m", *args], input=data,
                          capture_output=True, cwd=REPO, env=env,
                          timeout=300)


def test_stdin_stdout_matches_jax_cli():
    """'-' is stdin/stdout: the module entry of each package, the same
    bytes each way, and JAX's summary line on stderr."""
    data = DATA.tobytes()
    flags = ["-b", "262144", "--checksum"]
    j = _run(["divortio_lz4_tpu", "compress", "-", *flags], data)
    p = _run(["divortio_lz4_tpu_torch", "compress", "-", *flags,
              "--torch-device", "cpu"], data)
    assert j.returncode == p.returncode == 0, p.stderr
    assert p.stdout == j.stdout
    assert p.stderr.decode().startswith(f"-: {len(data)} -> "
                                        f"{len(p.stdout)} bytes (")
    back = _run(["divortio_lz4_tpu_torch", "decompress", "-",
                 "--torch-device", "cpu"], p.stdout)
    assert back.returncode == 0, back.stderr
    assert back.stdout == data
    assert b"MB/s)" in back.stderr


def test_cuda_default_raises_without_gpu(tmp_path):
    """The default --torch-device is cuda: without a GPU the CLI exits
    non-zero with the port's RuntimeError, on the stream path and on
    --device, and writes no output."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    src, _ = _files(tmp_path)
    res = _run(["divortio_lz4_tpu_torch", "compress", src, "-o",
                str(tmp_path / "x.lz4")], b"")
    assert res.returncode != 0
    assert b"RuntimeError: device='cuda' but torch sees no CUDA GPU" \
        in res.stderr
    assert not (tmp_path / "x.lz4").exists()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        port_main(["compress", src, "-o", str(tmp_path / "y.lz4"),
                   "--device"])
    help_text = _run(["divortio_lz4_tpu_torch", "--help"], b"")
    assert b"'bench' subcommand is not in this CLI" in help_text.stdout


def test_torch_device_example_runs_on_cpu():
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples",
                                      "12_torch_device.py"),
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, (res.stdout[-2000:], res.stderr[-2000:])
    assert "sharded over 2 device(s)" in res.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["split", "pallas", "hybrid", "xla"])
def test_cuda_cli_device_matches_cpu(engine, cuda, tmp_path):  # noqa: F811
    """--device on the card: the CPU's file, and a round trip through the
    card's decoder."""
    src, _ = _files(tmp_path)
    files = {}
    for dev in ("cpu", "cuda"):
        files[dev] = str(tmp_path / f"{dev}.lz4")
        assert port_main(["compress", src, "-o", files[dev], "--device",
                          "-b", "65536", "--checksum", "--engine", engine,
                          "--torch-device", dev]) == 0
    assert open(files["cuda"], "rb").read() == open(files["cpu"], "rb").read()
    out = str(tmp_path / "out")
    dec = engine if engine != "hybrid" else "split"
    assert port_main(["decompress", files["cuda"], "-o", out, "--device",
                      "--engine", dec]) == 0
    assert open(out, "rb").read() == DATA.tobytes()
