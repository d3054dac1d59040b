"""Every public name of the JAX package maps to the torch port.

For each module of ``divortio_lz4_tpu`` the test parses its source with
``ast`` (nothing of JAX is imported) and collects its public names: the
top-level functions, classes and assignments (also under a top-level
``if`` or ``try``), the entries of ``__all__``, ``__version__``, the names
a package ``__init__`` imports from its own submodules, and the names its
module ``__getattr__`` serves lazily. Each name must resolve in the port's
counterpart module (``MODULES``; a JAX module may map to several port
modules), or stand in ``JAX_ONLY`` with the reason it has no counterpart
of that name and, where one exists, the port name that does its work
(which must resolve too). Where both modules define ``__all__``, the JAX
entries must be in the port's. One case per JAX module, and one that fails
on a stale ``JAX_ONLY`` row: a name the port now has under the same name,
or one the JAX package no longer has.
"""

import ast
import importlib
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "divortio_lz4_tpu"
PORT = "divortio_lz4_tpu_torch"

# JAX module (path under divortio_lz4_tpu/, without .py) -> port modules
# (dotted, under divortio_lz4_tpu_torch; "" is the package itself).
MODULES = {
    "__init__": [""],
    "__main__": ["__main__"],
    "aio": ["aio"],
    "backends": ["backends"],
    "config": ["config"],
    "constants": ["constants"],
    "frame": ["frame"],
    "native/__init__": ["host"],
    "ops/__init__": ["ops"],
    "ops/assemble_xla": ["ops.assemble_xla"],
    "ops/block_ref": ["ops.block_ref"],
    "ops/decode_xla": ["ops.decode_xla"],
    "ops/encode_xla": ["ops.encode_xla"],
    "ops/hybrid_encode": ["ops.hybrid_encode"],
    "ops/linked_xla": ["ops.linked_xla"],
    "ops/pallas_decode": ["ops.token_decode"],
    "ops/pallas_encode": ["ops.greedy_encode"],
    "ops/pallas_split_decode": ["ops.split_decode", "ops.compact_decode",
                                "ops.wire_decode", "ops.stream_decode"],
    "ops/split_encode": ["ops.split_encode"],
    "ops/wave_decode": ["ops.wave_decode"],
    "parallel/__init__": ["parallel"],
    "parallel/bigblock": ["parallel.bigblock", "ops.wave_decode"],
    "parallel/device": ["parallel.device"],
    "parallel/multihost": ["parallel.multihost"],
    "parallel/sharding": ["parallel.sharding"],
    "raw": ["raw"],
    "scheduler": ["scheduler"],
    "stream": ["stream"],
    "types": ["types"],
    "utils/__init__": ["utils"],
    "utils/buffers": ["utils"],
    "utils/pool": ["utils"],
    "worker": ["worker"],
    "xxh/__init__": ["xxh"],
    "xxh/xxhash32": ["xxh"],
}

_TPU_LANES = ("the TPU's 128-lane vector width, which shapes the Pallas "
              "rows; CUDA kernels address bytes")
_TPU_SLACK = ("zero padding after a Pallas row for the kernel's 128-lane "
              "reads past the data; the CUDA kernels bound their reads")
_SPLIT_PLAN = ("TPU interleave planning of the split kernels (ways, trip "
               "bounds, SMEM and VMEM tiers); a GPU block walks its own "
               "records, so the bytes are the same without it")
_WAVE_SIZE = ("TPU wave sizing of the chain decode (VMEM and SMEM "
              "budgets); the CUDA chain kernel keeps a chain's records and "
              "output in device memory and needs no waves")
_SHARD_TIERS = ("shard_map dispatch of the split kernels' TPU density "
                "tiers; the port shards a frame's rows over torch devices")

# (JAX module, name) -> (why the port has no counterpart of that name, the
# port names that do its work or ()).
JAX_ONLY = {
    ("native/__init__", "AVAILABLE"): (
        "the JAX native library is optional; the port's host library is "
        "required, built at first use, and the package reports it",
        ("NATIVE_AVAILABLE",)),
    ("ops/hybrid_encode", "LANES"): (_TPU_LANES, ()),
    ("ops/hybrid_encode", "SLACK"): (_TPU_SLACK, ()),
    ("ops/hybrid_encode", "SMEM_CHAIN_BUDGET"): (
        "TPU SMEM budget of the walk kernel's chain operand; the CUDA walk "
        "reads the chain from device memory", ()),
    ("ops/pallas_decode", "LANES"): (_TPU_LANES, ()),
    ("ops/pallas_decode", "SLACK"): (
        _TPU_SLACK + "; the pallas router keeps the value to route frames "
        "as JAX does", ("parallel.device.PALLAS_SLACK",)),
    ("ops/pallas_decode", "SMEM_STREAM_BUDGET"): (
        "TPU SMEM budget of the linked kernel's streamed chunk; the CUDA "
        "kernel decodes a whole chain from device memory", ()),
    ("ops/pallas_decode", "VMEM_BUDGET"): (
        "TPU VMEM budget of the batched kernel; the pallas router keeps "
        "it to route frames as JAX does",
        ("parallel.device.PALLAS_VMEM_BUDGET",)),
    ("ops/pallas_decode", "pallas_row_bytes"): (
        "a block's VMEM footprint on the TPU; only the router's verdict "
        "is kept", ("parallel.device._pallas_indep_fits",)),
    ("ops/pallas_decode", "decode_linked_chunk_pallas"): (
        "renamed: the CUDA kernel runs whole chains, and the chunk "
        "contract sits on top of it", ("ops.token_decode.decode_linked_chunk",
                                       "ops.token_decode.decode_token_chains")),
    ("ops/pallas_encode", "SLACK"): (_TPU_SLACK, ()),
    ("ops/pallas_encode", "SMEM_WORDS_BUDGET"): (
        "TPU SMEM budget of the staged input words; the CUDA kernel reads "
        "its row from device memory", ()),
    ("ops/pallas_split_decode", "LANES"): (_TPU_LANES, ()),
    ("ops/pallas_split_decode", "REC_SPAN"): (
        "renamed: output bytes one record covers",
        ("ops.compact_decode.SPAN",)),
    ("ops/pallas_split_decode", "SMEM_BUDGET"): (_SPLIT_PLAN, ()),
    ("ops/pallas_split_decode", "VMEM_BUDGET"): (_SPLIT_PLAN, ()),
    ("ops/pallas_split_decode", "SMEM_COMPACT_WORDS"): (_SPLIT_PLAN, ()),
    ("ops/pallas_split_decode", "UNROLL"): (_SPLIT_PLAN, ()),
    ("ops/pallas_split_decode", "plan_ways"): (_SPLIT_PLAN, ()),
    ("ops/pallas_split_decode", "plan_ways_compact"): (_SPLIT_PLAN, ()),
    ("ops/pallas_split_decode", "plan_ways_wire"): (_SPLIT_PLAN, ()),
    ("ops/pallas_split_decode", "grouped_trips"): (_SPLIT_PLAN, ()),
    ("ops/pallas_split_decode", "build_sorted_batch"): (
        _SPLIT_PLAN, ("ops.split_decode.parse_block_batch",)),
    ("ops/pallas_split_decode", "partition_by_plan"): (
        _SPLIT_PLAN, ("ops.wire_decode.parse_wire_batch",)),
    ("ops/pallas_split_decode", "build_compact_batch"): (
        "its record packing, without the interleave padding, is the flat "
        "(CSR) record batch", ("ops.split_decode.build_flat_records",)),
    ("ops/pallas_split_decode", "stage_compact"): (
        _SPLIT_PLAN, ("parallel.device._decode_independent_split",)),
    ("ops/pallas_split_decode", "dispatch_compact"): (
        _SPLIT_PLAN, ("ops.compact_decode.decode_blocks_compact",)),
    ("ops/pallas_split_decode", "decode_blocks_wire_compact"): (
        "the compact-stream TPU kernel's entry, renamed for its CUDA "
        "kernel", ("ops.compact_decode.decode_blocks_compact",)),
    ("ops/pallas_split_decode", "dispatch_partitioned"): (
        _SPLIT_PLAN, ("ops.wire_decode.decode_blocks_wire",)),
    ("ops/wave_decode", "WAVE_CHUNK"): (_WAVE_SIZE, ()),
    ("ops/wave_decode", "MAX_WAVE_RECS"): (_WAVE_SIZE, ()),
    ("ops/wave_decode", "WAVE_CHUNK_BY_WAYS"): (_WAVE_SIZE, ()),
    ("ops/wave_decode", "WAVE_RECS_BY_WAYS"): (_WAVE_SIZE, ()),
    ("ops/wave_decode", "WAVE_VMEM_BUDGET"): (_WAVE_SIZE, ()),
    ("ops/wave_decode", "plan_waves"): (
        _WAVE_SIZE + "; planning is per chain", ("ops.wave_decode.plan_blocks",
                                                 "ops.wave_decode.stage_chains")),
    ("ops/wave_decode", "decode_chain_waves"): (
        "the wave kernel's entry, renamed for the chain kernel",
        ("ops.wave_decode.decode_chains",)),
    ("ops/wave_decode", "decompress_frame_waves"): (
        "renamed with the chain kernel; it never declines a frame",
        ("ops.wave_decode.decompress_frame_chains",)),
    ("ops/wave_decode", "waves_assemble"): (
        "the chain kernel writes every chain in plaintext order: there are "
        "no waves to splice", ("ops.wave_decode.decode_chains",)),
    ("parallel/bigblock", "LANES"): (_TPU_LANES, ()),
    ("parallel/bigblock", "PIECE_TARGET"): (
        "piece size of the TPU decode rows; the port cuts pieces at the "
        "64 KB window", ("ops.wave_decode.block_pieces",)),
    ("parallel/bigblock", "PIECE_CAP"): (
        "the largest piece a TPU decode row holds; the chain kernel takes "
        "a block whole", ()),
    ("parallel/bigblock", "scan_pieces"): (
        "the piece scan is the host library's, called per block",
        ("host.scan_pieces_native", "ops.wave_decode.block_pieces")),
    ("parallel/bigblock", "compress_frame_big"): (
        "split in two so that every frame's device work is queued before "
        "one fetch", ("parallel.bigblock.queue_frame_big",
                      "parallel.bigblock.splice_blocks_big")),
    ("parallel/bigblock", "compress_frames_big"): (
        "the frame batch queues big-block frames with the others",
        ("parallel.device.compress_frames",)),
    ("parallel/bigblock", "decompress_frame_big"): (
        "big blocks decode as chains",
        ("ops.wave_decode.decompress_frame_chains",)),
    ("parallel/device", "stage_sharded_tiers"): (
        _SHARD_TIERS, ("parallel.sharding.ShardedCodec",
                       "parallel.device.shard_spans")),
    ("parallel/device", "plan_sharded_tiers"): (
        _SHARD_TIERS, ("parallel.device.shard_spans",)),
    ("parallel/device", "dispatch_sharded_tiers"): (
        _SHARD_TIERS, ("parallel.sharding.ShardedCodec",)),
    ("parallel/device", "stage_sharded_compact"): (
        _SHARD_TIERS, ("parallel.sharding.ShardedCodec",)),
}


def _jax_modules() -> list:
    return sorted(str(p.relative_to(JAX_PKG).with_suffix(""))
                  for p in JAX_PKG.rglob("*.py"))


def _assigned(body, out: set) -> None:
    """Names bound at the top level of *body*, through if / try blocks."""
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                out.update(n.id for n in ast.walk(t)
                           if isinstance(n, ast.Name))
        elif isinstance(node, ast.If):
            _assigned(node.body + node.orelse, out)
        elif isinstance(node, ast.Try):
            _assigned(node.body + node.orelse + node.finalbody, out)
            for h in node.handlers:
                _assigned(h.body, out)


def _public_names(module: str):
    """(public names, __all__ entries or None) of a JAX module's source."""
    tree = ast.parse((JAX_PKG / f"{module}.py").read_text())
    bound: set = set()
    _assigned(tree.body, bound)
    names = {n for n in bound if not n.startswith("_")}
    if "__version__" in bound:
        names.add("__version__")
    all_ = None
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            all_ = list(ast.literal_eval(node.value))
            names.update(all_)
        elif module.endswith("__init__") and isinstance(node, ast.ImportFrom) \
                and node.level == 1:
            names.update(a.asname or a.name for a in node.names
                         if not (a.asname or a.name).startswith("_"))
        elif isinstance(node, ast.FunctionDef) and node.name == "__getattr__":
            names.update(c.value for c in ast.walk(node)
                         if isinstance(c, ast.Constant)
                         and isinstance(c.value, str)
                         and c.value.isidentifier()
                         and not c.value.startswith("_"))
    return names, all_


def _port_module(dotted: str):
    return importlib.import_module(f"{PORT}.{dotted}" if dotted else PORT)


def _port_has(modules, name: str) -> bool:
    return any(hasattr(_port_module(m), name) for m in modules)


def _resolve(path: str):
    """A JAX_ONLY row's port name: the longest importable module prefix,
    then attributes."""
    parts = path.split(".")
    for k in range(len(parts), -1, -1):
        try:
            obj = _port_module(".".join(parts[:k]))
        except ImportError:
            continue
        for p in parts[k:]:
            obj = getattr(obj, p)
        return obj
    raise ImportError(path)


def test_module_map_covers_the_jax_package():
    """Every JAX module has a row in MODULES, and every row a JAX module."""
    assert sorted(MODULES) == _jax_modules()


@pytest.mark.parametrize("module", sorted(MODULES))
def test_jax_names_resolve_in_the_port(module):
    names, all_ = _public_names(module)
    ports = MODULES[module]
    missing = sorted(n for n in names if not _port_has(ports, n)
                     and (module, n) not in JAX_ONLY)
    assert not missing, (f"divortio_lz4_tpu/{module}.py names with no "
                         f"counterpart in {ports}: {missing}")
    for n in sorted(names):
        row = JAX_ONLY.get((module, n))
        if row is not None:
            reason, port_names = row
            assert reason
            for p in port_names:
                _resolve(p)
    port_all = [getattr(_port_module(m), "__all__", None) for m in ports]
    if all_ is not None and port_all[0] is not None:
        assert not set(all_) - set(port_all[0]), (
            f"{ports[0]}.__all__ lacks JAX's "
            f"{sorted(set(all_) - set(port_all[0]))}")


def test_jax_only_rows_are_current():
    """A JAX_ONLY row names a JAX public name that the port's counterpart
    modules do not have."""
    stale = []
    for (module, name), (reason, _) in sorted(JAX_ONLY.items()):
        if module not in MODULES or name not in _public_names(module)[0]:
            stale.append((module, name, "gone from the JAX package"))
        elif _port_has(MODULES[module], name):
            stale.append((module, name, "the port now has it"))
    assert not stale, stale
