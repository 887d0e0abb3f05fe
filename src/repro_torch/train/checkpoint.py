"""Fault-tolerant checkpointing in the reference's on-disk format — the
port of ``repro/train/checkpoint.py``; a checkpoint crosses between the
two packages both ways.

Layout (one directory per step)::

    <dir>/step_00000123/
        meta.msgpack          step, time, metadata, and per leaf its
                              path, shape and numpy dtype name
        shard_p0.msgpack.zst  {path: tagged payload} of this process
    <dir>/LATEST              text file naming the last *committed* step

A leaf's path is its ``jax.tree_util.keystr`` string
(``['params']['layers']['wq']``, ``['opt']['step']``), leaves in the
reference's flatten order (sorted keys). A payload is a one-byte codec
tag and the compressed raw bytes: ``Z`` zstd when ``zstandard`` is
installed, else ``z`` zlib, so the tag, not the host, picks the
decompressor. Leaves are compressed and decompressed on a thread pool
(both codecs release the GIL); the bytes are the same as one at a time.

Commit protocol: payloads go to ``step_X.tmp/``, the directory is
atomically renamed, then LATEST is atomically replaced — a crash
mid-save never corrupts the previous checkpoint. ``restore(..., device=)``
puts every leaf on one device (the counterpart of the reference's
``shardings=``); by default each leaf goes where its template leaf is.
"""

from __future__ import annotations

import os
import shutil
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import msgpack
import torch

from ..tree import tree_leaves_with_path, tree_unflatten

try:  # zstandard is optional — stdlib zlib is the fallback wire format
    import zstandard
except ImportError:  # pragma: no cover - depends on environment
    zstandard = None

__all__ = ["save", "restore", "latest_step", "available_steps", "prune_old"]

_ZSTD_LEVEL = 3
_ZLIB_LEVEL = 6

#: numpy dtype names (the reference's ``meta``) ↔ torch dtypes
DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int64": torch.int64,
    "int32": torch.int32,
    "int16": torch.int16,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "bool": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}


def _compress(raw: bytes) -> bytes:
    if zstandard is not None:
        return b"Z" + zstandard.ZstdCompressor(level=_ZSTD_LEVEL).compress(raw)
    return b"z" + zlib.compress(raw, _ZLIB_LEVEL)


def _decompress(payload: bytes) -> bytes:
    tag, body = payload[:1], payload[1:]
    if tag == b"Z":
        if zstandard is None:
            raise RuntimeError(
                "checkpoint was written with zstd but zstandard is not installed"
            )
        return zstandard.ZstdDecompressor().decompress(body)
    if tag == b"z":
        return zlib.decompress(body)
    if payload[:4] == b"\x28\xb5\x2f\xfd":  # legacy untagged zstd frame
        if zstandard is None:
            raise RuntimeError("legacy zstd checkpoint but zstandard is not installed")
        return zstandard.ZstdDecompressor().decompress(payload)
    raise ValueError(f"unknown checkpoint compression tag {tag!r}")


def _pool_map(fn, items: list) -> list:
    with ThreadPoolExecutor(max_workers=max(1, min(8, os.cpu_count() or 1, len(items)))) as ex:
        return list(ex.map(fn, items))


def _leaf_bytes(t: torch.Tensor) -> bytes:
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _leaf_from_bytes(raw: bytes, dtype_name: str, shape) -> torch.Tensor:
    if dtype_name not in DTYPES:
        raise ValueError(f"checkpoint leaf dtype {dtype_name!r} has no torch counterpart")
    dtype = DTYPES[dtype_name]
    if not raw:
        return torch.empty(tuple(shape), dtype=dtype)
    return torch.frombuffer(bytearray(raw), dtype=dtype).reshape(tuple(shape))


def save(
    directory: str,
    step: int,
    state: Any,
    *,
    metadata: dict | None = None,
    process_index: int = 0,
    keep_last: int | None = 3,
) -> str:
    """Write one atomic checkpoint of a tree of tensors; returns the
    committed path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)

    leaves = tree_leaves_with_path(state)
    meta = {
        "step": step,
        "time": time.time(),
        "metadata": metadata or {},
        "leaves": [
            {"path": path, "shape": list(leaf.shape), "dtype": _NAMES[leaf.dtype]}
            for path, leaf in leaves
        ],
    }
    with open(os.path.join(tmp, "meta.msgpack"), "wb") as f:
        f.write(msgpack.packb(meta))

    blobs = _pool_map(_compress, [_leaf_bytes(leaf) for _, leaf in leaves])
    payload = {path: blob for (path, _), blob in zip(leaves, blobs)}
    with open(os.path.join(tmp, f"shard_p{process_index}.msgpack.zst"), "wb") as f:
        f.write(msgpack.packb(payload))

    os.replace(tmp, final)  # atomic commit of the step directory
    _write_latest(directory, step)
    if keep_last is not None:
        prune_old(directory, keep_last)
    return final


def _write_latest(directory: str, step: int) -> None:
    tmp = os.path.join(directory, "LATEST.tmp")
    with open(tmp, "w") as f:
        f.write(str(step))
    os.replace(tmp, os.path.join(directory, "LATEST"))


def latest_step(directory: str) -> int | None:
    try:
        with open(os.path.join(directory, "LATEST")) as f:
            return int(f.read().strip())
    except (FileNotFoundError, ValueError):
        return None


def available_steps(directory: str) -> list[int]:
    steps = []
    if not os.path.isdir(directory):
        return steps
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                steps.append(int(name[5:]))
            except ValueError:
                pass
    return sorted(steps)


def prune_old(directory: str, keep_last: int) -> None:
    steps = available_steps(directory)
    for s in steps[:-keep_last] if keep_last else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"), ignore_errors=True)


def restore(
    directory: str,
    template: Any,
    *,
    step: int | None = None,
    device=None,
    process_index: int = 0,
) -> tuple[Any, dict]:
    """Restore into the structure of ``template`` → ``(tree, metadata |
    {"step": step})``. ``device`` puts every leaf there; None puts each
    where its template leaf is."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "meta.msgpack"), "rb") as f:
        meta = msgpack.unpackb(f.read())
    with open(os.path.join(path, f"shard_p{process_index}.msgpack.zst"), "rb") as f:
        payload = msgpack.unpackb(f.read())
    info = {m["path"]: m for m in meta["leaves"]}

    wanted = tree_leaves_with_path(template)
    for key, _ in wanted:
        if key not in info:
            raise KeyError(f"checkpoint missing leaf {key}")
    raws = _pool_map(_decompress, [payload[key] for key, _ in wanted])
    out = []
    for (key, leaf), raw in zip(wanted, raws):
        m = info[key]
        t = _leaf_from_bytes(raw, m["dtype"], m["shape"])
        out.append(t.to(device if device is not None else leaf.device))
    return tree_unflatten(template, out), meta["metadata"] | {"step": meta["step"]}
