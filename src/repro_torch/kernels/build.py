"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface. It is compiled at
first use with ``nvcc`` for Hopper (``sm_90a``) into a shared library
under ``build/repro_torch_kernels/`` at the repository root, and loaded
with ``ctypes``; nothing includes PyTorch's headers, so a build takes
seconds. The library name carries a hash of the source, of every
shared header in ``csrc/`` (``*.cuh``) and of the flags, so an edited
source or header rebuilds, and concurrent builds never see a
half-written file (each writes a private temporary and renames it).

A source with many template instantiations is compiled in ``PARTS``
parts: part p is its own library, built with ``-DKERNEL_PART=p
-DKERNEL_PARTS=n``, and holds the share of the variants the source
assigns to it, so the parts compile in parallel.

:func:`compile_kernels` starts one ``nvcc`` per library, all at once,
and returns each build's compiler log (``-Xptxas -v``: registers,
shared memory, spills). :func:`load` builds on demand and raises when
there is no GPU or no ``nvcc`` — it never hands back a stand-in.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

__all__ = ["SOURCES", "PARTS", "BUILD_DIR", "compile_kernels", "libraries", "load", "nvcc_path"]

_CSRC = pathlib.Path(__file__).resolve().with_name("csrc")

#: build outputs live beside the sources' checkout (listed in .gitignore)
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

#: every kernel source of the port, by name
SOURCES = ("rows_dot", "block_scan")

#: sources compiled in several parts (the others in one): with the rows
#: kernel, one nvcc for each of the chip machine's 8 cores but one
PARTS = {"block_scan": 6}

_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default
    install location. Raises when neither exists."""
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin); the CUDA kernels "
        "are built from src/repro_torch/kernels/csrc at first use"
    )


def libraries(names=SOURCES) -> list[tuple[str, int]]:
    """The (source, part) of every library the named sources build."""
    return [(n, p) for n in names for p in range(PARTS.get(n, 1))]


def _lib_key(name: str, part: int) -> str:
    return f"{name}.{part}" if name in PARTS else name


def _defines(name: str, part: int) -> list[str]:
    if name not in PARTS:
        return []
    return [f"-DKERNEL_PART={part}", f"-DKERNEL_PARTS={PARTS[name]}"]


def _lib_path(name: str, part: int = 0) -> pathlib.Path:
    h = hashlib.sha256((_CSRC / f"{name}.cu").read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join([*_FLAGS, *_defines(name, part)]).encode())
    return BUILD_DIR / f"lib{_lib_key(name, part)}-{h.hexdigest()[:16]}.so"


def compile_kernels(names=SOURCES) -> dict[str, dict]:
    """Build every library of the named sources that is not built yet,
    one ``nvcc`` process per library, all started together. Returns, per
    library (``name``, or ``name.part`` for a source in parts),
    ``{"path", "seconds", "log"}`` (``log`` is None for a library that
    was already built). Raises on the first failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    started, out = {}, {}
    for name, part in libraries(names):
        key = _lib_key(name, part)
        path = _lib_path(name, part)
        if path.is_file():
            out[key] = {"path": path, "seconds": 0.0, "log": None}
            continue
        nvcc = nvcc or nvcc_path()
        tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *_FLAGS, *_defines(name, part), "-o", str(tmp),
               str(_CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        started[key] = (proc, tmp, path, time.perf_counter())
    failed = []
    for key, (proc, tmp, path, t0) in started.items():
        log, _ = proc.communicate()  # wait for every build, failed or not
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed building {key}:\n{log}")
            continue
        os.replace(tmp, path)
        out[key] = {"path": path, "seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(name: str, part: int = 0) -> ctypes.CDLL:
    """The loaded library ``name`` (its part ``part``), built on first
    use. Raises when no CUDA GPU is available or the build fails."""
    key = _lib_key(name, part)
    lib = _LIBS.get(key)
    if lib is not None:
        return lib
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            f"the {name} CUDA kernel needs a CUDA GPU; none is available"
        )
    lib = ctypes.CDLL(str(compile_kernels([name])[key]["path"]))
    _LIBS[key] = lib
    return lib
