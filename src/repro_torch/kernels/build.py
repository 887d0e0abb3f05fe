"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface. It is compiled at
first use with ``nvcc`` for Hopper (``sm_90a``) into a shared library
under ``build/repro_torch_kernels/`` at the repository root, and loaded
with ``ctypes``; nothing includes PyTorch's headers, so a build takes
seconds. The library name carries a hash of the source and the flags,
so an edited source rebuilds and concurrent builds never see a
half-written file (each writes a private temporary and renames it).

:func:`compile_kernels` starts one ``nvcc`` per source, all at once,
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

__all__ = ["SOURCES", "BUILD_DIR", "compile_kernels", "load", "nvcc_path"]

_CSRC = pathlib.Path(__file__).resolve().with_name("csrc")

#: build outputs live beside the sources' checkout (listed in .gitignore)
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

#: every kernel source of the port, by library name
SOURCES = ("rows_dot",)

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


def _lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha256((_CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def compile_kernels(names=SOURCES) -> dict[str, dict]:
    """Build every named library that is not built yet, one ``nvcc``
    process per source, all started together. Returns, per name,
    ``{"path", "seconds", "log"}`` (``log`` is None for a library that
    was already built). Raises on the first failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    started, out = {}, {}
    for name in names:
        path = _lib_path(name)
        if path.is_file():
            out[name] = {"path": path, "seconds": 0.0, "log": None}
            continue
        nvcc = nvcc or nvcc_path()
        tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        started[name] = (proc, tmp, path, time.perf_counter())
    for name, (proc, tmp, path, t0) in started.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed building {name}.cu:\n{log}")
        os.replace(tmp, path)
        out[name] = {"path": path, "seconds": time.perf_counter() - t0, "log": log}
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built on first use. Raises when no
    CUDA GPU is available or the build fails."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            f"the {name} CUDA kernel needs a CUDA GPU; none is available"
        )
    lib = ctypes.CDLL(str(compile_kernels([name])[name]["path"]))
    _LIBS[name] = lib
    return lib
