"""repro_torch — the PyTorch + CUDA port of ``repro`` (Forward Index
Compression for Learned Sparse Retrieval) for NVIDIA Hopper.

The JAX package ``repro`` is the reference; every module here mirrors
its counterpart's name (``repro_torch/core/layout.py`` ↔
``repro/core/layout.py``). This package imports ``torch`` and numpy
only — never ``jax`` and nothing of ``repro`` (``import repro`` pulls
in jax through ``repro.compat``).

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; :func:`resolve_device` is the one place that rule
lives, and it never falls back to the CPU on its own.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """``device`` (None, a string or a ``torch.device``) → a
    ``torch.device``. None means ``cuda``; a CUDA device on a machine
    without a usable GPU raises instead of running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA GPU is available; "
            f"pass device='cpu' to run the plain torch path on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}; use 'cuda' or 'cpu'")
    return dev
