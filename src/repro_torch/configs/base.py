"""Arch/Cell abstraction — the part of ``repro/configs/base.py`` the
retrieval configs use. Every config exposes, per input shape, everything
the dry run needs:

    build_cell(shape, mesh) -> Cell(fn, input_structs, in_shardings,
                                    out_shardings, model_flops, meta)

``fn`` is the step a rank runs (the serve call); ``input_structs`` are
``meta`` tensors (shape and dtype, never allocated); the shardings are
``dist.sharding.Placement``s, the reference's ``NamedSharding``s. A cell
builds against a ``DeviceMesh`` of the process group, where ``fn`` runs,
or a device-free ``launch.mesh.MeshShape``, where only its shapes and
counts are read (``launch/dryrun.py``). ``meta`` holds the per-device
counts the dry run reports in place of XLA's compiled statistics
(``launch/hlo_stats.py``).

The LM, GNN and RecSys families (``LMArch``, ``GNNArch``, ``RecsysArch``)
are still to port (ROADMAP A11).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

__all__ = ["Cell", "BaseArch", "count_abstract_params"]


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str  # train | prefill | decode | serve
    fn: Callable
    input_structs: tuple
    in_shardings: tuple
    out_shardings: Any
    model_flops: float  # useful work of one executed step, global
    meta: dict


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, torch.Size):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def count_abstract_params(tree) -> int:
    """Elements over every leaf of a tree of tensors (``meta`` or not)."""
    return sum(math.prod(leaf.shape) for leaf in _leaves(tree))


class BaseArch:
    # bare annotations only: a default here would become a subclass
    # dataclass field's default
    name: str
    family: str
    shape_names: tuple[str, ...]

    def build_cell(self, shape: str, mesh) -> Cell:
        raise NotImplementedError

    def smoke(self, seed: int = 0) -> dict:
        """A tiny end-to-end run → a dict of its checks."""
        raise NotImplementedError
