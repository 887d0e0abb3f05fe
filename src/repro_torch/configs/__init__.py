"""Config registry: ``--arch <id>`` resolution — the port of
``repro/configs/__init__.py``.

The reference's ten assigned architectures (LM, GNN, RecSys) plus the
paper's own retrieval configs. Ported: the five LM configs and the
retrieval configs (``PORTED_IDS``). The GNN and RecSys ids stay in
``ARCH_IDS`` (they are the reference's registry) and ``get_arch`` raises
``NotImplementedError`` for them (ROADMAP A11); ``all_cells`` leaves them
out."""

from __future__ import annotations

import dataclasses
from importlib import import_module

__all__ = ["ARCH_IDS", "RETRIEVAL_IDS", "PORTED_IDS", "get_arch", "all_cells"]

ARCH_IDS = (
    # LM family
    "olmoe-1b-7b",
    "kimi-k2-1t-a32b",
    "qwen3-8b",
    "yi-6b",
    "deepseek-coder-33b",
    # GNN
    "gat-cora",
    # RecSys
    "deepfm",
    "sasrec",
    "dcn-v2",
    "din",
)

RETRIEVAL_IDS = ("msmarco-splade", "msmarco-lilsr")

_MODULES = {
    "olmoe-1b-7b": "olmoe_1b_7b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "qwen3-8b": "qwen3_8b",
    "yi-6b": "yi_6b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "msmarco-splade": "msmarco_splade",
    "msmarco-lilsr": "msmarco_lilsr",
}

#: the ids this package resolves, in the reference's registry order
PORTED_IDS = tuple(a for a in ARCH_IDS + RETRIEVAL_IDS if a in _MODULES)


def get_arch(arch_id: str):
    """Resolve an arch id. Retrieval configs accept a ``-optN`` suffix
    selecting the scan's optimisation level (see configs/retrieval.py)."""
    opt = 0
    base = arch_id
    if "-opt" in arch_id:
        base, _, lvl = arch_id.rpartition("-opt")
        opt = int(lvl)
    if base in ARCH_IDS and base not in _MODULES:
        raise NotImplementedError(
            f"arch {base!r} is not ported to repro_torch yet (ROADMAP A11: the GNN and "
            f"RecSys families); ported: {list(PORTED_IDS)}")
    if base not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(ARCH_IDS + RETRIEVAL_IDS)}")
    arch = import_module(f"{__name__}.{_MODULES[base]}").ARCH
    if opt:
        arch = dataclasses.replace(arch, name=arch_id, opt=opt)
    return arch


def all_cells(include_retrieval: bool = True):
    """Yield (arch_id, shape_name) for every dry-run cell of the ported
    configs."""
    for a in PORTED_IDS:
        if a in RETRIEVAL_IDS and not include_retrieval:
            continue
        arch = get_arch(a)
        for s in arch.shape_names:
            yield a, s
