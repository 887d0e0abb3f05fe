"""Config registry: ``--arch <id>`` resolution — the port of
``repro/configs/__init__.py``.

The reference's ten assigned architectures (five LM configs, GAT and
four RecSys models) plus the paper's own retrieval configs: every id
resolves (``PORTED_IDS`` is the whole registry). ``-optN`` selects a
config's optimisation level where it has one (the retrieval scan's, the
GAT cell's edge-sharded layer)."""

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
    "gat-cora": "gat_cora",
    "deepfm": "deepfm",
    "sasrec": "sasrec",
    "dcn-v2": "dcn_v2",
    "din": "din",
    "msmarco-splade": "msmarco_splade",
    "msmarco-lilsr": "msmarco_lilsr",
}

#: the ids this package resolves, in the reference's registry order: all of them
PORTED_IDS = ARCH_IDS + RETRIEVAL_IDS


def get_arch(arch_id: str):
    """Resolve an arch id. A ``-optN`` suffix selects the optimisation level
    (the retrieval scan's, configs/retrieval.py; the GAT cell's,
    ``GNNArch``)."""
    opt = 0
    base = arch_id
    if "-opt" in arch_id:
        base, _, lvl = arch_id.rpartition("-opt")
        opt = int(lvl)
    if base not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_MODULES)}")
    arch = import_module(f"{__name__}.{_MODULES[base]}").ARCH
    if opt:
        arch = dataclasses.replace(arch, name=arch_id, opt=opt)
    return arch


def all_cells(include_retrieval: bool = True):
    """Yield (arch_id, shape_name) for every dry-run cell."""
    for a in PORTED_IDS:
        if a in RETRIEVAL_IDS and not include_retrieval:
            continue
        arch = get_arch(a)
        for s in arch.shape_names:
            yield a, s
