"""Shared pieces of the port's config and dry-run tests
(``tests/test_torch_configs.py``, ``tests/test_torch_dryrun.py``).

The reference's production meshes need 256 and 512 jax devices, which a
process must force before jax starts (``XLA_FLAGS``), while every other
test of the process sees one. So ``reference_cells`` builds the
reference's retrieval cells (every id at ``opt`` 0–3, every shape, both
meshes) in one subprocess and returns, per cell, every input's and
output's per-device shape (``NamedSharding.shard_shape``), dtype and the
cell's model flops; nothing is compiled. ``port_cells`` gives the same
from the port's cells on ``launch.mesh.MeshShape``s. ``reference_lm_cells``
does the same for the reference's LM cells (5 configs × 4 shapes × 2
meshes), their outputs' shapes from ``jax.eval_shape`` of each cell's
step under its ``out_shardings``."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
OPTS = (0, 1, 2, 3)
MESHES = {"pod256": False, "pod512x2": True}

_REFERENCE_PROGRAM = r"""
import json, sys
import jax
import numpy as np
from repro.configs import RETRIEVAL_IDS, get_arch
from repro.launch.mesh import make_production_mesh

def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k in tree:
            out += flat(tree[k], f"{prefix}{k}/")
        return out
    if isinstance(tree, (tuple, list)):
        out = []
        for i, v in enumerate(tree):
            out += flat(v, f"{prefix}{i}/")
        return out
    return [(prefix.rstrip("/"), tree)]

meshes = {tag: make_production_mesh(multi_pod=multi)
          for tag, multi in json.loads(sys.argv[1]).items()}
out = {}
for arch_id in RETRIEVAL_IDS:
    for opt in json.loads(sys.argv[2]):
        name = arch_id + (f"-opt{opt}" if opt else "")
        arch = get_arch(name)
        for tag, mesh in meshes.items():
            for shape in arch.shape_names:
                cell = arch.build_cell(shape, mesh)
                ins = dict(flat(cell.input_structs))
                shs = dict(flat(cell.in_shardings))
                if shape == "scan_100q":
                    globals_ = {"": ((cell.input_structs[1].shape[0], arch.n_docs), "float32")}
                    osh = {"": cell.out_shardings}
                else:
                    nq = cell.input_structs[2].shape[0]
                    globals_ = {"0": ((nq, 10), "int32"), "1": ((nq, 10), "float32")}
                    osh = dict(flat(cell.out_shardings))
                out[f"{name}|{tag}|{shape}"] = dict(
                    inputs={k: [list(v.shape), list(shs[k].shard_shape(v.shape)),
                                str(np.dtype(v.dtype))] for k, v in ins.items()},
                    outputs={k: [list(s), list(osh[k].shard_shape(s)), dt]
                             for k, (s, dt) in globals_.items()},
                    model_flops=float(cell.model_flops), n_chips=int(mesh.devices.size),
                    meta={k: v for k, v in cell.meta.items()})
json.dump(out, sys.stdout)
"""


def reference_cells() -> dict:
    """``"<id>[-optN]|<mesh tag>|<shape>"`` → the reference cell's
    ``inputs`` and ``outputs`` (leaf path → [global shape, per-device
    shape, dtype]), ``model_flops``, ``n_chips`` and ``meta``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    res = subprocess.run([sys.executable, "-c", _REFERENCE_PROGRAM, json.dumps(MESHES),
                          json.dumps(list(OPTS))], env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout)


def _flat(tree, prefix=""):
    if hasattr(tree, "shard_shape"):  # a Placement is a leaf
        return [(prefix.rstrip("/"), tree)]
    if isinstance(tree, dict):
        return [x for k in tree for x in _flat(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree) for x in _flat(v, f"{prefix}{i}/")]
    return [(prefix.rstrip("/"), tree)]


def torch_dtype_name(dtype) -> str:
    """A torch dtype's numpy name (``torch.float16`` → ``float16``)."""
    return str(dtype).removeprefix("torch.")


def port_cells() -> dict:
    """The port's counterpart of ``reference_cells``, from cells built on
    ``MeshShape``s, plus each cell's ``meta`` counts."""
    from repro_torch.configs import RETRIEVAL_IDS, get_arch
    from repro_torch.launch.mesh import production_mesh_shape

    out = {}
    for arch_id in RETRIEVAL_IDS:
        for opt in OPTS:
            name = arch_id + (f"-opt{opt}" if opt else "")
            arch = get_arch(name)
            for tag, multi in MESHES.items():
                mesh = production_mesh_shape(multi_pod=multi)
                for shape in arch.shape_names:
                    cell = arch.build_cell(shape, mesh)
                    ins, shs = dict(_flat(cell.input_structs)), dict(_flat(cell.in_shardings))
                    if shape == "scan_100q":
                        globals_ = {"": ((cell.input_structs[1].shape[0], arch.n_docs),
                                         "float32")}
                        osh = {"": cell.out_shardings}
                    else:
                        nq = cell.input_structs[2].shape[0]
                        globals_ = {"0": ((nq, 10), "int32"), "1": ((nq, 10), "float32")}
                        osh = dict(_flat(cell.out_shardings))
                    out[f"{name}|{tag}|{shape}"] = dict(
                        inputs={k: [list(v.shape), list(shs[k].shard_shape(v.shape)),
                                    torch_dtype_name(v.dtype)] for k, v in ins.items()},
                        outputs={k: [list(s), list(osh[k].shard_shape(s)), dt]
                                 for k, (s, dt) in globals_.items()},
                        model_flops=float(cell.model_flops), meta=cell.meta)
    return out


def device_bytes(leaves: dict) -> int:
    """Bytes of every leaf's per-device shape ([global, per-device, dtype])."""
    return sum(int(np.prod(local)) * itemsize(dt) for _, local, dt in leaves.values())


def itemsize(dtype_name: str) -> int:
    """Bytes an element of a numpy dtype name (``bfloat16`` too, which
    numpy itself does not know)."""
    return 2 if dtype_name == "bfloat16" else np.dtype(dtype_name).itemsize


LM_IDS = ("olmoe-1b-7b", "kimi-k2-1t-a32b", "qwen3-8b", "yi-6b", "deepseek-coder-33b")

_REFERENCE_LM_PROGRAM = r"""
import json, sys
import jax
import numpy as np
from jax.sharding import NamedSharding
from repro.configs import get_arch
from repro.launch.mesh import make_production_mesh

def per_device(tree, sh, prefix=""):
    # sh is a prefix tree of tree: None (replicated) or a NamedSharding covers a subtree
    whole = sh is None or isinstance(sh, NamedSharding)
    if isinstance(tree, dict):
        return [x for k in tree
                for x in per_device(tree[k], sh if whole else sh[k], f"{prefix}{k}/")]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree)
                for x in per_device(v, sh if whole else sh[i], f"{prefix}{i}/")]
    return [(prefix.rstrip("/"), tree, sh)]

def record(tree, shardings):
    out = {}
    for path, leaf, sh in per_device(tree, shardings):
        local = leaf.shape if sh is None else sh.shard_shape(leaf.shape)
        out[path] = [list(leaf.shape), list(local), str(np.dtype(leaf.dtype))]
    return out

out = {}
for tag, multi in json.loads(sys.argv[1]).items():
    mesh = make_production_mesh(multi_pod=multi)
    for arch_id in json.loads(sys.argv[2]):
        arch = get_arch(arch_id)
        for shape in arch.shape_names:
            cell = arch.build_cell(shape, mesh)
            with jax.set_mesh(mesh):
                outs = jax.eval_shape(cell.fn, *cell.input_structs)
            out[f"{arch_id}|{tag}|{shape}"] = dict(
                kind=cell.kind, inputs=record(cell.input_structs, cell.in_shardings),
                outputs=record(outs, cell.out_shardings), model_flops=float(cell.model_flops),
                n_chips=int(mesh.devices.size), meta=cell.meta)
json.dump(out, sys.stdout)
"""


def reference_lm_cells(ids=LM_IDS) -> dict:
    """``"<id>|<mesh tag>|<shape>"`` → the reference cell's ``kind``,
    ``inputs`` and ``outputs`` (leaf path → [global shape, per-device
    shape, dtype]), ``model_flops``, ``n_chips`` and ``meta``, for the LM
    ids (or ``ids``: any config whose cell's ``fn`` takes its
    ``input_structs``, the GNN and RecSys ones too)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    res = subprocess.run([sys.executable, "-c", _REFERENCE_LM_PROGRAM, json.dumps(MESHES),
                          json.dumps(list(ids))], env=env, capture_output=True, text=True,
                         timeout=400)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout)


def port_lm_cells() -> dict:
    """The port's counterpart of ``reference_lm_cells`` (outputs from the
    shapes each cell's step returns), plus each cell's ``meta`` counts."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import production_mesh_shape

    out = {}
    for tag, multi in MESHES.items():
        mesh = production_mesh_shape(multi_pod=multi)
        for arch_id in LM_IDS:
            arch = get_arch(arch_id)
            for shape in arch.shape_names:
                cell = arch.build_cell(shape, mesh)
                out[f"{arch_id}|{tag}|{shape}"] = dict(
                    kind=cell.kind, inputs=_record(cell.input_structs, cell.in_shardings),
                    outputs=_record(lm_outputs(arch, shape, cell), cell.out_shardings),
                    model_flops=float(cell.model_flops), meta=cell.meta)
    return out


def lm_outputs(arch, shape: str, cell):
    """The ``meta`` outputs of an LM cell's step: the new state and the
    metrics (train, ``microbatches > 1``: loss, lr, grad_norm), the last
    position's logits and the cache (prefill, decode)."""
    import torch

    from repro_torch.configs.base import LM_SHAPES
    from repro_torch.models.transformer import init_kv_cache

    structs = cell.input_structs
    if cell.kind == "train":
        return structs[0], {k: torch.empty((), device="meta") for k in ("loss", "lr", "grad_norm")}
    cfg = arch.cell_cfg(shape)
    B, S = LM_SHAPES[shape]["global_batch"], LM_SHAPES[shape]["seq_len"]
    logits = torch.empty((B, cfg.vocab), dtype=cfg.dtype, device="meta")
    if cell.kind == "prefill":
        return logits, init_kv_cache(cfg, B, S, device="meta")
    return logits, structs[1]


def _record(tree, shardings) -> dict:
    """Leaf path → [global shape, per-device shape, dtype] of a tree of
    ``meta`` tensors under a prefix tree of ``Placement``s (None:
    replicated)."""
    out = {}

    def walk(t, sh, prefix):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], sh if sh is None or hasattr(sh, "shard_shape") else sh[k],
                     f"{prefix}{k}/")
        elif isinstance(t, (tuple, list)):
            for i, v in enumerate(t):
                walk(v, sh if sh is None or hasattr(sh, "shard_shape") else sh[i],
                     f"{prefix}{i}/")
        else:
            local = tuple(t.shape) if sh is None else sh.shard_shape(t.shape)
            out[prefix.rstrip("/")] = [list(t.shape), list(local), torch_dtype_name(t.dtype)]

    walk(tree, shardings, "")
    return out
