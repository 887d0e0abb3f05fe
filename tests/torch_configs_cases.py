"""Shared pieces of the port's config and dry-run tests
(``tests/test_torch_configs.py``, ``tests/test_torch_dryrun.py``).

The reference's production meshes need 256 and 512 jax devices, which a
process must force before jax starts (``XLA_FLAGS``), while every other
test of the process sees one. So ``reference_cells`` builds the
reference's retrieval cells (every id at ``opt`` 0–3, every shape, both
meshes) in one subprocess and returns, per cell, every input's and
output's per-device shape (``NamedSharding.shard_shape``), dtype and the
cell's model flops; nothing is compiled. ``port_cells`` gives the same
from the port's cells on ``launch.mesh.MeshShape``s."""

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
    return sum(int(np.prod(local)) * np.dtype(dt).itemsize for _, local, dt in leaves.values())
