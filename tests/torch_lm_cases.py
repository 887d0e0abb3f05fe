"""Shared pieces of the port's LM tests (``tests/test_torch_lm.py``,
``tests/test_torch_gpu.py``): the rank programs that
``launch.mesh.spawn_ranks`` runs (flash decoding over a gloo mesh, an LM
decode cell on a real mesh) and a mini LM config. Imports no jax: the
ranks import this module, and the ``gpu`` tests run where jax is not
wanted."""

import numpy as np
import torch

from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

#: flash decoding's case (the reference's ``tests/test_dist.py``): B, S, H, Hk, dh
FLASH = dict(B=4, S=64, H=8, Hk=4, dh=16)
FLASH_LENGTHS = (5, 33, 64, 17)
#: the two layouts of the reference's test on a (2, 2) mesh: batch × seq,
#: and the sequence over every axis
FLASH_LAYOUTS = {"batch_seq": (("data",), ("model",)), "seq_all": ((), ("data", "model"))}


def flash_inputs(seed: int = 0):
    """q [B,1,H,dh], k/v [B,S,Hk,dh] f32 and the valid lengths, numpy."""
    rng = np.random.default_rng(seed)
    c = FLASH
    q = rng.standard_normal((c["B"], 1, c["H"], c["dh"])).astype(np.float32)
    k = rng.standard_normal((c["B"], c["S"], c["Hk"], c["dh"])).astype(np.float32)
    v = rng.standard_normal((c["B"], c["S"], c["Hk"], c["dh"])).astype(np.float32)
    return q, k, v, np.asarray(FLASH_LENGTHS, np.int32)


def flash_ranks(rank, world, out_dir, inputs, device):
    """Every rank of a (2, 2) mesh runs ``flash_decode_shardmap`` in both
    layouts on its blocks; each rank saves its outputs."""
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.collectives import flash_decode_shardmap
    from repro_torch.launch.mesh import make_debug_mesh

    torch.set_num_threads(1)
    mesh = make_debug_mesh((2, 2), ("data", "model"))
    q, k, v, vl = (torch.from_numpy(a).to(device) for a in inputs)
    out = {}
    for name, (ba, sa) in FLASH_LAYOUTS.items():
        fn = flash_decode_shardmap(mesh, batch_axes=ba, seq_axes=sa)
        bspec = (ba or None,)
        kspec = shd.P(ba or None, sa)
        got = fn(shd.shard_block(q, bspec, mesh), shd.shard_block(k, kspec, mesh),
                 shd.shard_block(v, kspec, mesh), shd.shard_block(vl, bspec, mesh))
        out[name] = got.cpu().numpy()
    np.savez(f"{out_dir}/rank{rank}.npz", **out)


def mini_lm(moe: bool = False, dtype=torch.float32) -> TransformerConfig:
    """The reference's mini LM of ``tests/test_dist.py`` (2 layers,
    d 32, 8 heads over 4 KV heads), with or without experts."""
    return TransformerConfig(
        name="mini", n_layers=2, d_model=32, n_heads=8, n_kv_heads=4, d_ff=64, vocab=128,
        qk_norm=True, moe=MoEConfig(n_experts=8, top_k=2, d_model=32, d_ff=16) if moe else None,
        dtype=dtype)


#: the mini shapes a mesh run takes in place of LM_SHAPES: (batch, cache slots)
MINI_DECODE = {"decode_32k": (4, 16), "long_500k": (2, 16)}
MINI_STEPS = 5


def decode_cell_ranks(rank, world, out_dir, params, tokens, shape, device):
    """Every rank of a (2, 2) mesh runs ``MINI_STEPS`` steps of the mini
    LM's ``shape`` decode cell on its blocks (the cache starts empty),
    then saves its logits block of every step and its cache block."""
    from repro_torch.configs import base
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.tree import tree_map

    torch.set_num_threads(1)
    B, S = MINI_DECODE[shape]
    base.LM_SHAPES = dict(base.LM_SHAPES, **{shape: dict(kind="decode", seq_len=S,
                                                         global_batch=B)})
    mesh = make_debug_mesh((2, 2), ("data", "model"))
    arch = base.LMArch(name="mini", cfg=mini_lm(), optimizer=OptimizerConfig())
    cell = arch.build_cell(shape, mesh)
    _, cache_sh, tok_sh, len_sh = cell.in_shardings
    cache = {k: shd.shard_block(torch.zeros(tuple(v.shape)), cache_sh[k].spec, mesh).clone()
             .to(device) for k, v in cell.input_structs[1].items()}
    params = tree_map(lambda t: t.to(device), params)
    toks = torch.from_numpy(tokens).to(device)
    lengths = torch.zeros(B, dtype=torch.int32, device=device)
    out = {}
    for t in range(MINI_STEPS):
        logits, cache = cell.fn(params, cache,
                                shd.shard_block(toks[:, t:t + 1], tok_sh.spec, mesh),
                                shd.shard_block(lengths, len_sh.spec, mesh))
        out[f"logits{t}"] = logits.cpu().numpy()
        lengths = lengths + 1
    out["k"], out["v"] = cache["k"].cpu().numpy(), cache["v"].cpu().numpy()
    np.savez(f"{out_dir}/rank{rank}.npz", **out)


def train_cell_ranks(rank, world, out_dir, params, tokens, steps):
    """Every rank of a (2, 1) mesh runs ``steps`` steps of the (dense) mini
    LM's ``train_4k`` cell on its half of the batch's rows (the gradients
    averaged over ``data``); saves its parameters and losses."""
    from repro_torch.configs import base
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.common import params_to_numpy
    from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
    from repro_torch.tree import tree_leaves_with_path

    torch.set_num_threads(1)
    mesh = make_debug_mesh((2, 1), ("data", "model"))
    arch = base.LMArch(name="mini", cfg=mini_lm(), optimizer=OptimizerConfig())
    cell = arch.build_cell("train_4k", mesh)
    _, batch_sh = cell.in_shardings
    toks = torch.from_numpy(tokens)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    local = {k: shd.shard_block(v, batch_sh[k].spec, mesh) for k, v in batch.items()}
    state = {"params": params, "opt": make_optimizer(arch.optimizer)[0](params)}
    losses = []
    for _ in range(steps):
        state, metrics = cell.fn(state, local)
        losses.append(float(metrics["loss"]))
    out = {k: v for k, v in tree_leaves_with_path(params_to_numpy(state["params"]))}
    np.savez(f"{out_dir}/rank{rank}.npz", losses=np.asarray(losses), **out)


def place_blocks(blocks: list, spec, global_shape, mesh_shape=(2, 2),
                 axes=("data", "model")) -> np.ndarray:
    """The global array from each rank's block (rank ``r`` at the
    row-major coordinate ``r`` of ``mesh_shape``) placed by ``spec``;
    ranks that hold the same block must hold the same bytes."""
    out = np.full(global_shape, np.nan, dtype=blocks[0].dtype)
    for r, blk in enumerate(blocks):
        coord = np.unravel_index(r, mesh_shape)
        idx = []
        for d, e in enumerate(tuple(spec) + (None,) * (len(global_shape) - len(spec))):
            names = () if e is None else (e,) if isinstance(e, str) else tuple(e)
            i = 0
            for a in names:
                i = i * mesh_shape[axes.index(a)] + coord[axes.index(a)]
            n = blk.shape[d]
            idx.append(slice(i * n, (i + 1) * n))
        seen = out[tuple(idx)]
        held = ~np.isnan(seen) if seen.dtype.kind == "f" else np.zeros(seen.shape, bool)
        assert np.array_equal(seen[held], blk[held]), f"rank {r} disagrees on a replicated block"
        out[tuple(idx)] = blk
    return out


def card_ranks(rank, world, out_dir, params, tokens, device):
    """One NCCL rank on the card: the mini LM's ``decode_32k`` cell (world
    1, every axis of size 1) over a small cache, and flash decoding's local
    path; saves the logits of every step, the cache and the flash output."""
    from repro_torch.configs import base
    from repro_torch.dist.collectives import flash_decode_shardmap
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_debug_mesh((1, 1), ("data", "model"))
    cfg = mini_lm()
    B, S = MINI_DECODE["decode_32k"]
    cell = base.LMArch(name="mini", cfg=cfg, optimizer=OptimizerConfig()).build_cell(
        "decode_32k", mesh, global_batch=B)
    params = tree_map(lambda t: t.to(device), params)
    cache = tf.init_kv_cache(cfg, B, S, device=device)
    toks = torch.from_numpy(tokens).to(device)
    lengths = torch.zeros(B, dtype=torch.int32, device=device)
    out = {}
    for t in range(MINI_STEPS):
        logits, cache = cell.fn(params, cache, toks[:, t:t + 1], lengths)
        out[f"logits{t}"] = logits.cpu().numpy()
        lengths = lengths + 1
    out["k"], out["v"] = cache["k"].cpu().numpy(), cache["v"].cpu().numpy()
    q, k, v, vl = (torch.from_numpy(a).to(device) for a in flash_inputs(2))
    out["flash"] = flash_decode_shardmap(mesh, batch_axes=(), seq_axes=("data", "model"))(
        q, k, v, vl).cpu().numpy()
    np.savez(f"{out_dir}/rank{rank}.npz", **out)
