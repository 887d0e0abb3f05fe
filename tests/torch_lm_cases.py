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


#: the placed cells' mini shapes on a (2, 2) mesh: train rows, prefill
#: rows × tokens, decode rows × cache slots (LM_SHAPES' kinds)
PLACED_SHAPES = {"train_4k": dict(kind="train", seq_len=8, global_batch=4),
                 "prefill_32k": dict(kind="prefill", seq_len=8, global_batch=2),
                 "decode_32k": dict(kind="decode", seq_len=16, global_batch=4),
                 "long_500k": dict(kind="decode", seq_len=16, global_batch=2)}
PLACED_STEPS = 2


def placed_cells_ranks(rank, world, out_dir, cases, tokens, mesh_shape=(2, 2), device="cpu"):
    """Every rank of a ``mesh_shape`` mesh runs the mini LMs' four cells
    placed (``cases``: name → (config, whole parameters, optimizer name))
    on its blocks on ``device``: ``PLACED_STEPS`` train steps, a prefill,
    and ``MINI_STEPS`` decode steps of each decode shape from an empty
    cache; saves its blocks and every MoE routing it made."""
    from repro_torch.configs import base
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import moe
    from repro_torch.models.common import params_to_numpy
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.tree import tree_leaves_with_path

    from repro_torch.tree import tree_map

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    base.LM_SHAPES = dict(base.LM_SHAPES, **PLACED_SHAPES)
    mesh = make_debug_mesh(mesh_shape, ("data", "model"))
    route, routes = moe._route, []

    def logged(params, cfg, x):
        out = route(params, cfg, x)
        routes.append(out[2].sort(dim=-1).values.cpu())
        return out

    moe._route = logged
    out = {}
    toks = torch.from_numpy(tokens).to(device)
    for name, (cfg, params, opt) in cases.items():
        params = tree_map(lambda t: t.to(device), params)
        arch = base.LMArch(name="mini", cfg=cfg, optimizer=OptimizerConfig(
            name=opt, factored_min_dim=8))
        cell = arch.build_cell("train_4k", mesh, weights="placed")
        B, S = PLACED_SHAPES["train_4k"]["global_batch"], PLACED_SHAPES["train_4k"]["seq_len"]
        batch = {"tokens": toks[:B, :S], "labels": toks[:B, 1:S + 1]}
        local = {k: shd.shard_block(v, cell.in_shardings[1][k].spec, mesh)
                 for k, v in batch.items()}
        state = arch.place("train_4k", mesh, params)
        for t in range(PLACED_STEPS):
            routes.clear()
            state, m = cell.fn(state, local)  # noqa: B023
            for k in ("loss", "grad_norm"):
                out[f"{name}/train/{k}{t}"] = float(m[k])
            if t == 0:
                out.update({f"{name}/train/route{c}": r.numpy() for c, r in enumerate(routes)})
        for k, v in tree_leaves_with_path(params_to_numpy(state)):
            out[f"{name}/train/state{k}"] = v
        cell = arch.build_cell("prefill_32k", mesh, weights="placed")
        B, S = PLACED_SHAPES["prefill_32k"]["global_batch"], PLACED_SHAPES["prefill_32k"]["seq_len"]
        routes.clear()
        last, cache = cell.fn(arch.place("prefill_32k", mesh, params),
                              shd.shard_block(toks[:B, :S], cell.in_shardings[1].spec, mesh))
        out.update({f"{name}/prefill/route{c}": r.numpy() for c, r in enumerate(routes)})
        out[f"{name}/prefill/last"] = last.cpu().numpy()
        out[f"{name}/prefill/k"] = cache["k"].cpu().numpy()
        out[f"{name}/prefill/v"] = cache["v"].cpu().numpy()
        for shape in ("decode_32k", "long_500k"):
            cell = arch.build_cell(shape, mesh, weights="placed")
            B, S = PLACED_SHAPES[shape]["global_batch"], PLACED_SHAPES[shape]["seq_len"]
            _, cache_sh, tok_sh, len_sh = cell.in_shardings
            cache = {k: shd.shard_block(torch.zeros(tuple(v.shape), device=device),
                                        cache_sh[k].spec, mesh).clone()
                     for k, v in cell.input_structs[1].items()}
            p = arch.place(shape, mesh, params)
            lengths = torch.zeros(B, dtype=torch.int32, device=device)
            for t in range(MINI_STEPS):
                logits, cache = cell.fn(p, cache, shd.shard_block(toks[:B, t:t + 1], tok_sh.spec,
                                                                  mesh),
                                        shd.shard_block(lengths, len_sh.spec, mesh))
                out[f"{name}/{shape}/logits{t}"] = logits.cpu().numpy()
                lengths = lengths + 1
            out[f"{name}/{shape}/k"] = cache["k"].cpu().numpy()
    np.savez(f"{out_dir}/rank{rank}.npz", **out)


def placed_cases() -> dict:
    """The mini LM dense (heads split with their KV heads), with experts
    (expert-parallel, global routing), with one KV head (the KV head's
    columns split mid-head: every KV head gathered, the rank's selected;
    Adafactor) and with three heads over one KV head (the ranks' query
    heads uneven, 1 and 2: the weights gathered, each rank's rows and
    columns taken); a (2, 2) mesh's data and model axes split every
    dimension of even size."""
    import dataclasses

    from repro_torch.models import transformer as tf

    out = {}
    for name, moe_on, h, hk, opt in (("dense", False, 8, 4, "adamw"),
                                     ("moe", True, 8, 4, "adamw"),
                                     ("mqa", False, 8, 1, "adafactor"),
                                     ("odd", False, 3, 1, "adamw")):
        cfg = dataclasses.replace(mini_lm(moe=moe_on), n_heads=h, n_kv_heads=hk, d_head=8)
        out[name] = (cfg, tf.init_params(torch.Generator().manual_seed(9), cfg, device="cpu"),
                     opt)
    return out


def check_placed_ranks(ranks: list, cases: dict, toks: np.ndarray, mesh_shape, *, rtol: float,
                       state_atol: float, atol: float) -> None:
    """``placed_cells_ranks``' records (rank ``r`` at the row-major
    coordinate ``r`` of ``mesh_shape``) against one process's whole-weight
    run on the CPU over the global batch: losses and grad norms (``rtol``),
    every parameter and optimizer leaf (``state_atol``), logits and caches
    (``atol``); an MoE data rank's routing equal to one process's for its
    rows."""
    from repro_torch.configs import base
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import params_to_numpy
    from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
    from repro_torch.train.train_step import make_train_step
    from repro_torch.tree import tree_leaves_with_path

    mesh = MeshShape(tuple(mesh_shape), ("data", "model"))
    n_model = mesh_shape[1]

    def data_rows(want, r):  # a data rank's block of a [rows, ...] routing
        d, n = r // n_model, want.shape[0] // mesh_shape[0]
        return want[d * n:(d + 1) * n].numpy()

    def t(a):
        return torch.from_numpy(np.asarray(a)).long()

    for name, (cfg, params, opt) in cases.items():
        arch = base.LMArch(name="mini", cfg=cfg,
                           optimizer=OptimizerConfig(name=opt, factored_min_dim=8))
        B, S = PLACED_SHAPES["train_4k"]["global_batch"], PLACED_SHAPES["train_4k"]["seq_len"]
        oinit, oupd = make_optimizer(arch.optimizer)
        step = make_train_step(lambda p, b, c=cfg: tf.lm_loss(p, c, b[:, :-1], b[:, 1:]), oupd)
        state = {"params": params, "opt": oinit(params)}
        routes = []
        route = moe._route

        def logged(p, c, x):
            out = route(p, c, x)
            routes.append(out[2].sort(dim=-1).values)
            return out

        moe._route = logged
        try:
            for s in range(PLACED_STEPS):
                routes.clear()
                state, met = step(state, t(toks[:B, :S + 1]))
                for k in ("loss", "grad_norm"):
                    for r in ranks:
                        np.testing.assert_allclose(r[f"{name}/train/{k}{s}"], float(met[k]),
                                                   rtol=rtol, err_msg=(name, k, s))
                if s == 0 and cfg.moe is not None:
                    assert routes and all(f"{name}/train/route{c}" in ranks[0]
                                          for c in range(len(routes)))
                    for c, want in enumerate(routes):  # [B·S, K] → each data rank's rows
                        for r, got in enumerate(ranks):
                            assert np.array_equal(got[f"{name}/train/route{c}"],
                                                  data_rows(want, r)), (name, c, r)
            pspecs = arch.param_specs("train_4k", mesh)
            specs = {"params": pspecs,
                     "opt": base._state_specs(pspecs, arch.abstract_params(), arch.optimizer)["opt"]}
            want_state = dict(tree_leaves_with_path(params_to_numpy(state)))
            for k, spec in tree_leaves_with_path(specs):
                got = place_blocks([r[f"{name}/train/state{k}"] for r in ranks], spec,
                                   want_state[k].shape, mesh_shape)
                np.testing.assert_allclose(got, want_state[k], rtol=0, atol=state_atol,
                                           err_msg=(name, k))
            B, S = (PLACED_SHAPES["prefill_32k"]["global_batch"],
                    PLACED_SHAPES["prefill_32k"]["seq_len"])
            routes.clear()
            with torch.no_grad():
                logits, aux = tf.forward(params, cfg, t(toks[:B, :S]), collect_kv=True)
            got = place_blocks([r[f"{name}/prefill/last"] for r in ranks], ("data", "model"),
                               (B, cfg.vocab), mesh_shape)
            np.testing.assert_allclose(got, logits[:, -1].numpy(), rtol=0, atol=atol)
            for kv in ("k", "v"):
                got = place_blocks([r[f"{name}/prefill/{kv}"] for r in ranks],
                                   (None, "data", "model"), aux["kv_cache"][kv].shape, mesh_shape)
                np.testing.assert_allclose(got, aux["kv_cache"][kv].numpy(), rtol=0, atol=atol,
                                           err_msg=(name, kv))
            for c, want in enumerate(routes):
                for r, got in enumerate(ranks):
                    assert np.array_equal(got[f"{name}/prefill/route{c}"],
                                          data_rows(want, r)), (name, c, r)
        finally:
            moe._route = route
        for shape in ("decode_32k", "long_500k"):
            B, S = PLACED_SHAPES[shape]["global_batch"], PLACED_SHAPES[shape]["seq_len"]
            batch = None if shape == "long_500k" else "data"
            seq = ("data", "model") if shape == "long_500k" else "model"
            cache = tf.init_kv_cache(cfg, B, S, device="cpu")
            lens = torch.zeros(B, dtype=torch.int32)
            with torch.no_grad():
                for s in range(MINI_STEPS):
                    want, cache = tf.decode_step(params, cfg, cache, t(toks[:B, s:s + 1]), lens)
                    lens = lens + 1
                    got = place_blocks([r[f"{name}/{shape}/logits{s}"] for r in ranks],
                                       (batch, "model"), want.shape, mesh_shape)
                    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=atol,
                                               err_msg=(name, shape, s))
            got = place_blocks([r[f"{name}/{shape}/k"] for r in ranks], (None, batch, seq),
                               cache["k"].shape, mesh_shape)
            np.testing.assert_allclose(got, cache["k"].numpy(), rtol=0, atol=atol)
