"""The port's LM cells and what runs them, on the CPU (the models
against the reference: ``tests/test_torch_lm.py``).

* Flash decoding (``dist.collectives``) on four gloo ranks in both
  layouts of the reference's ``tests/test_dist.py`` against its
  ``_decode_attention_ref`` (atol 1e-5); the decode cells of a mini LM on
  four gloo ranks against one process's decode (atol 1e-5: flash
  decoding sums in another order); the in-place cache write.
* Two steps of the ``train_4k`` cell at the smoke width on a one-rank
  gloo mesh against the reference's cell on a ``(1, 1)`` mesh, with whole
  and with placed weights; the cell switches; ``hlo_stats.
  lm_collectives`` recomputed by hand.
* The mini LMs' four cells with ``weights="placed"`` on a (2, 2) gloo
  mesh against one process (``torch_lm_cases.check_placed_ranks``).
* ``smoke()``, the train CLI (``launch/train.py``), the port's copies of
  the reference's model invariants (``tests/test_models.py``), no jax on
  import.

torch runs at one intra-op thread (``torch_cases.one_intra_op_thread``).
"""

import dataclasses
import datetime
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch_cases import one_intra_op_thread  # noqa: F401
from torch_configs_cases import LM_IDS, ROOT
from torch_lm_cases import (FLASH, FLASH_LAYOUTS, MINI_DECODE, MINI_STEPS, check_placed_ranks,
                            decode_cell_ranks, flash_inputs, flash_ranks, mini_lm, place_blocks,
                            placed_cases, placed_cells_ranks, train_cell_ranks)

from repro import configs as ref_configs
from repro.launch.mesh import make_debug_mesh as ref_debug_mesh
from repro.models import transformer as rt
from repro.train.optimizer import make_optimizer as ref_make_optimizer
from repro_torch import configs
from repro_torch.dist import sharding as shd
from repro_torch.dist.collectives import flash_decode_shardmap
from repro_torch.launch import hlo_stats
from repro_torch.launch.mesh import MeshShape, make_debug_mesh, production_mesh_shape, spawn_ranks
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.models.common import params_from_jax, params_to_numpy
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.train_step import make_train_step, value_and_grad
from repro_torch.tree import tree_leaves_with_path


def _np_tree(tree) -> dict:
    """keystr path → numpy array of a jax tree."""
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tokens(vocab: int, shape, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a)).long()


# ---------------------------------------------------------------------------
# flash decoding and the decode cells on gloo ranks
# ---------------------------------------------------------------------------


def test_flash_decode_on_gloo_ranks_matches_reference(tmp_path):
    inputs = flash_inputs()
    q, k, v, vl = inputs
    want = np.asarray(rt._decode_attention_ref(*(jnp.asarray(a) for a in inputs)))
    spawn_ranks(flash_ranks, 4, str(tmp_path), inputs, "cpu", backend="gloo",
                init_file=tmp_path / "init", timeout_s=120)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(4)]
    for name, (ba, _) in FLASH_LAYOUTS.items():
        got = place_blocks([r[name] for r in ranks], (ba or None,), want.shape)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=name)
    # the local path (one rank, every axis of size 1) in this process
    torch_ref = tf._decode_attention_ref(*(torch.from_numpy(a) for a in inputs))
    np.testing.assert_allclose(torch_ref.numpy(), want, rtol=0, atol=1e-5)
    assert FLASH["S"] % 4 == 0


@pytest.mark.parametrize("shape", list(MINI_DECODE))
def test_decode_cell_on_a_gloo_mesh_matches_one_process(tmp_path, shape):
    """A mini LM's decode cell on a (2, 2) gloo mesh — the batch over
    ``data`` and the cache's sequence over ``model`` (``decode_32k``), or
    the sequence over both (``long_500k``) — a rank writing a token only
    where its slice holds the position: every step's logits and the final
    cache equal one process's ``decode_step``."""
    cfg = mini_lm()
    B, S = MINI_DECODE[shape]
    params = tf.init_params(torch.Generator().manual_seed(4), cfg, device="cpu")
    toks = _tokens(cfg.vocab, (B, MINI_STEPS), seed=5)
    spawn_ranks(decode_cell_ranks, 4, str(tmp_path), params, toks, shape, "cpu",
                backend="gloo", init_file=tmp_path / "init", timeout_s=180)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(4)]
    cache = tf.init_kv_cache(cfg, B, S, device="cpu")
    lens = torch.zeros(B, dtype=torch.int32)
    seq = ("data", "model") if shape == "long_500k" else "model"
    batch = None if shape == "long_500k" else "data"
    with torch.no_grad():
        for t in range(MINI_STEPS):
            want, cache = tf.decode_step(params, cfg, cache, _t(toks[:, t:t + 1]), lens)
            lens = lens + 1
            got = place_blocks([r[f"logits{t}"] for r in ranks], (batch, "model"), want.shape)
            np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-5)
    for k in ("k", "v"):
        got = place_blocks([r[k] for r in ranks], (None, batch, seq), cache[k].shape)
        np.testing.assert_allclose(got, cache[k].numpy(), rtol=0, atol=1e-5)
        assert not got[:, :, MINI_STEPS:].any()  # nothing written past the tokens


def test_train_cell_on_two_data_ranks_matches_one_process(tmp_path):
    """The mini LM's ``train_4k`` cell on a (2, 1) gloo mesh, each rank on
    its half of the batch with the gradients and loss averaged over
    ``data``: two steps equal one process's steps on the whole batch (f32
    sums in another order: rtol 1e-5 on the losses, atol 1e-6 on the
    parameters, which the first steps move by ~lr). Dense: an MoE rank
    routes, caps and balances its own rows (``configs/base.py``)."""
    from repro_torch.configs import base
    from repro_torch.train.optimizer import OptimizerConfig

    cfg = mini_lm()
    params = tf.init_params(torch.Generator().manual_seed(8), cfg, device="cpu")
    toks = _tokens(cfg.vocab, (4, 9), seed=8)
    spawn_ranks(train_cell_ranks, 2, str(tmp_path), params, toks, 2, backend="gloo",
                init_file=tmp_path / "init", timeout_s=120)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    arch = base.LMArch(name="mini", cfg=cfg, optimizer=OptimizerConfig())
    oinit, oupd = make_optimizer(arch.optimizer)
    step = make_train_step(lambda p, b: tf.lm_loss(p, cfg, b[:, :-1], b[:, 1:]), oupd)
    state, losses = {"params": params, "opt": oinit(params)}, []
    for _ in range(2):
        state, metrics = step(state, _t(toks))
        losses.append(float(metrics["loss"]))
    for r in ranks:
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
        for k, v in tree_leaves_with_path(params_to_numpy(state["params"])):
            np.testing.assert_allclose(r[k], v, rtol=0, atol=1e-6, err_msg=k)
    for k in ranks[0]:  # the replicas hold the same bits
        assert np.array_equal(ranks[0][k], ranks[1][k]), k


#: placed (2, 2) against one process: f32 losses and grad norms (rtol),
#: parameters and optimizer state after two steps (atol; a first AdamW step
#: moves a weight by ~lr = 3e-7 here whatever its gradient), logits and
#: caches (atol). The ranks sum a row-parallel product's halves, the
#: vocab-parallel log-sum-exp's and an MoE token's experts' outputs over
#: ``model`` in another order than one process: f32 rounding, ~1e-7.
PLACED_RTOL, PLACED_STATE_ATOL, PLACED_ATOL = 1e-5, 1e-6, 1e-5


def test_placed_cells_on_a_gloo_mesh_match_one_process(tmp_path):
    """The mini LMs' four cells with ``weights="placed"`` on a (2, 2) gloo
    mesh — every weight and optimizer leaf a rank's block (FSDP over
    ``data``, tensor-, vocab- and expert-parallel over ``model``) — equal
    one process's whole-weight run over the global batch: two train steps
    (losses, grad norms, every parameter and optimizer leaf), a prefill
    (its last logits and the cache's sequence blocks) and five steps of
    both decode layouts. MoE: each data rank's routing equals one
    process's for its rows (the global capacity and token order)."""
    cases = placed_cases()
    toks = _tokens(128, (4, 16), seed=11)
    spawn_ranks(placed_cells_ranks, 4, str(tmp_path), cases, toks, backend="gloo",
                init_file=tmp_path / "init", timeout_s=300)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(4)]
    check_placed_ranks(ranks, cases, toks, (2, 2), rtol=PLACED_RTOL,
                       state_atol=PLACED_STATE_ATOL, atol=PLACED_ATOL)


def test_cache_write_in_place_clamps_and_keeps_outside_rows():
    cache = torch.zeros(3, 4, 1, 2)
    new = torch.arange(1, 7, dtype=torch.float32).reshape(3, 1, 1, 2)
    out = tf._cache_write(cache, new, torch.tensor([0, 9, 2]), start=4, total=8)
    assert out is cache
    # row 0's position 0 is outside [4, 8); row 1 clamps to 7 → local 3; row 2 outside
    assert cache[0].abs().sum() == 0 and cache[2].abs().sum() == 0
    assert cache[1, 3].tolist() == [[3.0, 4.0]]
    whole = torch.zeros(3, 4, 1, 2)
    tf._cache_write(whole, new, torch.tensor([0, 9, 2]))
    assert whole[0, 0].tolist() == [[1.0, 2.0]] and whole[1, 3].tolist() == [[3.0, 4.0]]
    assert whole[2, 2].tolist() == [[5.0, 6.0]]


def test_shard_block_takes_the_ranks_block(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'init'}", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_debug_mesh((1, 1), ("data", "model"))
        x = torch.arange(24).reshape(2, 3, 4)
        for spec in (shd.P(None, ("data", "model")), shd.P("data", None, "model"), shd.P()):
            assert torch.equal(shd.shard_block(x, spec, mesh), x)
        fn = flash_decode_shardmap(mesh, batch_axes=(), seq_axes=("data", "model"))
        q, k, v, vl = (torch.from_numpy(a) for a in flash_inputs(1))
        torch.testing.assert_close(fn(q, k, v, vl), tf._decode_attention_ref(q, k, v, vl),
                                   rtol=0, atol=1e-5)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """A one-rank gloo group in this process (the port's mesh) and the
    reference's one-device mesh."""
    init = tmp_path_factory.mktemp("lm_group") / "init"
    dist.init_process_group("gloo", init_method=f"file://{init}", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=120))
    try:
        yield make_debug_mesh((1, 1), ("data", "model")), ref_debug_mesh((1, 1),
                                                                          ("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch_id", ["kimi-k2-1t-a32b", "qwen3-8b"])
def test_train_cell_two_steps_match_reference(meshes, arch_id):
    """Two steps of the ``train_4k`` cell at the smoke width: the
    reference's cell jitted on a (1, 1) mesh against the port's on a
    one-rank gloo mesh, the same batch (``2 · microbatches`` rows of 16).
    Kimi: MoE with a shared expert, Adafactor with bf16 state, 8
    microbatches; qwen3: dense, QK-norm, AdamW."""
    _train_cell_two_steps(meshes, arch_id, "whole")


@pytest.mark.parametrize("arch_id", ["kimi-k2-1t-a32b", "qwen3-8b"])
def test_placed_train_cell_two_steps_match_reference(meshes, arch_id):
    """As ``test_train_cell_two_steps_match_reference`` with
    ``weights="placed"``: the reference's parameters carried to the rank
    by ``LMArch.place`` and the placed program (its collectives on groups
    of one, the optimizer's sharded norms and factored means)."""
    _train_cell_two_steps(meshes, arch_id, "placed")


def _train_cell_two_steps(meshes, arch_id, weights):
    mesh, ref_mesh = meshes
    arch, ref = configs.get_arch(arch_id), ref_configs.get_arch(arch_id)
    rp = rt.init_params(jax.random.PRNGKey(0), ref.smoke_cfg)
    m = dict(cfg=arch.smoke_cfg, rp=rp, pp=params_from_jax(jax.device_get(rp), device="cpu"))
    arch = dataclasses.replace(arch, cfg=arch.smoke_cfg)
    ref = dataclasses.replace(ref, cfg=ref.smoke_cfg)
    cell = arch.build_cell("train_4k", mesh, weights=weights)
    ref_cell = ref.build_cell("train_4k", ref_mesh)
    toks = _tokens(m["cfg"].vocab, (ref.microbatches * 2, 17), seed=6)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    rinit = ref_make_optimizer(ref.optimizer)[0]
    rstate = {"params": m["rp"], "opt": rinit(m["rp"])}
    if weights == "placed":
        state = arch.place("train_4k", mesh, m["pp"])
    else:
        state = {"params": m["pp"], "opt": make_optimizer(arch.optimizer)[0](m["pp"])}
    with jax.set_mesh(ref_mesh):
        rstep = jax.jit(ref_cell.fn)
        for _ in range(2):
            rstate, rmet = rstep(rstate, {k: jnp.asarray(v) for k, v in batch.items()})
            state, met = cell.fn(state, {k: _t(v) for k, v in batch.items()})
            np.testing.assert_allclose(float(met["loss"]), float(rmet["loss"]), rtol=1e-4)
            np.testing.assert_allclose(float(met["grad_norm"]), float(rmet["grad_norm"]),
                                       rtol=1e-4)
    want = _np_tree(jax.device_get(rstate))
    got = dict(tree_leaves_with_path(params_to_numpy(state)))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        # an optimizer's first steps move a weight by ~lr (1e-7 here) whatever
        # its gradient's size; moments are compared at their own scale, and a
        # moment stored in bf16 (kimi's Adafactor) within f32 noise of a bf16
        # rounding boundary rounds either way: one bf16 ulp, 2**-7 relative
        rtol = 2.0 ** -7 if w.dtype.name == "bfloat16" else 1e-4
        w = np.asarray(w, np.float32)
        atol = 1e-6 if "['params']" in k else 1e-4 * float(np.abs(w).max() or 1)
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=atol, err_msg=k)


def test_a_meshshape_cell_has_shapes_only_and_placed_weights_raise():
    """A cell on a ``MeshShape`` has shapes only, placed or not (its step
    raises rather than run whole weights); every LM cell builds placed
    (the placements run) with the whole-weight cell's counts; an unknown
    ``weights`` raises."""
    arch = configs.get_arch("qwen3-8b")
    cell = arch.build_cell("decode_32k", production_mesh_shape())
    with pytest.raises(ValueError, match="shapes only"):
        cell.fn({}, {}, torch.zeros(1, 1), torch.zeros(1))
    for arch_id in LM_IDS:
        a = configs.get_arch(arch_id)
        for shape in a.shape_names:
            placed = a.build_cell(shape, production_mesh_shape(), weights="placed")
            assert placed.meta == a.build_cell(shape, production_mesh_shape()).meta
    with pytest.raises(ValueError, match="shapes only"):
        arch.build_cell("train_4k", production_mesh_shape(), weights="placed").fn({}, {})
    with pytest.raises(ValueError, match="weights='tp'"):
        arch.build_cell("train_4k", production_mesh_shape(), weights="tp")


def test_cell_switches_match_reference():
    """Prefill runs chunked attention at 2,048; MoE training turns expert
    gathering off; decode drops the hints and picks FSDP by ``tp_fits``."""
    for arch_id in LM_IDS:
        arch = configs.get_arch(arch_id)
        pre = arch.cell_cfg("prefill_32k")
        assert (pre.attention_impl, pre.attention_chunk) == ("chunked", 2048)
        if arch.cfg.moe is not None:
            assert arch.cell_cfg("train_4k").moe.jit_weight_gather is False
        dec = arch.cell_cfg("decode_32k")
        assert dec.jit_weight_gather is False
        fits = arch.tp_fits(production_mesh_shape())
        assert fits == (arch_id != "kimi-k2-1t-a32b"), arch_id  # 1.03T params / 16 > 8 GiB


def test_lm_collectives_formula():
    """The counts ``hlo_stats.lm_collectives`` gives two cells, recomputed
    from the shapes by hand."""
    mesh = production_mesh_shape()  # (16, 16)
    cfg = configs.get_arch("qwen3-8b").cfg  # 36 L, D 4096, 32 H, dh 128, bf16
    cell = configs.get_arch("qwen3-8b").build_cell("decode_32k", mesh)
    # TP only (weights fit): per layer wo + w_down, plus the embedding, over
    # [128 / 16 tokens, 4096] bf16; flash decoding: max, sum over [8, 32] and
    # a sum over [8, 32, 128] in f32 a layer; no data-axis split, no gather
    b = 128 // 16
    tp = (36 * 2 + 1) * b * 4096 * 2
    flash = 36 * 4 * b * 32 * (2 + 128)
    assert cell.meta["collectives_by_op"] == {"all-reduce": float(tp + flash)}
    long = configs.get_arch("qwen3-8b").build_cell("long_500k", mesh)
    assert long.meta["collectives_by_op"] == {
        "all-reduce": float((36 * 2 + 1) * 1 * 4096 * 2 + 36 * 4 * 1 * 32 * 130)}
    pre = configs.get_arch("yi-6b").build_cell("prefill_32k", mesh)
    ycfg = configs.get_arch("yi-6b").cfg
    gather = sum(np.prod(v.shape) / 16 * 2 for k, v in
                 tree_leaves_with_path(tf.param_structs(ycfg)) if "norm" not in k)
    assert pre.meta["collectives_by_op"]["all-gather"] == pytest.approx(gather, rel=1e-12)
    assert pre.meta["collectives_by_op"]["all-reduce"] == float(
        (32 * 2 + 1) * 2 * 32768 * 4096 * 2)
    assert cell.meta["collective_bytes"] == sum(cell.meta["collectives_by_op"].values())
    assert hlo_stats.lm_collectives(cfg, MeshShape((1, 1), ("data", "model")), "decode",
                                    shd.lm_param_specs(cfg, MeshShape((1, 1), ("data", "model"))),
                                    tf.param_structs(cfg), batch=8, seq=32768,
                                    seq_axes=("model",)) == {}


# ---------------------------------------------------------------------------
# smoke, the CLI, the reference's model invariants
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_smoke_runs_and_repeats_on_the_cpu(arch_id):
    arch = configs.get_arch(arch_id)
    a, b = arch.smoke(seed=0, device="cpu"), arch.smoke(seed=0, device="cpu")
    assert a["device"] == "cpu" and np.isfinite([a["loss0"], a["loss1"]]).all()
    assert a["loss1"] < a["loss0"] + 1.0
    assert (a["loss0"], a["loss1"]) == (b["loss0"], b["loss1"])
    assert torch.equal(a["logits"], b["logits"]) and torch.equal(a["decode_logits"],
                                                                 b["decode_logits"])


def test_smoke_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        configs.get_arch("qwen3-8b").smoke()


def test_train_cli_smoke(capsys, tmp_path):
    from repro_torch.launch import train

    train.main(["--arch", "yi-6b", "--smoke", "--steps", "4", "--checkpoint-every", "2",
                "--device", "cpu", "--checkpoint-dir", str(tmp_path)])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("trained yi-6b 4 steps: loss ") and line.endswith("(restarts=0)")
    assert sorted(p.name for p in tmp_path.iterdir())
    with pytest.raises(SystemExit, match="--smoke"):
        train.main(["--arch", "yi-6b", "--device", "cpu"])
    train.main(["--arch", "deepfm", "--smoke", "--steps", "2", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("trained deepfm 2 steps: loss ") and line.endswith("(restarts=0)")


def _tiny(attn="full", moe_cfg=None, qk=False):
    return tf.TransformerConfig(
        name="tiny", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64, vocab=64,
        qk_norm=qk, moe=moe_cfg, attention_impl=attn, attention_chunk=8, dtype=torch.float32)


def test_chunked_attention_equals_full():
    p = tf.init_params(torch.Generator().manual_seed(0), _tiny(), device="cpu")
    toks = _t(_tokens(64, (2, 20)))
    with torch.no_grad():
        lf, _ = tf.forward(p, _tiny("full"), toks)
        lc, _ = tf.forward(p, _tiny("chunked"), toks)
    np.testing.assert_allclose(lf.numpy(), lc.numpy(), atol=2e-5)


def test_decode_matches_forward():
    cfg = _tiny(qk=True)
    p = tf.init_params(torch.Generator().manual_seed(1), cfg, device="cpu")
    toks = _t(_tokens(64, (2, 10), seed=1))
    with torch.no_grad():
        full, _ = tf.forward(p, cfg, toks)
        cache = tf.init_kv_cache(cfg, 2, 10, torch.float32, device="cpu")
        lens = torch.zeros(2, dtype=torch.int32)
        outs = []
        for t in range(10):
            lg, cache = tf.decode_step(p, cfg, cache, toks[:, t:t + 1], lens)
            lens = lens + 1
            outs.append(lg)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(), atol=3e-5)


def test_moe_capacity_conservation():
    cfg = moe.MoEConfig(n_experts=8, top_k=2, d_model=16, d_ff=32, capacity_factor=8.0)
    g = torch.Generator().manual_seed(0)
    p = moe.moe_init(g, cfg, device="cpu")
    x = torch.randn(64, 16, generator=g)
    y, aux = moe.moe_apply(p, cfg, x)
    assert y.shape == x.shape and torch.isfinite(y).all()
    assert float(aux["load_balance_loss"]) > 0
    assert (y.abs().sum(-1) > 0).all()  # nothing drops: every token reaches an expert
    tok, _ = moe._dispatch(moe._route(p, cfg, x)[2], moe._route(p, cfg, x)[1], cfg)
    kept = tok[tok < 64]
    # no token counted twice within an expert; every (token, expert) pair kept once
    per_expert = tok.reshape(cfg.n_experts, -1)
    for row in per_expert:
        live = row[row < 64]
        assert len(torch.unique(live)) == len(live)
    assert len(kept) == 64 * cfg.top_k


def test_moe_dropping_under_tight_capacity():
    cfg = moe.MoEConfig(n_experts=4, top_k=1, d_model=8, d_ff=16, capacity_factor=0.25)
    g = torch.Generator().manual_seed(2)
    p = moe.moe_init(g, cfg, device="cpu")
    y, _ = moe.moe_apply(p, cfg, torch.randn(64, 8, generator=g))
    assert int((y.abs().sum(-1) == 0).sum()) > 0  # tight capacity must drop tokens


def _moe_index_add(params, cfg, x):
    """The combine before C7: the weighted slots scatter-added back to
    their tokens with ``index_add`` (the reference's scatter-add)."""
    T, D = x.shape
    C = moe._capacity(T, cfg)
    _, gate_w, idx = moe._route(params, cfg, x)
    tok, w = moe._dispatch(idx, gate_w, cfg)
    xe = torch.cat([x, x.new_zeros((1, D))])[tok].reshape(cfg.n_experts, C, D)
    ye = moe._swiglu(xe, params["w_gate"], params["w_up"], params["w_down"])
    contrib = ye.reshape(-1, D) * w[:, None].to(ye.dtype)
    return ye.new_zeros((T + 1, D)).index_add(0, tok, contrib)[:T]


@pytest.mark.parametrize("top_k", [1, 2, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_moe_combine_equals_index_add_bit_for_bit(dtype, top_k):
    """C7: the slot-order combine gives the bits of the ``index_add``
    combine on the CPU (in bf16 too: ``index_add`` accumulates a row in
    f32 and rounds once), with pairs dropped (capacity factor 0.6), and
    so do the gradients of the input and of every expert weight."""
    cfg = moe.MoEConfig(n_experts=8, top_k=top_k, d_model=16, d_ff=24, capacity_factor=0.6)
    g = torch.Generator().manual_seed(top_k)
    p = moe.moe_init(g, cfg, dtype=dtype, device="cpu")
    x = torch.randn(40, 16, generator=g).to(dtype)
    tok, _ = moe._dispatch(moe._route(p, cfg, x)[2], moe._route(p, cfg, x)[1], cfg)
    assert int((tok < 40).sum()) < 40 * top_k  # pairs were dropped
    got = []
    for f in (_moe_index_add, lambda pp, c, xx: moe.moe_apply(pp, c, xx)[0]):
        pp = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        xx = x.clone().requires_grad_(True)
        y = f(pp, cfg, xx)
        (y.float() * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum().backward()
        got.append((y.detach(), xx.grad, {k: v.grad for k, v in pp.items()}))
    (y0, gx0, gp0), (y1, gx1, gp1) = got
    assert torch.equal(y0, y1) and torch.equal(gx0, gx1)
    for k in gp0:
        assert torch.equal(gp0[k], gp1[k]), k


def test_grad_flows_through_every_param():
    cfg = _tiny(moe_cfg=moe.MoEConfig(n_experts=4, top_k=2, d_model=32, d_ff=16))
    p = tf.init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    toks = _t(_tokens(64, (2, 12), seed=3))
    _, g = value_and_grad(lambda pp, t: tf.lm_loss(pp, cfg, t[:, :-1], t[:, 1:]), p, toks)
    zero = [k for k, v in tree_leaves_with_path(g) if float(v.abs().sum()) == 0]
    assert not any("moe" in z and "router" in z for z in zero), zero


def test_train_step_under_remat_equals_without():
    cfg = _tiny(qk=True)
    p = tf.init_params(torch.Generator().manual_seed(7), cfg, device="cpu")
    toks = _t(_tokens(64, (4, 9), seed=7))
    oinit, oupd = make_optimizer(configs.get_arch("yi-6b").optimizer)
    out = []
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        step = make_train_step(lambda pp, b: tf.lm_loss(pp, c, b[:, :-1], b[:, 1:]), oupd)
        out.append(step({"params": p, "opt": oinit(p)}, toks))
    assert float(out[0][1]["loss"]) == float(out[1][1]["loss"])
    for (k, a), (_, b) in zip(tree_leaves_with_path(out[0][0]), tree_leaves_with_path(out[1][0])):
        assert torch.equal(a, b), k


def test_lm_modules_import_no_jax():
    code = (
        "import sys\n"
        "import repro_torch.models.transformer, repro_torch.models.moe\n"
        "import repro_torch.dist.collectives, repro_torch.launch.train\n"
        "from repro_torch.configs import get_arch\n"
        "from repro_torch.launch.mesh import production_mesh_shape\n"
        "for a in ('olmoe-1b-7b', 'kimi-k2-1t-a32b', 'qwen3-8b', 'yi-6b', 'deepseek-coder-33b'):\n"
        "    arch = get_arch(a)\n"
        "    for s in arch.shape_names:\n"
        "        arch.build_cell(s, production_mesh_shape(multi_pod=True))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
