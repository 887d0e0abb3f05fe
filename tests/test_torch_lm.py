"""The port's LM models against the reference, on the CPU: the configs,
parameter trees and placement specs of ``configs.base.LMArch`` and the
five LM configs, and ``repro_torch.models.{common,moe,transformer}``.
(The cells, flash decoding, ``smoke()``, the train CLI and the model
invariants: ``tests/test_torch_lm_cells.py``.)

* Every config's fields, ``model_flops``, its parameter tree at the full
  and the smoke width (``meta``, never allocated) and ``lm_param_specs``
  / ``kv_cache_spec`` on both production meshes against the reference's.
* The reference's own parameters (``init_params`` at each config's smoke
  width) cross through ``params_from_jax``; inputs come from numpy with a
  seed. ``forward`` logits for all five smoke configs (f32, atol 2e-5, as
  the reference's ``test_chunked_attention_equals_full``), ``lm_loss``
  and every gradient leaf against ``jax.value_and_grad`` (rtol 1e-4; the
  atol is 1e-4 of the leaf's largest entry: f32 sums in another order),
  ``decode_step`` over 10 steps, logits and cache (atol 3e-5), the
  collected K/V, the chunked form.
* ``moe_apply``'s output and aux (atol 1e-5), its dispatch against a
  numpy oracle of the reference's rule on the reference's own routing,
  and the same dropped tokens under tight capacity; top-k ties.

torch runs at one intra-op thread (``torch_cases.one_intra_op_thread``).
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch_cases import one_intra_op_thread  # noqa: F401
from torch_configs_cases import LM_IDS, torch_dtype_name

from repro import configs as ref_configs
from repro.dist import sharding as ref_shd
from repro.models import moe as ref_moe
from repro.models import transformer as rt
from repro_torch import configs
from repro_torch.configs import base
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.models.common import params_from_jax
from repro_torch.train.train_step import value_and_grad
from repro_torch.tree import tree_leaves_with_path


def _np_tree(tree) -> dict:
    """keystr path → numpy array of a jax tree."""
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tokens(vocab: int, shape, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a)).long()


@pytest.fixture(scope="module")
def models():
    """arch id → the reference's smoke parameters, the port's copy, the
    tokens, and the reference's forward / loss / gradients / decode (jitted
    once a config)."""
    cache = {}

    def get(arch_id):
        if arch_id not in cache:
            rcfg = ref_configs.get_arch(arch_id).smoke_cfg
            cfg = configs.get_arch(arch_id).smoke_cfg
            rp = rt.init_params(jax.random.PRNGKey(0), rcfg)
            toks = _tokens(cfg.vocab, (2, 16))
            grad_fn = jax.value_and_grad(lambda p, t: rt.lm_loss(p, rcfg, t[:, :-1], t[:, 1:]),
                                         has_aux=True)
            logits, ((loss, _), grads) = jax.jit(
                lambda p, t: (rt.forward(p, rcfg, t)[0], grad_fn(p, t)))(rp, jnp.asarray(toks))
            step = jax.jit(partial(rt.decode_step, cfg=rcfg))
            rc = rt.init_kv_cache(rcfg, 2, 10, jnp.float32)
            lens = jnp.zeros(2, jnp.int32)
            dec = []
            for t in range(10):
                lg, rc = step(rp, cache=rc, tokens=jnp.asarray(toks[:, t:t + 1]), lengths=lens)
                lens = lens + 1
                dec.append(np.asarray(lg))
            cache[arch_id] = dict(
                rcfg=rcfg, cfg=cfg, rp=rp, pp=params_from_jax(jax.device_get(rp), device="cpu"),
                toks=toks, logits=np.asarray(logits), loss=float(loss), grads=_np_tree(grads),
                decode=np.stack(dec), cache={k: np.asarray(v) for k, v in rc.items()})
        return cache[arch_id]

    return get


# ---------------------------------------------------------------------------
# configs and parameter trees
# ---------------------------------------------------------------------------


def _fields(obj) -> dict:
    """A dataclass's fields with dtypes by name (torch's and jnp's differ)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            v = _fields(v)
        elif "dtype" in f.name:
            v = torch_dtype_name(v) if isinstance(v, torch.dtype) else str(np.dtype(v))
        out[f.name] = v
    return out


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_config_matches_reference(arch_id):
    got, want = configs.get_arch(arch_id), ref_configs.get_arch(arch_id)
    assert isinstance(got, base.LMArch)
    for name in ("cfg", "smoke_cfg", "optimizer"):
        assert _fields(getattr(got, name)) == _fields(getattr(want, name)), name
    assert (got.name, got.family, got.microbatches, got.shape_names) == (
        want.name, want.family, want.microbatches, want.shape_names)
    assert got._active_params() == want._active_params()
    for shape in want.shape_names:
        assert got.model_flops(shape) == want.model_flops(shape)
    assert base.LM_SHAPES == ref_configs.base.LM_SHAPES


@pytest.mark.parametrize("width", ["full", "smoke"])
@pytest.mark.parametrize("arch_id", LM_IDS)
def test_param_structs_match_reference(arch_id, width):
    arch, ref = configs.get_arch(arch_id), ref_configs.get_arch(arch_id)
    cfg, rcfg = (arch.cfg, ref.cfg) if width == "full" else (arch.smoke_cfg, ref.smoke_cfg)
    want = jax.eval_shape(lambda k: rt.init_params(k, rcfg), jax.random.PRNGKey(0))
    want = {jax.tree_util.keystr(k): (tuple(v.shape), str(np.dtype(v.dtype)))
            for k, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    got = {k: (tuple(v.shape), torch_dtype_name(v.dtype))
           for k, v in tree_leaves_with_path(tf.param_structs(cfg))}
    assert got == want
    assert all(v.device.type == "meta" for _, v in tree_leaves_with_path(arch.abstract_params()))
    assert base.count_abstract_params(arch.abstract_params()) == \
        ref_configs.base.count_abstract_params(ref.abstract_params())
    if width == "smoke":  # a drawn tree has the structs' shapes, ones for norms
        params = tf.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
        drawn = {k: (tuple(v.shape), torch_dtype_name(v.dtype))
                 for k, v in tree_leaves_with_path(params)}
        assert drawn == want
        assert torch.all(params["layers"]["attn_norm"] == 1)
        s = (2.0 / (cfg.d_model + cfg.n_heads * cfg.head_dim)) ** 0.5
        assert abs(float(params["layers"]["wq"].std()) / s - 1) < 0.1


def _spec_tuple(spec) -> tuple:
    return tuple(e if e is None or isinstance(e, str) else tuple(e) for e in spec)


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("multi", [False, True], ids=["pod256", "pod512x2"])
@pytest.mark.parametrize("arch_id", LM_IDS)
def test_lm_param_specs_match_reference(arch_id, multi, fsdp):
    port_mesh = production_mesh_shape(multi_pod=multi)
    ref_mesh = AbstractMesh(port_mesh.shape, port_mesh.mesh_dim_names)
    cfg, rcfg = configs.get_arch(arch_id).cfg, ref_configs.get_arch(arch_id).cfg
    want = ref_shd.lm_param_specs(rcfg, ref_mesh, fsdp=fsdp)
    want = {jax.tree_util.keystr(k): _spec_tuple(v) for k, v in
            jax.tree_util.tree_flatten_with_path(
                want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
    got = {k: _spec_tuple(v) for k, v in tree_leaves_with_path(shd.lm_param_specs(cfg, port_mesh,
                                                                                   fsdp=fsdp))}
    assert got == want
    for batch in (128, 1, 24):
        for seq_shard in (False, True):
            g = shd.kv_cache_spec(port_mesh, batch=batch, seq_shard=seq_shard)
            w = ref_shd.kv_cache_spec(ref_mesh, batch=batch, seq_shard=seq_shard)
            assert {k: _spec_tuple(v) for k, v in g.items()} == \
                {k: _spec_tuple(v) for k, v in w.items()}


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_forward_matches_reference(models, arch_id):
    m = models(arch_id)
    with torch.no_grad():
        got, aux = tf.forward(m["pp"], m["cfg"], _t(m["toks"]))
    np.testing.assert_allclose(got.numpy(), m["logits"], rtol=0, atol=2e-5)
    module = tf.Transformer(m["cfg"], m["pp"])
    with torch.no_grad():
        again, _ = module(_t(m["toks"]))
    assert torch.equal(again, got)
    assert set(module.state_dict()) >= {"embed", "layers.wq", "final_norm"}


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_lm_loss_and_gradients_match_reference(models, arch_id):
    m = models(arch_id)
    toks = _t(m["toks"])
    (loss, aux), grads = value_and_grad(
        lambda p, t: tf.lm_loss(p, m["cfg"], t[:, :-1], t[:, 1:]), m["pp"], toks)
    np.testing.assert_allclose(float(loss), m["loss"], rtol=1e-4)
    assert set(aux) == {"nll", "aux"}
    got = dict(tree_leaves_with_path(grads))
    assert sorted(got) == sorted(m["grads"])
    for k, want in m["grads"].items():
        scale = float(np.abs(want).max())
        assert scale > 0 or "norm" in k, k  # every weight but a norm gets a gradient
        np.testing.assert_allclose(got[k].numpy(), want, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=k)


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_decode_matches_reference(models, arch_id):
    m = models(arch_id)
    cache = tf.init_kv_cache(m["cfg"], 2, 10, torch.float32, device="cpu")
    k_store = cache["k"]
    lens = torch.zeros(2, dtype=torch.int32)
    outs = []
    with torch.no_grad():
        for t in range(10):
            lg, cache = tf.decode_step(m["pp"], m["cfg"], cache, _t(m["toks"][:, t:t + 1]), lens)
            lens = lens + 1
            outs.append(lg.numpy())
    assert cache["k"] is k_store  # written in place
    np.testing.assert_allclose(np.stack(outs), m["decode"], rtol=0, atol=3e-5)
    for k in ("k", "v"):
        np.testing.assert_allclose(cache[k].numpy(), m["cache"][k], rtol=0, atol=3e-5)


@pytest.mark.parametrize("arch_id", ["qwen3-8b", "olmoe-1b-7b"])
def test_chunked_forward_and_collected_kv_match_reference(models, arch_id):
    m = models(arch_id)
    toks = _tokens(m["cfg"].vocab, (2, 20), seed=1)
    rcfg = dataclasses.replace(m["rcfg"], attention_impl="chunked", attention_chunk=8)
    cfg = dataclasses.replace(m["cfg"], attention_impl="chunked", attention_chunk=8)
    want, waux = rt.forward(m["rp"], rcfg, jnp.asarray(toks), collect_kv=True)
    with torch.no_grad():
        got, gaux = tf.forward(m["pp"], cfg, _t(toks), collect_kv=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)
    for k in ("k", "v"):
        np.testing.assert_allclose(gaux["kv_cache"][k].numpy(), np.asarray(waux["kv_cache"][k]),
                                   rtol=0, atol=2e-5)
    np.testing.assert_allclose(float(gaux["load_balance_loss"]),
                               float(waux["load_balance_loss"]), rtol=1e-5, atol=1e-7)


def test_common_blocks_match_reference():
    """``layer_norm``, ``mlp_apply`` over the reference's ``mlp_init``,
    ``rope_freqs`` / ``apply_rope`` at qwen3's theta (f32, atol 1e-5)."""
    from repro.models import common as ref_common
    from repro_torch.models import common

    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    w, b = rng.standard_normal(16).astype(np.float32), rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        common.layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)).numpy(),
        np.asarray(ref_common.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))),
        rtol=0, atol=1e-5)
    rp = ref_common.mlp_init(jax.random.PRNGKey(1), (16, 32, 8))
    pp = {k: [torch.from_numpy(np.array(a)) for a in v] for k, v in rp.items()}
    for fa in (None, torch.sigmoid):
        got = common.mlp_apply(pp, torch.from_numpy(x), final_activation=fa).numpy()
        want = ref_common.mlp_apply(rp, jnp.asarray(x),
                                    final_activation=None if fa is None else jax.nn.sigmoid)
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    drawn = common.mlp_init(torch.Generator().manual_seed(0), (16, 32, 8))
    assert [tuple(t.shape) for t in drawn["w"]] == [(16, 32), (32, 8)]
    assert all(torch.all(t == 0) for t in drawn["b"])
    inv = common.rope_freqs(128, 1e6)
    np.testing.assert_allclose(inv.numpy(), np.asarray(ref_common.rope_freqs(128, 1e6)),
                               rtol=1e-6)
    q = rng.standard_normal((2, 7, 4, 128)).astype(np.float32)
    pos = np.arange(7)[None, :] + np.array([[0], [900]])
    np.testing.assert_allclose(
        common.apply_rope(torch.from_numpy(q), torch.from_numpy(pos), inv).numpy(),
        np.asarray(ref_common.apply_rope(jnp.asarray(q), jnp.asarray(pos),
                                         ref_common.rope_freqs(128, 1e6))), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

MOE_CASES = {
    "olmoe-smoke": (dict(n_experts=8, top_k=2, d_model=64, d_ff=32), 48),
    "kimi-smoke-shared": (dict(n_experts=8, top_k=2, d_model=64, d_ff=32, n_shared_experts=1),
                          48),
    "tight": (dict(n_experts=4, top_k=1, d_model=8, d_ff=16, capacity_factor=0.25), 64),
}


def _dispatch_oracle(expert_idx: np.ndarray, E: int, C: int) -> np.ndarray:
    """The reference's rule in numpy: pairs in (token, k) order grouped by
    expert, stable; an expert's r-th pair takes slot e·C + r while r < C."""
    T, K = expert_idx.shape
    tok = np.full(E * C, T, np.int64)
    fill = np.zeros(E, np.int64)
    for t in range(T):
        for k in range(K):
            e = int(expert_idx[t, k])
            if fill[e] < C:
                tok[e * C + fill[e]] = t
            fill[e] += 1
    return tok


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_matches_reference(case):
    kw, T = MOE_CASES[case]
    rcfg, cfg = ref_moe.MoEConfig(**kw), moe.MoEConfig(**kw)
    rp = ref_moe.moe_init(jax.random.PRNGKey(3), rcfg)
    pp = params_from_jax(jax.device_get(rp), device="cpu")
    x = np.random.default_rng(2).standard_normal((T, kw["d_model"])).astype(np.float32)
    want, waux = jax.jit(partial(ref_moe.moe_apply, cfg=rcfg))(rp, x=jnp.asarray(x))
    got, gaux = moe.moe_apply(pp, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(gaux["load_balance_loss"]), float(waux["load_balance_loss"]),
                               rtol=0, atol=1e-5)
    # the same dispatch as the reference's rule on the reference's routing
    probs = jax.nn.softmax(jnp.asarray(x) @ rp["router"], axis=-1)
    ref_idx = np.asarray(jax.lax.top_k(probs, rcfg.top_k)[1])
    _, gate_w, idx = moe._route(pp, cfg, torch.from_numpy(x))
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    C = moe._capacity(T, cfg)
    assert C == ref_moe._capacity(T, rcfg)
    tok, w = moe._dispatch(idx, gate_w, cfg)
    np.testing.assert_array_equal(tok.numpy(), _dispatch_oracle(ref_idx, cfg.n_experts, C))
    assert np.all((w.numpy() > 0) == (tok.numpy() < T))
    # the same dropped tokens (a token every one of whose experts was full)
    dropped = np.abs(np.asarray(want)).sum(-1) == 0
    assert np.array_equal(np.abs(got.numpy()).sum(-1) == 0, dropped)
    if case == "tight":
        assert dropped.any()
        assert np.array_equal(dropped, ~np.isin(np.arange(T), tok.numpy()))


def test_moe_top_k_ties_go_to_the_lower_expert():
    """Equal router probabilities: the lower expert index wins, as
    ``jax.lax.top_k`` breaks ties."""
    cfg = moe.MoEConfig(n_experts=6, top_k=3, d_model=4, d_ff=8)
    params = {"router": torch.zeros(4, 6)}
    _, gate_w, idx = moe._route(params, cfg, torch.ones(5, 4))
    assert idx.tolist() == [[0, 1, 2]] * 5
    torch.testing.assert_close(gate_w, torch.full((5, 3), 1 / 3))
