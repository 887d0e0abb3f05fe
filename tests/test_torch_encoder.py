"""The port's SPLADE encoder (``repro_torch/models``) and the host half
of its Seismic search against the reference, on the CPU.

The reference's own parameters cross through ``params_from_jax``; inputs
come from numpy seeds. Values are held to rtol 1e-5 (atol 1e-6: the
same f32 arithmetic, summed in another order), every leaf's gradient
against ``jax.value_and_grad`` to rtol 1e-4 with an atol of 1e-5 times
the leaf's largest reference gradient: at the loss's temperature (0.05)
a leaf's gradients reach 200, and f32 sums in another order differ by
a few ulp of the leaf's largest entry (up to 3e-6 of it), which a fixed
atol of 1e-6 cannot hold near zero. At the ties of the PACT clip the
port must split the gradient as JAX does. The host
Seismic search is one numpy program in both packages, so its ids and
scores are compared exactly."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.seismic import SeismicIndex as RefSeismicIndex
from repro.core.seismic import SeismicParams as RefSeismicParams
from repro.data import synthetic as ref_synthetic
from repro.models import common as ref_common
from repro.models import sparse_encoder as ref_enc
from repro.models import transformer as ref_tf
from repro_torch.core.forward_index import VALUE_FORMATS, ForwardIndex
from repro_torch.core.seismic import SeismicIndex, SeismicParams
from repro_torch.models import common, sparse_encoder as enc, transformer
from repro_torch.tree import tree_leaves_with_path

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
#: a leaf gradient's atol, as a share of the leaf's largest reference entry
GRAD_ATOL_SHARE = 1e-5
#: the reference's own test size
SMALL = dict(vocab=512, n_layers=2, d_model=32, n_heads=4, d_ff=64, max_len=16)


def _cfgs(**kw):
    return ref_enc.SparseEncoderConfig(**SMALL, **kw), enc.SparseEncoderConfig(**SMALL, **kw)


def _ref_params(cfg, seed=0):
    return jax.device_get(ref_enc.encoder_init(jax.random.PRNGKey(seed), cfg))


def _port(tree):
    return enc.params_from_jax(tree, device="cpu")


def _batch(cfg, seed=0, B=4, padded=True):
    """Token batch from numpy; with ``padded`` every row has its own length."""
    rng = np.random.default_rng(seed)
    S = cfg.max_len
    out = {}
    for side in ("q", "d"):
        out[f"{side}_tokens"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        lens = rng.integers(1, S + 1, B) if padded else np.full(B, S)
        out[f"{side}_mask"] = np.arange(S)[None, :] < lens[:, None]
    return out


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype != bool else torch.from_numpy(v)
            for k, v in batch.items()}


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got),
                               np.asarray(want), rtol=rtol, atol=atol)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op torch thread per test process: the workers of a
    parallel run share the cores, and torch's default of one thread per
    core made them oversubscribe (the CLI test took 11 s alone, 476 s in
    a 6-worker run). The previous count is restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- building blocks ------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 32)).astype(np.float32)
    w = rng.normal(size=32).astype(np.float32)
    want = ref_common.rms_norm(jnp.asarray(x, dtype), jnp.asarray(w))
    got = common.rms_norm(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(w))
    assert got.dtype == getattr(torch, dtype)
    tol = RTOL if dtype == "float32" else 1e-2  # one bf16 rounding of the same f32 value
    _close(got.float(), np.asarray(want, np.float32), rtol=tol)


ATTN = [  # (Sq, Sk, H, Hk, causal, q_offset, impl, chunk)
    (7, 7, 4, 4, False, 0, "full", 0),
    (7, 7, 4, 4, True, 0, "full", 0),
    (5, 9, 4, 2, True, 4, "full", 0),
    (6, 6, 4, 1, False, 0, "full", 0),
    (7, 10, 4, 4, False, 0, "chunked", 4),
    (10, 10, 4, 2, True, 0, "chunked", 4),
    (3, 11, 4, 4, True, 8, "chunked", 5),
    (8, 8, 4, 4, False, 0, "chunked", 8),
]


@pytest.mark.parametrize("Sq,Sk,H,Hk,causal,q_offset,impl,chunk", ATTN)
def test_attention(Sq, Sk, H, Hk, causal, q_offset, impl, chunk):
    rng = np.random.default_rng(Sq * 100 + Sk)
    B, dh = 2, 8
    q = rng.normal(size=(B, Sq, H, dh)).astype(np.float32)
    k = rng.normal(size=(B, Sk, Hk, dh)).astype(np.float32)
    v = rng.normal(size=(B, Sk, Hk, dh)).astype(np.float32)
    w = rng.normal(size=(B, Sq, H, dh)).astype(np.float32)
    kw = dict(causal=causal, q_offset=q_offset, impl=impl, chunk=chunk or 1024)

    def ref_loss(q, k, v):
        out = ref_tf.attention(q, k, v, **kw)
        return jnp.sum(out * w), out

    (_, want), want_g = jax.value_and_grad(ref_loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    got = transformer.attention(tq, tk, tv, **kw)
    (got * torch.from_numpy(w)).sum().backward()
    _close(got, want)
    for t, g in zip((tq, tk, tv), want_g):
        _close(t.grad, g, GRAD_RTOL, GRAD_ATOL)


# -- the encoder ----------------------------------------------------------------


def test_init_tree_matches_the_reference_structure():
    cfg_r, cfg_p = _cfgs(quantize=True)
    ref = _ref_params(cfg_r)
    port = enc.encoder_init(torch.Generator().manual_seed(0), cfg_p, device="cpu")
    want = [(p, np.shape(a), str(np.asarray(a).dtype)) for p, a in
            ((jax.tree_util.keystr(k), a) for k, a in jax.tree_util.tree_flatten_with_path(ref)[0])]
    got = [(p, tuple(t.shape), str(t.numpy().dtype)) for p, t in tree_leaves_with_path(port)]
    assert got == want
    assert common.count_params(port) == ref_common.count_params(ref)
    # the reference's scales; ones and zeros where it has them
    assert abs(port["embed"].std().item() - 0.02) < 1e-3
    assert abs(port["layers"]["w_up"].std().item() - (2 / (32 + 64)) ** 0.5) < 0.01
    assert torch.equal(port["layers"]["attn_norm"], torch.ones(2, 32))
    assert torch.equal(port["mlm_bias"], torch.zeros(512))
    assert port["quant_hi"].item() == 4.0
    w = common.dense_init(torch.Generator().manual_seed(1), 300, 500, device="cpu")
    assert w.shape == (300, 500) and abs(w.std().item() - (2 / 800) ** 0.5) < 1e-3
    # one seed, one tree
    again = enc.encoder_init(torch.Generator().manual_seed(0), cfg_p, device="cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(tree_leaves_with_path(port), tree_leaves_with_path(again)))


def test_params_cross_both_ways_and_the_module_holds_them():
    cfg_r, cfg_p = _cfgs(quantize=True)
    ref = _ref_params(cfg_r)
    port = _port(ref)
    back = enc.params_to_numpy(port)
    for (kp, a), (p, b) in zip(jax.tree_util.tree_flatten_with_path(ref)[0],
                               tree_leaves_with_path(back)):
        assert jax.tree_util.keystr(kp) == p
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    model = enc.SparseEncoder(cfg_p, port)
    assert sorted(model.state_dict()) == sorted(
        ["embed", "pos", "final_norm", "mlm_bias", "quant_hi"]
        + [f"layers.{k}" for k in enc.LAYER_KEYS])
    assert model.layers["wq"].data_ptr() == port["layers"]["wq"].data_ptr()
    b = _torch(_batch(cfg_p))
    torch.testing.assert_close(model(b["d_tokens"], b["d_mask"]),
                               enc.encode(port, cfg_p, b["d_tokens"], b["d_mask"]),
                               rtol=0, atol=0)
    assert common.count_params(model.tree()) == common.count_params(port)


@pytest.mark.parametrize("padded", [True, False], ids=["padded", "full"])
@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "qat"])
def test_encode(padded, quantize):
    cfg_r, cfg_p = _cfgs(quantize=quantize)
    ref = _ref_params(cfg_r, seed=1)
    batch = _batch(cfg_p, seed=2, padded=padded)
    want = ref_enc.encode(ref, cfg_r, jnp.asarray(batch["d_tokens"]), jnp.asarray(batch["d_mask"]))
    tb = _torch(batch)
    got = enc.encode(_port(ref), cfg_p, tb["d_tokens"], tb["d_mask"])
    assert got.shape == (4, 512) and got.dtype == torch.float32
    assert bool((got >= 0).all())
    _close(got, want)
    if padded:  # the mask gates the pooling: a masked position never counts
        one = batch["d_mask"].copy()
        one[0, 1:] = False
        tb["d_mask"] = torch.from_numpy(one)
        first = enc.encode(_port(ref), cfg_p, tb["d_tokens"][:1, :1], tb["d_mask"][:1, :1])
        full = enc.encode(_port(ref), cfg_p, tb["d_tokens"], tb["d_mask"])
        assert not torch.equal(first[0], full[0])  # attention is unmasked, as in the reference
        want = ref_enc.encode(ref, cfg_r, jnp.asarray(batch["d_tokens"]), jnp.asarray(one))
        _close(full, want)


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "qat"])
@pytest.mark.parametrize("padded", [True, False], ids=["padded", "full"])
def test_contrastive_loss_and_every_leaf_gradient(quantize, padded):
    # a clip inside the activations' range, so quant_hi gets a gradient
    cfg_r, cfg_p = _cfgs(quantize=quantize, flops_lambda=1e-2, quant_clip_init=0.2)
    ref = _ref_params(cfg_r, seed=3)
    batch = _batch(cfg_p, seed=4, padded=padded)
    (want, want_aux), want_g = jax.jit(jax.value_and_grad(
        lambda p: ref_enc.contrastive_loss(p, cfg_r, _jnp(batch)), has_aux=True))(ref)

    from repro_torch.train.train_step import value_and_grad

    (got, aux), grads = value_and_grad(
        lambda p, b: enc.contrastive_loss(p, cfg_p, b), _port(ref), _torch(batch))
    _close(got, want)
    assert sorted(aux) == sorted(want_aux)
    for k in aux:
        assert aux[k].dim() == 0
        _close(aux[k], want_aux[k])
    paths = 0
    for (kp, g_want), (p, g_got) in zip(jax.tree_util.tree_flatten_with_path(want_g)[0],
                                        tree_leaves_with_path(grads)):
        assert jax.tree_util.keystr(kp) == p
        scale = float(np.abs(np.asarray(g_want)).max())
        _close(g_got, g_want, GRAD_RTOL, max(GRAD_ATOL, GRAD_ATOL_SHARE * scale))
        paths += 1
    assert paths == 12 + quantize
    if quantize:
        assert float(grads["quant_hi"]) != 0.0


# -- QAT ---------------------------------------------------------------------


@pytest.mark.parametrize("hi", [4.0, 2.5, 1e-6, -1.0], ids=["hi4", "hi-at-an-act", "hi-at-floor",
                                                            "hi-below-floor"])
@pytest.mark.parametrize("bits", [8, 4])
def test_fake_quantize_forward_and_gradients_at_ties(hi, bits):
    acts = np.array([0.0, 1.0, 4.0, 5.0, -1.0, 2.5, 1e-6, 3.99, 0.3], np.float32)
    w = np.random.default_rng(bits).normal(size=acts.shape).astype(np.float32)

    def ref_f(a, h):
        out = ref_enc.fake_quantize(a, h, bits)
        return jnp.sum(out * w), out

    (_, want), (ga, gh) = jax.value_and_grad(ref_f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(acts), jnp.float32(hi))
    ta = torch.from_numpy(acts).requires_grad_(True)
    th = torch.tensor(hi, dtype=torch.float32, requires_grad=True)
    got = enc.fake_quantize(ta, th, bits)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ga), rtol=1e-6)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(gh), rtol=1e-6)


def test_fake_quantize_tie_rule_against_clamp():
    """The reference's numbers at the clip's ties: half to each side."""
    a = torch.tensor([0.0, 1.0, 4.0, 5.0], requires_grad=True)
    hi = torch.tensor(4.0, requires_grad=True)
    enc.fake_quantize(a, hi, 8).sum().backward()
    assert a.grad.tolist() == [0.5, 1.0, 0.5, 0.0]
    assert hi.grad.item() == 1.5


def test_export_quant_clip():
    cfg_r, cfg_p = _cfgs(quantize=True)
    ref = _ref_params(cfg_r)
    ref = dict(ref, quant_hi=np.float32(3.25))
    assert enc.export_quant_clip(_port(ref), cfg_p, 0.5) == \
        ref_enc.export_quant_clip(ref, cfg_r, 0.5) == (0.0, 6.5)
    plain_r, plain_p = _cfgs()
    bare = _ref_params(plain_r)
    with pytest.raises(ValueError) as want:
        ref_enc.export_quant_clip(bare, plain_r)
    with pytest.raises(ValueError) as got:
        enc.export_quant_clip(_port(bare), plain_p)
    assert str(got.value) == str(want.value)


def test_no_jax_on_import():
    code = ("import sys; import repro_torch.models.sparse_encoder, repro_torch.train.elastic, "
            "repro_torch.train.train_step, repro_torch.train.checkpoint, "
            "repro_torch.launch.train_sparse_encoder; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')); "
            "assert not bad, bad")
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env=dict(os.environ, PYTHONPATH=src))


# -- the host Seismic search --------------------------------------------------------


@pytest.fixture(scope="module")
def seismic_pair():
    kw = dict(name="splade", dim=2048, n_docs=300, n_queries=6, seed=5)
    col = ref_synthetic.generate_collection(ref_synthetic.SyntheticConfig(**kw),
                                            value_format="f16")
    params = dict(n_postings=120, block_size=16)
    ref = RefSeismicIndex.build(col.fwd, RefSeismicParams(**params))
    f = col.fwd
    port = SeismicIndex.build(
        ForwardIndex(f.components, f.values, f.offsets, f.dim, VALUE_FORMATS[f.value_format.name]),
        SeismicParams(**params))
    Q = np.stack([col.query_dense(i) for i in range(col.n_queries)])
    return ref, port, Q


@pytest.mark.parametrize("codec", ["uncompressed", "dotvbyte", "streamvbyte", "bitpack"])
@pytest.mark.parametrize("heap_factor,cut,k", [(0.9, 8, 10), (0.5, 3, 5), (1.0, 20, 25)])
def test_host_seismic_search_equals_the_reference(seismic_pair, codec, heap_factor, cut, k):
    ref, port, Q = seismic_pair
    ref.prepare_codec(codec)
    port.prepare_codec(codec)
    for q in list(Q) + [np.zeros(Q.shape[1], np.float32)]:
        want = ref.search(q, k=k, heap_factor=heap_factor, cut=cut, codec=codec)
        got = port.search(q, k=k, heap_factor=heap_factor, cut=cut, codec=codec)
        assert got[0].dtype == want[0].dtype and got[1].dtype == want[1].dtype
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert port.index_bytes(codec) == ref.index_bytes(codec)
