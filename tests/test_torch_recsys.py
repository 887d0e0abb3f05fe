"""The port's RecSys models (``repro_torch.models.recsys``) against the
reference's (``repro.models.recsys``) on the CPU, the reference's
parameters carried across by ``params_from_jax``.

* ``embedding_bag`` (sum, mean, a ``valid`` mask, a bag with no valid
  id) and ``bce_loss`` at |logits| up to 50.
* Every model's forward, loss (and its metric), ``*_score_candidates``
  and every gradient at the configs' smoke widths: outputs and losses
  within rtol 1e-5 (atol 1e-6), gradients within 1e-5 of each leaf's
  largest entry, or of 1e-2 of the tree's largest where that is larger
  (f32 sums in another order; ``LEAF_FLOOR``).
* Two AdamW steps of each config's train step (its own optimizer)
  against the reference's jitted step: parameters within the same rule.
* ``RecsysArch.smoke`` with the reference's parameters and batch against
  the reference's loss, and repeatable with its own.

SASRec's negatives are drawn unequal to the positive at their position
(as a negative sampler draws them): an equal pair's two logits are one
number summed in two orders, and the hit metric would turn on a
rounding. torch runs at one intra-op thread.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_cases import one_intra_op_thread  # noqa: F401 — autouse fixture
from torch_configs_cases import ROOT

from repro import configs as ref_configs
from repro.models import recsys as R
from repro.train.optimizer import make_optimizer as ref_make_optimizer
from repro.train.train_step import make_train_step as ref_make_train_step
from repro_torch import configs
from repro_torch.models import recsys as P
from repro_torch.models.common import params_from_jax
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.train_step import make_train_step, value_and_grad
from repro_torch.tree import tree_leaves_with_path

RTOL, ATOL = 1e-5, 1e-6
GRAD_REL = 1e-5
#: a leaf far below the tree's largest is held at this fraction of it:
#: DIN's attention tower sees the 0.02-scale embeddings, its gradients are
#: 1e-6–1e-11, and its last bias's is 0 up to rounding (a constant added
#: to every attention weight leaves the softmax unchanged)
LEAF_FLOOR = 1e-2
IDS = ("deepfm", "dcn-v2", "sasrec", "din")
B = 16
N_CAND = 300


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _batch(cfg, rng, B=B) -> dict:
    """A numpy batch of the smoke config ``cfg`` (ids inside every table)."""
    m = cfg.name
    if m in ("deepfm", "dcn-v2"):
        out = {"sparse": np.stack([rng.integers(0, v, size=B) for v in cfg.vocab_sizes],
                                  1).astype(np.int32)}
        if m == "dcn-v2":
            out = {"dense": rng.normal(size=(B, cfg.n_dense)).astype(np.float32), **out}
        out["label"] = rng.integers(0, 2, size=B).astype(np.float32)
        return out
    if m == "sasrec":
        S, K = cfg.seq_len, cfg.n_negatives
        seq = rng.integers(1, cfg.n_items, size=(B, S))
        seq[:, : S // 3] = 0  # left padding
        pos = np.concatenate([seq[:, 1:], rng.integers(1, cfg.n_items, size=(B, 1))], 1)
        pos[1, :] = 0  # a user with no label
        neg = (pos[..., None] + rng.integers(1, cfg.n_items - 1, size=(B, S, K))) % cfg.n_items
        neg = np.where(neg == 0, 1 + (pos[..., None] % (cfg.n_items - 1)), neg)
        assert not (neg == pos[..., None]).any()
        return {"seq": seq.astype(np.int32), "pos_label": pos.astype(np.int32),
                "neg_label": neg.astype(np.int32)}
    S = cfg.seq_len
    hist = rng.integers(1, cfg.n_items, size=(B, S))
    hist[:, S // 2:] = 0
    hist[2, :] = 0  # a user with no history: an all-masked softmax, an empty bag
    return {"hist": hist.astype(np.int32),
            "target": rng.integers(1, cfg.n_items, size=B).astype(np.int32),
            "label": rng.integers(0, 2, size=B).astype(np.float32)}


def _models(arch_id):
    ref, port = ref_configs.get_arch(arch_id), configs.get_arch(arch_id)
    return ref, port, ref.smoke_cfg, port.smoke_cfg


def _assert_tree_close(got, want, rel=GRAD_REL, what=""):
    """Every leaf of ``got`` within ``rel`` of the larger of its own largest
    entry and ``LEAF_FLOOR`` × the tree's largest."""
    g = dict(tree_leaves_with_path(got))
    leaves = jax.tree_util.tree_leaves_with_path(want)
    assert len(leaves) == len(g), (what, sorted(g))
    top = max(float(np.abs(np.asarray(leaf)).max()) for _, leaf in leaves)
    for path, leaf in leaves:
        k = jax.tree_util.keystr(path)
        w = np.asarray(leaf)
        scale = max(float(np.abs(w).max()), LEAF_FLOOR * top, 1e-30)
        err = float(np.abs(g[k].detach().numpy().astype(np.float64) - w).max())
        assert err <= rel * scale, (what, k, err, scale)


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("masked", [False, True])
def test_embedding_bag_equals_the_reference(mode, masked):
    rng = np.random.default_rng(0)
    table = rng.normal(size=(50, 6)).astype(np.float32)
    ids = rng.integers(0, 50, size=(3, 4, 7)).astype(np.int32)
    valid = rng.random((3, 4, 7)) < 0.6
    valid[1, 2] = False  # a bag with no valid id
    kw = {"valid": valid} if masked else {}
    want = np.asarray(R.embedding_bag(jnp.asarray(table), jnp.asarray(ids), mode=mode,
                                      **{k: jnp.asarray(v) for k, v in kw.items()}))
    got = P.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids), mode=mode,
                          **{k: torch.from_numpy(v) for k, v in kw.items()}).numpy()
    assert got.shape == want.shape == (3, 4, 6)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if masked:
        assert not got[1, 2].any()


def test_bce_loss_at_large_logits():
    logits = np.array([-50, -30, -1.5, 0, 0.3, 2, 30, 50], np.float32)
    labels = np.array([0, 1, 1, 0, 1, 0, 0, 1], np.float32)
    (lw, aw), (lg, ag) = R.bce_loss(jnp.asarray(logits), jnp.asarray(labels)), P.bce_loss(
        torch.from_numpy(logits), torch.from_numpy(labels))
    assert np.isfinite(float(lg))
    np.testing.assert_allclose(float(lg), float(lw), rtol=RTOL)
    assert float(ag["accuracy"]) == float(aw["accuracy"])


@pytest.mark.parametrize("arch_id", IDS)
def test_forward_loss_grads_and_candidates_equal_the_reference(arch_id):
    ref, port, cr, cp = _models(arch_id)
    init_r, loss_r, _ = ref._fns(cr)
    _, loss_p, _ = port._fns(cp)
    pr = init_r(jax.random.PRNGKey(1), cr)
    pp = params_from_jax(jax.device_get(pr), device="cpu")
    rng = np.random.default_rng(2)
    b = _batch(cr, rng)
    (lr, ar), gr = jax.jit(jax.value_and_grad(lambda p: loss_r(p, cr, _j(b)),
                                              has_aux=True))(pr)
    (lp, ap), gp = value_and_grad(lambda p, bb: loss_p(p, cp, bb), pp, _t(b))
    np.testing.assert_allclose(float(lp), float(lr), rtol=RTOL)
    assert set(ap) == set(ar)
    for k in ar:
        assert float(ap[k]) == pytest.approx(float(ar[k]), abs=1e-7), k
    _assert_tree_close(gp, gr, what=arch_id)

    # the serve forward and retrieval_cand's candidates (ids inside the tables)
    with torch.no_grad():
        if arch_id == "deepfm":
            want = R.deepfm_forward(pr, cr, jnp.asarray(b["sparse"]))
            got = P.deepfm_forward(pp, cp, torch.from_numpy(b["sparse"]))
            cand = rng.integers(0, cr.vocab_sizes[3], size=N_CAND).astype(np.int32)
            want_c = R.deepfm_score_candidates(pr, cr, jnp.asarray(b["sparse"][:1]),
                                               jnp.asarray(cand), 3)
            got_c = P.deepfm_score_candidates(pp, cp, torch.from_numpy(b["sparse"][:1]),
                                              torch.from_numpy(cand), 3)
        elif arch_id == "dcn-v2":
            want = R.dcnv2_forward(pr, cr, jnp.asarray(b["dense"]), jnp.asarray(b["sparse"]))
            got = P.dcnv2_forward(pp, cp, torch.from_numpy(b["dense"]),
                                  torch.from_numpy(b["sparse"]))
            cand = rng.integers(0, cr.vocab_sizes[3], size=N_CAND).astype(np.int32)
            want_c = R.dcnv2_score_candidates(pr, cr, jnp.asarray(b["dense"][:1]),
                                              jnp.asarray(b["sparse"][:1]), jnp.asarray(cand), 3)
            got_c = P.dcnv2_score_candidates(pp, cp, torch.from_numpy(b["dense"][:1]),
                                             torch.from_numpy(b["sparse"][:1]),
                                             torch.from_numpy(cand), 3)
        elif arch_id == "sasrec":
            want = R.sasrec_encode(pr, cr, jnp.asarray(b["seq"]))
            got = P.sasrec_encode(pp, cp, torch.from_numpy(b["seq"]))
            cand = rng.integers(0, cr.n_items, size=N_CAND).astype(np.int32)
            want_c = R.sasrec_score_candidates(pr, cr, jnp.asarray(b["seq"][:1]),
                                               jnp.asarray(cand))
            got_c = P.sasrec_score_candidates(pp, cp, torch.from_numpy(b["seq"][:1]),
                                              torch.from_numpy(cand))
        else:
            want = R.din_forward(pr, cr, jnp.asarray(b["hist"]), jnp.asarray(b["target"]))
            got = P.din_forward(pp, cp, torch.from_numpy(b["hist"]),
                                torch.from_numpy(b["target"]))
            cand = rng.integers(0, cr.n_items, size=N_CAND).astype(np.int32)
            want_c = R.din_score_candidates(pr, cr, jnp.asarray(b["hist"][0]), jnp.asarray(cand))
            got_c = P.din_score_candidates(pp, cp, torch.from_numpy(b["hist"][0]),
                                           torch.from_numpy(cand))
    assert tuple(got.shape) == tuple(want.shape) and tuple(got_c.shape) == tuple(want_c.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=RTOL, atol=ATOL)


def test_ctr_field_local_ids_past_their_field_read_the_next_field():
    """An id past its field's vocabulary reads the next field's rows of the
    combined table, as the reference's offset add does."""
    ref, port, cr, cp = _models("deepfm")
    pr = ref._fns(cr)[0](jax.random.PRNGKey(0), cr)
    pp = params_from_jax(jax.device_get(pr), device="cpu")
    ids = np.zeros((2, cr.n_fields), np.int32)
    ids[0, 0] = cr.vocab_sizes[0] + 5  # field 1's row 5
    ids[1, 1] = 5
    with torch.no_grad():
        got = P.deepfm_forward(pp, cp, torch.from_numpy(ids)).numpy()
    want = np.asarray(R.deepfm_forward(pr, cr, jnp.asarray(ids)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch_id", IDS)
def test_two_train_steps_equal_the_reference(arch_id):
    ref, port, cr, cp = _models(arch_id)
    init_r, loss_r, _ = ref._fns(cr)
    _, loss_p, _ = port._fns(cp)
    pr = init_r(jax.random.PRNGKey(3), cr)
    rng = np.random.default_rng(4)
    batches = [_batch(cr, rng) for _ in range(2)]
    oinit_r, oupd_r = ref_make_optimizer(ref.optimizer)
    step_r = jax.jit(ref_make_train_step(lambda p, b: loss_r(p, cr, b), oupd_r))
    oinit, oupd = make_optimizer(port.optimizer)
    step_p = make_train_step(lambda p, b: loss_p(p, cp, b), oupd)
    sr = {"params": pr, "opt": oinit_r(pr)}
    pp = params_from_jax(jax.device_get(pr), device="cpu")
    sp = {"params": pp, "opt": oinit(pp)}
    for b in batches:
        sr, mr = step_r(sr, _j(b))
        sp, mp = step_p(sp, _t(b))
        np.testing.assert_allclose(float(mp["loss"]), float(mr["loss"]), rtol=RTOL)
        np.testing.assert_allclose(float(mp["grad_norm"]), float(mr["grad_norm"]), rtol=1e-4)
    _assert_tree_close(sp["params"], sr["params"], what=f"{arch_id} params")
    assert int(sp["opt"]["step"]) == int(sr["opt"]["step"]) == 2


@pytest.mark.parametrize("arch_id", IDS)
def test_recsys_smoke_equals_the_reference(arch_id):
    ref, port, cr, cp = _models(arch_id)
    seed = 0
    key = jax.random.PRNGKey(seed)
    pr = ref._fns(cr)[0](key, cr)
    batch = ref._smoke_batch(cr, 8, key)
    want = ref.smoke(seed)["loss"]
    got = port.smoke(seed, device="cpu",
                     params=params_from_jax(jax.device_get(pr), device="cpu"),
                     batch=_t(jax.device_get(batch)))
    assert got["device"] == "cpu"
    np.testing.assert_allclose(got["loss"], want, rtol=RTOL)
    own = port.smoke(seed, device="cpu")
    assert np.isfinite(own["loss"]) and own == port.smoke(seed, device="cpu")


def test_smoke_batch_is_drawn_from_numpy_at_its_seed():
    port = configs.get_arch("sasrec")
    a = port._smoke_batch(port.smoke_cfg, 4, [0, 7], "cpu")
    b = port._smoke_batch(port.smoke_cfg, 4, [0, 7], "cpu")
    c = port._smoke_batch(port.smoke_cfg, 4, [0, 8], "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a) and not torch.equal(a["seq"], c["seq"])
    assert list(a) == ["seq", "pos_label", "neg_label"]
    assert all(int(v.max()) < 32 and v.dtype == torch.int32 for v in a.values())


def test_no_jax_on_import():
    code = ("import sys\nimport repro_torch.models.recsys\n"
            "import repro_torch.configs.deepfm, repro_torch.configs.dcn_v2\n"
            "import repro_torch.configs.sasrec, repro_torch.configs.din\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
