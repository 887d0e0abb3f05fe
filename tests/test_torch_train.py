"""The port's training stack (``repro_torch/train``) against the
reference, on the CPU: AdamW and Adafactor over ten steps, the train
step at one and two microbatches, checkpoints crossing between the
packages both ways, the fault-tolerant runner, and the example's CLI.

Parameters are the reference encoder's own (small: vocab 512, 2 layers,
d 32), carried across by ``params_from_jax``; gradients and batches
come from numpy seeds. Optimizer params, state, ``lr`` and ``grad_norm``
are held to rtol 1e-5 (atol 1e-7): the same f32 updates, with
``global_norm``'s sums in another order. A train step's params are held
to rtol 1e-5, atol 1e-5 (an update is lr = 1e-2 times O(1)). The
encoder's step runs AdamW at ``eps`` 1e-3: Adam's first step, and every
unfactored Adafactor step, map a gradient to about its sign, so a
gradient within f32 noise of zero (the encoder's gradients differ by up
to 3e-6 of a leaf's largest entry, ``test_torch_encoder.py``; two of
16,384 ``embed`` entries change sign) moves a parameter by ±lr in one
package and not the other; the larger ``eps`` keeps the update a smooth
function of the gradient. Adafactor's step is held on the reference's
own train-step loss, a linear fit whose gradients are far from zero.
Checkpoint payloads must be equal byte for byte, and the runner's replay
after a fault bit for bit."""

import os
import re
import tempfile

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.models import sparse_encoder as ref_enc
from repro.train import checkpoint as ref_ckpt
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_ts
from repro_torch.launch import train_sparse_encoder as cli
from repro_torch.models import sparse_encoder as enc
from repro_torch.train import checkpoint, optimizer, train_step
from repro_torch.train.elastic import FaultInjector, Runner, RunnerConfig
from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_map

SMALL = dict(vocab=512, n_layers=2, d_model=32, n_heads=4, d_ff=64, max_len=16)
RTOL, ATOL = 1e-5, 1e-7


def _ref_params(seed=0, **kw):
    cfg = ref_enc.SparseEncoderConfig(**SMALL, **kw)
    return cfg, jax.device_get(ref_enc.encoder_init(jax.random.PRNGKey(seed), cfg))


def _port(tree):
    return enc.params_from_jax(tree, device="cpu")


def _ref_leaves(tree):
    return [(jax.tree_util.keystr(k), np.asarray(a))
            for k, a in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _assert_trees_close(got, want, rtol=RTOL, atol=ATOL):
    g, w = tree_leaves_with_path(got), _ref_leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (p, a), (_, b) in zip(g, w):
        assert tuple(a.shape) == b.shape, p
        assert str(a.numpy().dtype) == str(b.dtype), p
        np.testing.assert_allclose(a.numpy(), b, rtol=rtol, atol=atol, err_msg=p)


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


# -- optimizers ------------------------------------------------------------------

OPTIMIZERS = {
    "adamw": dict(name="adamw"),
    "adafactor-factored": dict(name="adafactor", factored_min_dim=16),
    "adafactor": dict(name="adafactor"),
}


@pytest.mark.parametrize("grad_scale", [1e-3, 1.0], ids=["unclipped", "clipped"])
@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_optimizer_ten_steps(opt, grad_scale):
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=8, **OPTIMIZERS[opt])  # past the schedule's end
    ref_cfg, cfg = ref_opt.OptimizerConfig(**kw), optimizer.OptimizerConfig(**kw)
    _, ref_p = _ref_params()
    ref_init, ref_upd = ref_opt.make_optimizer(ref_cfg)
    ref_upd = jax.jit(ref_upd)
    init, upd = optimizer.make_optimizer(cfg)
    ref_s, p = ref_init(ref_p), _port(ref_p)
    s = init(p)
    _assert_trees_close(s, ref_s)
    rng = np.random.default_rng(7)
    for _ in range(10):
        g = tree_map(lambda a: (rng.normal(size=a.shape) * grad_scale).astype(np.float32),
                     jax.tree.map(np.asarray, ref_p))
        ref_p, ref_s, ref_m = ref_upd(jax.tree.map(jnp.asarray, g), ref_s, ref_p)
        p, s, m = upd(_port(g), s, p)
        _assert_trees_close(p, ref_p)
        _assert_trees_close(s, ref_s)
        assert sorted(m) == sorted(ref_m) == ["grad_norm", "lr"]
        for k in m:
            np.testing.assert_allclose(float(m[k]), float(ref_m[k]), rtol=RTOL)
    assert s["step"].dtype == torch.int32 and int(s["step"]) == 10
    if opt == "adafactor-factored":
        assert set(s["second"]["layers"]["wq"]) == {"vr", "vc"}
        assert set(s["second"]["layers"]["attn_norm"]) == {"v"}


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_stacked_norms_are_decayed_and_vectors_are_not(opt):
    """Decay follows ``ndim >= 2`` on the stacked tree: ``layers.*_norm``
    ([L, D]) shrink under zero gradients, ``final_norm`` does not."""
    cfg = optimizer.OptimizerConfig(name=opt, lr=0.1, warmup_steps=1, weight_decay=0.5)
    _, ref_p = _ref_params()
    p = _port(ref_p)
    init, upd = optimizer.make_optimizer(cfg)
    p2, _, _ = upd(tree_map(torch.zeros_like, p), init(p), p)
    assert bool((p2["layers"]["attn_norm"] < 1).all())
    assert bool((p2["layers"]["ffn_norm"] < 1).all())
    assert torch.equal(p2["final_norm"], p["final_norm"])
    assert torch.equal(p2["mlm_bias"], p["mlm_bias"])


def test_make_optimizer_rejects_unknown_names():
    with pytest.raises(KeyError):
        optimizer.make_optimizer(optimizer.OptimizerConfig(name="sgd"))


# -- the train step ---------------------------------------------------------------


def _batch(seed, B=4, S=16, vocab=512):
    rng = np.random.default_rng(seed)
    out = {}
    for side in ("q", "d"):
        out[f"{side}_tokens"] = rng.integers(0, vocab, (B, S)).astype(np.int32)
        out[f"{side}_mask"] = np.arange(S)[None, :] < rng.integers(1, S + 1, B)[:, None]
    return out


def _quadratic():
    """The reference's own train-step loss (``tests/test_train.py``): a
    linear fit, whose gradients are far from zero."""
    true_w = np.arange(8, dtype=np.float32).reshape(8, 1)
    ref = lambda p, b: (jnp.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2), {})  # noqa: E731
    port = lambda p, b: (torch.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2), {})  # noqa: E731

    def batch(i):
        x = np.random.default_rng(i).normal(size=(32, 8)).astype(np.float32)
        return {"x": x, "y": x @ true_w}

    params = {"w": np.zeros((8, 1), np.float32), "b": np.zeros((1,), np.float32)}
    return ref, port, batch, params


def _encoder_loss():
    ref_cfg, ref_p = _ref_params(seed=2, flops_lambda=1e-2)
    cfg = enc.SparseEncoderConfig(**SMALL, flops_lambda=1e-2)
    return (lambda p, b: ref_enc.contrastive_loss(p, ref_cfg, b),
            lambda p, b: enc.contrastive_loss(p, cfg, b), lambda i: _batch(10 + i), ref_p)


#: (loss, optimizer settings): the encoder under AdamW at eps 1e-3 (see
#: the module's docstring), the reference's quadratic under both optimizers
STEP_CASES = {
    "encoder-adamw": (_encoder_loss, dict(name="adamw", eps=1e-3)),
    "quadratic-adamw": (_quadratic, dict(name="adamw")),
    "quadratic-adafactor": (_quadratic, dict(name="adafactor")),
}


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_the_reference(case, microbatches):
    make, opt = STEP_CASES[case]
    ref_loss, loss, batch, ref_p = make()
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, **opt)
    ref_init, ref_upd = ref_opt.make_optimizer(ref_opt.OptimizerConfig(**kw))
    init, upd = optimizer.make_optimizer(optimizer.OptimizerConfig(**kw))
    ref_step = jax.jit(ref_ts.make_train_step(ref_loss, ref_upd, microbatches=microbatches))
    step = train_step.make_train_step(loss, upd, microbatches=microbatches)
    ref_state = ref_ts.init_train_state(jax.tree.map(jnp.asarray, ref_p), ref_init)
    state = train_step.init_train_state(_port(ref_p), init)
    for i in range(3):
        b = batch(i)
        ref_state, ref_m = ref_step(ref_state, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        assert sorted(m) == sorted(ref_m)
        for k in m:
            assert m[k].dim() == 0
            np.testing.assert_allclose(float(m[k]), float(ref_m[k]), rtol=RTOL, err_msg=k)
        _assert_trees_close(state, jax.device_get(ref_state), RTOL, 1e-5)
    aux = {"contrastive_acc", "nnz_query", "nnz_doc"} if case.startswith("encoder") else set()
    assert set(m) == {"loss", "lr", "grad_norm"} | (aux if microbatches == 1 else set())


def test_microbatches_average_the_gradient():
    """Two microbatches of one batch give one step's update (the mean of
    the two halves' gradients), as the reference's test holds."""
    cfg = enc.SparseEncoderConfig(**SMALL)
    _, ref_p = _ref_params()
    init, upd = optimizer.make_optimizer(optimizer.OptimizerConfig(lr=1e-2, warmup_steps=1))
    loss = lambda p, b: (sum(  # noqa: E731 — a loss linear in the batch's rows
        enc.encode(p, cfg, b["d_tokens"][i:i + 1], b["d_mask"][i:i + 1]).sum()
        for i in range(b["d_tokens"].shape[0])) / b["d_tokens"].shape[0], {})
    b = {k: torch.from_numpy(v) for k, v in _batch(3).items()}
    one = train_step.make_train_step(loss, upd)
    two = train_step.make_train_step(loss, upd, microbatches=2)
    s0 = train_step.init_train_state(_port(ref_p), init)
    (s1, m1), (s2, m2) = one(s0, b), two(s0, b)
    torch.testing.assert_close(m1["loss"], m2["loss"], rtol=1e-6, atol=0)
    torch.testing.assert_close(m1["grad_norm"], m2["grad_norm"], rtol=1e-5, atol=0)
    with pytest.raises(ValueError, match="not divisible by 3 microbatches"):
        train_step.make_train_step(loss, upd, microbatches=3)(s0, b)


# -- checkpoints --------------------------------------------------------------------


def _states(opt):
    """The same train state in both packages: the reference's params and
    the optimizer state after two steps."""
    kw = dict(name=opt, lr=1e-2, warmup_steps=1, factored_min_dim=16)
    _, ref_p = _ref_params(quantize=True)
    ref_init, ref_upd = ref_opt.make_optimizer(ref_opt.OptimizerConfig(**kw))
    ref_upd = jax.jit(ref_upd)
    ref_state = ref_ts.init_train_state(ref_p, ref_init)
    rng = np.random.default_rng(1)
    for _ in range(2):
        g = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32)),
                         ref_state["params"])
        p, o, _ = ref_upd(g, ref_state["opt"], ref_state["params"])
        ref_state = {"params": p, "opt": o}
    ref_state = jax.device_get(ref_state)
    return ref_state, enc.params_from_jax(ref_state, device="cpu")


def _read(d, step):
    path = os.path.join(d, f"step_{step:08d}")
    with open(os.path.join(path, "meta.msgpack"), "rb") as f:
        meta = msgpack.unpackb(f.read())
    with open(os.path.join(path, "shard_p0.msgpack.zst"), "rb") as f:
        return meta, f.read()


@pytest.mark.parametrize("zstd", [True, False], ids=["zstd", "zlib"])
@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_checkpoints_cross_both_ways(opt, zstd, monkeypatch):
    if not zstd:  # a host without zstandard writes the zlib tag, in both packages
        monkeypatch.setattr(ref_ckpt, "zstandard", None)
        monkeypatch.setattr(checkpoint, "zstandard", None)
    ref_state, state = _states(opt)
    with tempfile.TemporaryDirectory() as d:
        ref_ckpt.save(os.path.join(d, "ref"), 7, ref_state, metadata={"note": "a"})
        checkpoint.save(os.path.join(d, "port"), 7, state, metadata={"note": "a"})
        (ref_meta, ref_raw), (meta, raw) = _read(os.path.join(d, "ref"), 7), \
            _read(os.path.join(d, "port"), 7)
        assert meta["leaves"] == ref_meta["leaves"]
        assert raw == ref_raw  # every payload byte for byte, in the same order
        payload = msgpack.unpackb(raw)
        assert all(v[:1] == (b"Z" if zstd else b"z") for v in payload.values())
        assert "['opt']['step']" in payload and "['params']['layers']['wq']" in payload
        assert {m["dtype"] for m in meta["leaves"]} == {"float32", "int32"}

        # the reference's checkpoint restored by the port, and the port's by the reference
        got, got_meta = checkpoint.restore(os.path.join(d, "ref"), state)
        want, want_meta = ref_ckpt.restore(os.path.join(d, "port"), ref_state)
        assert got_meta == want_meta == {"note": "a", "step": 7}
        for (p, a), (_, b) in zip(tree_leaves_with_path(got), _ref_leaves(ref_state)):
            assert str(a.numpy().dtype) == str(b.dtype) and tuple(a.shape) == b.shape, p
            np.testing.assert_array_equal(a.numpy(), b)
        for (p, a), (_, b) in zip(_ref_leaves(want), _ref_leaves(ref_state)):
            assert a.dtype == b.dtype and a.shape == b.shape, p
            np.testing.assert_array_equal(a, b)
        assert got["opt"]["step"].dtype == torch.int32 and got["opt"]["step"].dim() == 0


def test_checkpoint_atomicity_latest_and_restore_by_step():
    _, state = _states("adamw")
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, 5, state, metadata={"note": "a"})
        bumped = tree_map(lambda t: t + 1, state)
        checkpoint.save(d, 9, bumped)
        assert checkpoint.latest_step(d) == 9
        restored, meta = checkpoint.restore(d, state)
        assert meta == {"step": 9}
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(restored), tree_leaves(bumped)))
        old, meta = checkpoint.restore(d, state, step=5)
        assert meta == {"note": "a", "step": 5}
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(old), tree_leaves(state)))
        # a stale .tmp directory (a crash before the rename) is never picked up
        os.makedirs(os.path.join(d, "step_00000011.tmp"), exist_ok=True)
        assert checkpoint.latest_step(d) == 9
        assert checkpoint.available_steps(d) == [5, 9]
        # a leaf the checkpoint lacks
        with pytest.raises(KeyError, match=re.escape("['extra']")):
            checkpoint.restore(d, dict(state, extra=torch.zeros(1)))
    with tempfile.TemporaryDirectory() as d:
        assert checkpoint.latest_step(d) is None and checkpoint.available_steps(d) == []
        with pytest.raises(FileNotFoundError):
            checkpoint.restore(d, state)


def test_checkpoint_prunes_old():
    state = {"params": {"w": torch.zeros(3)}, "opt": {"step": torch.zeros((), dtype=torch.int32)}}
    with tempfile.TemporaryDirectory() as d:
        for s in range(6):
            checkpoint.save(d, s, state, keep_last=2)
        assert checkpoint.available_steps(d) == [4, 5]
        checkpoint.save(d, 6, state, keep_last=None)
        assert checkpoint.available_steps(d) == [4, 5, 6]


def test_checkpoint_leaf_dtypes_round_trip():
    state = {"a": torch.arange(6, dtype=torch.int64).reshape(2, 3),
             "b": torch.tensor([1.5, -2.0], dtype=torch.bfloat16),
             "c": torch.tensor([True, False]), "d": torch.zeros((0, 4)),
             "e": torch.tensor(3, dtype=torch.int32)}
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, 0, state)
        got, _ = checkpoint.restore(d, state)
        for k in state:
            assert got[k].dtype == state[k].dtype and torch.equal(got[k], state[k]), k
        meta, _ = _read(d, 0)
        assert [m["dtype"] for m in meta["leaves"]] == ["int64", "bfloat16", "bool", "float32",
                                                         "int32"]


# -- the runner -----------------------------------------------------------------------

RUN_CFG = enc.SparseEncoderConfig(**SMALL, flops_lambda=1e-3)


def _runner(d, total, every=10, **kw):
    init, upd = optimizer.make_optimizer(optimizer.OptimizerConfig(lr=1e-3, warmup_steps=5,
                                                                   total_steps=total))
    params = enc.encoder_init(torch.Generator().manual_seed(0), RUN_CFG, device="cpu")
    step = train_step.make_train_step(lambda p, b: enc.contrastive_loss(p, RUN_CFG, b), upd)
    return Runner(RunnerConfig(total_steps=total, checkpoint_dir=d, checkpoint_every=every,
                               **kw.pop("cfg", {})),
                  step, lambda i: cli.synth_pairs(0, i, RUN_CFG, batch=8, seq=12),
                  train_step.init_train_state(params, init), **kw)


def test_runner_recovers_from_faults_bit_for_bit():
    with tempfile.TemporaryDirectory() as d1, tempfile.TemporaryDirectory() as d2:
        faulted = _runner(d1, 30, fault_injector=FaultInjector(fail_at=(7, 23, 23)))
        state, hist = faulted.run()
        assert faulted.restarts == 2
        assert max(h["step"] for h in hist) == 29
        assert checkpoint.available_steps(d1) == [9, 19, 29]
        clean = _runner(d2, 30)
        state2, hist2 = clean.run()
        assert clean.restarts == 0 and [h["step"] for h in hist2] == list(range(30))
        for (p, a), (_, b) in zip(tree_leaves_with_path(state), tree_leaves_with_path(state2)):
            assert torch.equal(a, b), p
        # the replayed steps' metrics equal the first tries'
        assert hist[-1] == hist2[-1]
        assert hist2[-1]["loss"] < hist2[0]["loss"]


def test_runner_resumes_and_rescales():
    with tempfile.TemporaryDirectory() as d:
        first = _runner(d, 10, every=5)
        first.run()
        resumed = _runner(d, 20, every=5)
        resumed.rescale("cpu")
        state, hist = resumed.run()
        assert [h["step"] for h in hist] == list(range(10, 20))
        assert resumed.device == "cpu" and state["opt"]["step"].item() == 20


def test_runner_max_restarts_and_deadline():
    class AlwaysFail(FaultInjector):
        def maybe_fail(self, step):
            if step == 3:
                raise RuntimeError("permafault")

    with tempfile.TemporaryDirectory() as d:
        runner = _runner(d, 10, every=5, fault_injector=AlwaysFail(), cfg=dict(max_restarts=2))
        with pytest.raises(RuntimeError, match="permafault"):
            runner.run()
        assert runner.restarts == 3
    with tempfile.TemporaryDirectory() as d:
        runner = _runner(d, 4, every=2, cfg=dict(max_restarts=1, step_timeout_s=0.0))
        with pytest.raises(TimeoutError, match="exceeded deadline"):
            runner.run()
        assert runner.restarts == 2


# -- the CLI ----------------------------------------------------------------------------


def test_synth_pairs_is_deterministic_and_topical():
    cfg = cli.small_config()
    a, b = cli.synth_pairs(0, 5, cfg), cli.synth_pairs(0, 5, cfg)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["q_tokens"], cli.synth_pairs(0, 6, cfg)["q_tokens"])
    width = cfg.vocab // 64  # a pair's tokens share one topic's slice
    assert torch.equal(a["q_tokens"] // width, a["d_tokens"] // width)
    assert (a["q_tokens"] // width == a["q_tokens"][:, :1] // width).all()
    assert a["q_tokens"].shape == (16, 24) and bool(a["q_mask"].all())


def test_cli_trains_and_prints_the_examples_lines(capsys):
    with tempfile.TemporaryDirectory() as d:
        cli.main(["--device", "cpu", "--steps", "20", "--n-docs", "160", "--checkpoint-dir", d])
        assert checkpoint.available_steps(d) == [19]
    out = capsys.readouterr().out
    loss = re.search(r"loss ([\d.]+) → ([\d.]+) over 20 steps", out)
    assert loss and float(loss.group(2)) < float(loss.group(1)), out
    assert re.search(r"corpus: 160 docs, learned sparsity \d+ nnz/doc", out), out
    assert re.search(r"KiB DotVByte \([\d.]+ bits/comp\)", out), out
    assert re.search(r"Seismic recall@10 with DotVByte rescoring: [\d.]+", out), out
    flat = re.search(r"Retriever flat \(dotvbyte, backend=torch\) recall@10: ([\d.]+)", out)
    assert flat and float(flat.group(1)) == 1.0, out  # the exact engine
    assert re.search(r"Retriever seismic \(dotvbyte, backend=torch\) recall@10: [\d.]+", out)


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA GPU is available"):
        cli.main(["--steps", "1"])
