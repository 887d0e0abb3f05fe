"""The compressed data-parallel step of the port (``torch.distributed``)
against the reference's.

* ``compressed_psum_mean`` at one rank equals the reference's under a
  one-device ``shard_map`` bit for bit (a one-rank gloo group in this
  process); at four gloo ranks the mean equals the numpy mean of the
  ranks' dequantised gradients and is the same bits on every rank, and
  each rank's residual is its own ``x − deq``.
* The reference test's quadratic problem (``tests/test_dist.py``) on
  four gloo ranks meets its bounds, the replicas bit-identical.
"""

import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P
from torch_mesh_cases import dp_ranks, load

from repro.dist.compression import compressed_psum_mean as ref_mean
from repro_torch.dist.compression import compressed_psum_mean, quantize_int8
from repro_torch.launch.mesh import make_debug_mesh, spawn_ranks
from repro_torch.dist.sharding import axis_block
from repro_torch.train.train_step import (init_dp_residual, init_train_state,
                                          make_dp_compressed_train_step)

SHAPES = {"a": (5, 3), "b": (7,), "c": (2, 3, 4), "zero": (4,)}


def _tree(rng, scale=1.0):
    out = {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in SHAPES.items()}
    out["zero"][:] = 0.0  # an all-zero leaf takes the 1e-12 scale
    return out


@pytest.fixture
def one_rank_group(tmp_path):
    """A one-rank gloo group in this process, torn down after the test."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'init'}", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_one_rank_matches_reference_bitwise(one_rank_group, seed):
    rng = np.random.default_rng(seed)
    grads = _tree(rng, 10.0 ** rng.uniform(-4, 2))
    grads["a"][0, 0] = 0.5 * np.abs(grads["a"]).max()  # values near a rounding tie
    residual = _tree(rng, 1e-3)
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    # the program as written, op by op: under jit, XLA's CPU backend turns
    # ``max|x| / 127`` into ``max|x| · f32(1/127)`` and fuses ``x − q·scale``
    # into one FMA, rewrites of its own that the port does not copy
    fn = jax.shard_map(lambda g, r: ref_mean(g, r, ("data",)), mesh=mesh,
                       in_specs=(P(), P()), out_specs=(P(), P()), check_vma=False)
    want_m, want_r = fn({k: jnp.asarray(v) for k, v in grads.items()},
                        {k: jnp.asarray(v) for k, v in residual.items()})
    got_m, got_r = compressed_psum_mean({k: torch.from_numpy(v) for k, v in grads.items()},
                                        {k: torch.from_numpy(v) for k, v in residual.items()})
    for k in SHAPES:
        assert np.array_equal(got_m[k].numpy(), np.asarray(want_m[k])), k
        assert np.array_equal(got_r[k].numpy(), np.asarray(want_r[k])), k


def test_quantize_int8_rounds_half_to_even():
    x = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -127.0])
    q, scale = quantize_int8(x)
    assert float(scale) == 1.0
    assert q.tolist() == [127, 0, 2, 2, 0, -2, -127]
    q0, s0 = quantize_int8(torch.zeros(3))
    assert float(s0) == np.float32(1e-12) and q0.tolist() == [0, 0, 0]


def test_dp_state_and_one_rank_step(one_rank_group):
    """``init_train_state(mesh=, dp_axes=)`` adds a zero f32 residual per
    leaf; at one rank the step's loss is the plain loss of the batch."""
    from repro_torch.train.optimizer import OptimizerConfig, make_optimizer

    mesh = make_debug_mesh((1,), ("data",))
    params = {"w": torch.ones((3, 1)), "b": torch.zeros((1,), dtype=torch.float16)}
    oinit, oupd = make_optimizer(OptimizerConfig(lr=0.1, warmup_steps=1, total_steps=10))
    state = init_train_state(params, oinit, mesh=mesh, dp_axes=("data",))
    assert set(state) == {"params", "opt", "residual"}
    assert all(r.dtype == torch.float32 and not r.any() for r in state["residual"].values())
    assert state["residual"]["w"].shape == (3, 1)
    assert set(init_train_state(params, oinit)) == {"params", "opt"}
    assert init_dp_residual(params)["b"].dtype == torch.float32

    def loss_fn(p, batch):
        return torch.mean((batch["x"] @ p["w"] + p["b"].float() - batch["y"]) ** 2), {}

    x = torch.arange(12.0).reshape(4, 3)
    batch = {"x": x, "y": torch.ones((4, 1))}
    step = make_dp_compressed_train_step(loss_fn, oupd, mesh, {"x": "data", "y": None})
    new, m = step({**state, "params": {"w": params["w"], "b": params["b"].float()}}, batch)
    assert float(m["loss"]) == float(loss_fn({"w": params["w"], "b": params["b"].float()},
                                             batch)[0])
    assert set(new) == {"params", "opt", "residual"}
    with pytest.raises(ValueError, match="does not split"):
        axis_block(x[:3], _TwoRankAxis(), "data")


class _TwoRankAxis:
    """A two-rank data axis, for the batch split's check alone."""
    mesh_dim_names = ("data",)

    def size(self, d):
        return 2


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp")
    spawn_ranks(dp_ranks, 4, str(out), SHAPES, backend="gloo", init_file=out / "init",
                timeout_s=180)
    return load(str(out), 4)


@pytest.mark.parametrize("leaf", sorted(SHAPES))
def test_four_rank_mean_is_the_mean_of_the_ranks_deq(four_ranks, leaf):
    mean = four_ranks[0][f"mean/{leaf}"]
    for r in four_ranks:  # the same bits on every rank
        assert np.array_equal(r[f"mean/{leaf}"], mean)
        np.testing.assert_array_equal(r[f"residual/{leaf}"], r[f"x/{leaf}"] - r[f"deq/{leaf}"])
    want = np.mean(np.stack([r[f"deq/{leaf}"].astype(np.float64) for r in four_ranks]), axis=0)
    np.testing.assert_allclose(mean, want, rtol=1e-6, atol=0)


def test_quadratic_dp_run_meets_the_reference_bounds(four_ranks):
    first = four_ranks[0]
    assert float(first["quad/loss"]) < 0.01, float(first["quad/loss"])
    true_w = np.arange(8, dtype=np.float32).reshape(8, 1)
    assert np.abs(first["quad/w"] - true_w).max() < 0.2
    for r in four_ranks[1:]:  # replicas bit-identical, the same losses
        for k in ("quad/w", "quad/b", "quad/losses"):
            assert np.array_equal(r[k], first[k]), k
