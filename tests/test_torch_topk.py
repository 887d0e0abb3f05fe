"""The top-k select kernel's wrapper on the CPU (``repro_torch/kernels/topk.py``):
its plain version against ``api.top_k`` after the mask and against the
reference's ``jax.lax.top_k`` on inputs full of ties, the order the kernel
keeps (``torch_cases.reference_top_k``) against ``jax.lax.top_k`` on raw
NaNs, the key order the CUDA source implements, the wrapper's checks and
launch counts, and the flat engine's two top-k paths under
``backend="cuda"``. The kernel itself, and its chunk rule, run on the card
(``tests/test_torch_gpu.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.core.forward_index import ForwardIndex
from repro_torch.kernels import topk
from repro_torch.serve import api
from torch_cases import one_intra_op_thread  # noqa: F401  (autouse)
from torch_cases import reference_top_k

#: rows of each family: ties of every kind the order has to settle
FAMILIES = {
    "random": lambda rng, n: rng.standard_normal(n),
    "few_values": lambda rng, n: rng.integers(0, 3, n),
    "all_equal": lambda rng, n: np.full(n, 0.5),
    "ascending": lambda rng, n: np.arange(n),
    "descending": lambda rng, n: -np.arange(n),
    "infinities": lambda rng, n: rng.choice([np.inf, -np.inf, 1.0, -1.0], n),
    "signed_zeros": lambda rng, n: rng.choice([0.0, -0.0, 1.0, -1.0], n),
    "nan": lambda rng, n: rng.choice([np.nan, -np.nan, np.inf, 0.0, -np.inf], n),
}


def family(name, nq, n_cols, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([FAMILIES[name](rng, n_cols) for _ in range(nq)]).astype(np.float32)


def masked(x, n_valid):
    out = x.copy()
    out[:, n_valid:] = -np.inf
    return out


def bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


#: (n_cols, k, n_valid): k of 1, 10, 64 and 256; n_valid 0, below k, half, all
CASES = [(n, k, v) for n, ks in ((7, (1, 5)), (300, (1, 10, 64, 256)))
         for k in ks for v in sorted({0, k - 1, n // 2, n})]


@pytest.mark.parametrize("name", list(FAMILIES))
@pytest.mark.parametrize("n_cols,k,n_valid", CASES)
def test_plain_version_is_the_masked_stable_sort(name, n_cols, k, n_valid):
    x = family(name, 3, n_cols)
    values, idx = topk.select_topk(torch.from_numpy(x), k, n_valid)
    want_v, want_i = api.top_k(torch.from_numpy(masked(x, n_valid)), k)
    assert values.dtype == torch.float32 and idx.dtype == torch.int32
    assert values.shape == idx.shape == (3, k)
    np.testing.assert_array_equal(idx.numpy(), want_i.numpy())
    np.testing.assert_array_equal(bits(values), bits(want_v))


def _zeros_tied(x):
    """The input with every ``-0.0`` made ``+0.0``: ``jax.lax.top_k``'s total
    order puts ``+0.0`` above ``-0.0``, where the sort counts them equal."""
    return np.where(x == 0, np.float32(0), x)


def _jax_order(x):
    """The input as ``jax.lax.top_k`` orders it like the CPU's stable sort:
    zeros tied, and every NaN positive, since its total order puts a
    negative NaN last and the CPU's sort puts every NaN first."""
    x = _zeros_tied(x)
    return np.where(np.isnan(x), np.float32(np.nan), x)


@pytest.mark.parametrize("name", list(FAMILIES))
@pytest.mark.parametrize("n_cols,k,n_valid", [(7, 5, 4), (300, 10, 300), (300, 64, 9),
                                              (300, 256, 150)])
def test_plain_version_equals_the_reference_top_k(name, n_cols, k, n_valid):
    x = family(name, 3, n_cols, seed=1)
    values, idx = topk.select_topk(torch.from_numpy(x), k, n_valid)
    m = masked(x, n_valid)
    _, want_i = jax.lax.top_k(jnp.asarray(_jax_order(m)), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    # the values are the masked input's own bits at those columns
    np.testing.assert_array_equal(bits(values), bits(np.take_along_axis(m, idx.numpy(), 1)))


@pytest.mark.parametrize("name", list(FAMILIES))
@pytest.mark.parametrize("n_cols,k,n_valid", [(7, 5, 4), (300, 10, 300), (300, 64, 9),
                                              (300, 256, 150)])
def test_kernel_order_equals_the_reference_top_k_on_raw_nans(name, n_cols, k, n_valid):
    """The order the kernel keeps (``reference_top_k``, which the card's
    tests hold it to) is ``jax.lax.top_k``'s on the raw input, NaNs of
    either sign included, once the zeros are tied."""
    x = family(name, 3, n_cols, seed=4)
    values, idx = reference_top_k(torch.from_numpy(x), k, n_valid)
    m = masked(x, n_valid)
    _, want_i = jax.lax.top_k(jnp.asarray(_zeros_tied(m)), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(bits(values), bits(np.take_along_axis(m, idx.numpy(), 1)))
    if name == "nan":  # the family does hold NaNs of both signs
        signs = set(bits(x)[np.isnan(x)] >> 31)
        assert signs == {0, 1}


def _keys(x, n_valid):
    """The CUDA source's 64-bit key of every element (``make_key``)."""
    u = x.view(np.uint32).astype(np.uint64)
    u = np.where(u == 0x80000000, 0, u)  # -0.0 ties +0.0
    hi = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    hi = np.where(np.isnan(x), np.where(u & 0x80000000, 0, 0xFFFFFFFF), hi)
    cols = np.arange(x.shape[1])
    hi = np.where(cols >= n_valid, 0x007FFFFF, hi)  # the key of -inf
    return (hi.astype(np.uint64) << np.uint64(32)) | (~cols.astype(np.uint64) & 0xFFFFFFFF)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_key_order_is_the_reference_order(name):
    """The k largest keys are ``reference_top_k``'s first k, for every k:
    the keys' descending order is its whole order."""
    x = family(name, 4, 300, seed=2)
    for n_valid in (0, 150, 300):
        keys = _keys(x, n_valid)
        assert all(len(set(row)) == len(row) for row in keys)  # distinct
        assert keys.min() > 0  # above the kernel's empty slots
        order = np.argsort(keys, axis=1)[:, ::-1]
        _, want = reference_top_k(torch.from_numpy(x), 300, n_valid)
        np.testing.assert_array_equal(order, want.numpy())


@pytest.mark.parametrize("case", ["k_past_axis", "k_zero", "k_above_cap", "f64", "f16",
                                  "one_dim", "not_contiguous", "n_valid_negative",
                                  "n_valid_past_axis"])
def test_checks_raise(case):
    x = torch.zeros((3, 300))
    args = {
        "k_past_axis": (torch.zeros((3, 7)), 8, 7),
        "k_zero": (x, 0, 300),
        "k_above_cap": (x, topk.MAX_K + 1, 300),
        "f64": (x.double(), 10, 300),
        "f16": (x.half(), 10, 300),
        "one_dim": (x[0], 10, 300),
        "not_contiguous": (torch.zeros((300, 3)).t(), 10, 300),
        "n_valid_negative": (x, 10, -1),
        "n_valid_past_axis": (x, 10, 301),
    }[case]
    with pytest.raises(ValueError) as err:
        topk.select_topk(*args)
    if case == "k_past_axis":  # api.top_k's error, word for word (C1)
        with pytest.raises(ValueError) as want:
            api.top_k(args[0], args[1])
        assert str(err.value) == str(want.value)


def test_reset_launches():
    topk.launches, topk.captured_launches = 3, 2
    topk.reset_launches()
    assert spans.snapshot()["launches"]["topk"] == {"launches": 0, "captured_launches": 0}


def test_select_topk_launches_nothing_on_the_cpu():
    before = (topk.launches, topk.captured_launches, spans.counters.get("topk.selects", 0))
    topk.select_topk(torch.randn(4, 50), 10, 50)
    assert (topk.launches, topk.captured_launches,
            spans.counters.get("topk.selects", 0)) == before
    assert spans.snapshot()["launches"]["topk"] == {"launches": topk.launches,
                                                    "captured_launches": topk.captured_launches}


def _fwd(n_docs=400, dim=500, seed=3):
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(n_docs):
        nnz = int(rng.integers(0, 12))
        comps = np.sort(rng.choice(dim, nnz, replace=False))
        docs.append((comps, rng.integers(1, 4, nnz).astype(np.float32)))  # ties in the scores
    return ForwardIndex.from_docs(docs, dim, value_format="f16"), rng


@pytest.mark.parametrize("k,path", [(10, "select"), (topk.MAX_K, "select"),
                                    (topk.MAX_K + 1, "sort"), (300, "sort")])
def test_flat_engine_paths_under_the_cuda_backend(k, path):
    """Under ``backend="cuda"`` the flat engine selects up to ``MAX_K``
    and sorts above it, counting the sorts; either way its ids and scores
    equal ``backend="torch"``'s bit for bit."""
    fwd, rng = _fwd()
    Q = rng.integers(0, 3, (6, fwd.dim)).astype(np.float32)
    got = {}
    for backend in ("torch", "cuda"):
        r = api.Retriever.build(fwd, api.RetrieverConfig(engine="flat", codec="dotvbyte", k=k,
                                                         backend=backend), device="cpu")
        sorts = spans.counters.get("topk.sorts", 0)
        got[backend] = r.search(Q)
        counted = spans.counters.get("topk.sorts", 0) - sorts
        assert counted == (1 if backend == "cuda" and path == "sort" else 0)
    for a, b in zip(got["torch"], got["cuda"]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())
