"""Every row codec × value codec, served end to end against the
reference: an artifact the reference saves opens in the port with
byte-equal arrays, and the port's Seismic and flat top-k ids equal the
reference's ``open_retriever(path).search(Q)`` on that same artifact,
under both port backends; an artifact the port saves opens in the
reference byte for byte and gives the same ids there.

Ids are compared exactly; scores at rtol 1e-5 / atol 1e-4 (the same f32
products summed in another order)."""

import jax.numpy as jnp  # noqa: F401  (the reference runs on jax's CPU backend)
import numpy as np
import pytest
import torch

from repro.data import synthetic as ref_synthetic
from repro.serve import api as ref_api
from repro.serve.engines.seismic import SeismicEngine as RefSeismicEngine
from repro_torch.serve import api
from torch_cases import VARIANTS

RTOL, ATOL = 1e-5, 1e-4
SEISMIC = dict(cut=4, block_budget=64, n_probe=6, n_postings=60, block_size=8)


@pytest.fixture(scope="module")
def collection():
    kw = dict(name="splade", dim=2048, n_docs=160, n_queries=6, seed=4)
    col = ref_synthetic.generate_collection(ref_synthetic.SyntheticConfig(**kw),
                                            value_format="f16")
    Q = np.stack([col.query_dense(i) for i in range(col.n_queries)])
    index = RefSeismicEngine().host_index(
        col.fwd, ref_api.RetrieverConfig(engine="seismic", params=SEISMIC))
    return col, Q, index


def _ref_retriever(collection, engine, codec, vq):
    col, _, index = collection
    cfg = ref_api.RetrieverConfig(engine=engine, codec=codec, vq=vq, backend="jnp",
                                  params=SEISMIC if engine == "seismic" else {})
    if engine == "seismic":
        return ref_api.Retriever.from_host_index(index, cfg)
    return ref_api.Retriever.build(col.fwd, cfg)


@pytest.mark.parametrize("engine", ["seismic", "flat"])
@pytest.mark.parametrize("codec,vq", VARIANTS, ids=[f"{c}-{v}" for c, v in VARIANTS])
def test_reference_artifact_serves_identically(collection, tmp_path, engine, codec, vq):
    _, Q, _ = collection
    _ref_retriever(collection, engine, codec, vq).save(tmp_path / "ref")
    ref = ref_api.open_retriever(tmp_path / "ref")
    want_ids, want_scores = (np.asarray(a) for a in ref.search(Q))
    port = api.open_retriever(tmp_path / "ref", device="cpu")
    assert port.cfg.vq == vq and port.cfg.codec == codec
    for k, v in ref.arrays.items():
        got = port.arrays[k].numpy()
        assert got.dtype == np.asarray(v).dtype and got.tobytes() == np.asarray(v).tobytes(), k
    for backend in ("torch", "cuda"):  # cuda: the kernel's plain version on CPU tensors
        r = api.Retriever(port.cfg.replace(backend=backend), port.arrays, n_docs=port.n_docs,
                          dim=port.dim, value_scale=port.value_scale,
                          value_format=port.value_format, device="cpu")
        ids, scores = r.search(Q)
        np.testing.assert_array_equal(ids.numpy(), want_ids)
        np.testing.assert_allclose(scores.numpy(), want_scores, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("codec,vq", VARIANTS, ids=[f"{c}-{v}" for c, v in VARIANTS])
def test_port_artifact_opens_in_reference(collection, tmp_path, codec, vq):
    col, Q, _ = collection
    port_fwd = _port_fwd(col.fwd)
    r = api.Retriever.build(port_fwd, api.RetrieverConfig(
        engine="flat", codec=codec, vq=vq, backend="cuda"), device="cpu")
    r.save(tmp_path / "port")
    ref = ref_api.open_retriever(tmp_path / "port")
    assert ref.cfg.vq == vq
    for k, v in r.arrays.items():
        assert np.asarray(ref.arrays[k]).tobytes() == v.numpy().tobytes(), k
    ids, _ = r.search(Q)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref.search(Q)[0]))


def _port_fwd(fwd):
    from repro_torch.core.forward_index import VALUE_FORMATS, ForwardIndex

    return ForwardIndex(fwd.components, fwd.values, fwd.offsets, fwd.dim,
                        VALUE_FORMATS[fwd.value_format.name])


def test_retriever_accepts_every_vq(collection):
    col, Q, _ = collection
    for _, vq in VARIANTS[:4]:
        r = api.Retriever.build(_port_fwd(col.fwd), api.RetrieverConfig(
            engine="flat", codec="dotvbyte", vq=vq), device="cpu")
        ids, _ = r.search(torch.from_numpy(Q))
        assert ids.shape == (len(Q), 10)
