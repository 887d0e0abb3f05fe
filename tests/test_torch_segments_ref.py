"""The port's ``MutableRetriever`` against the reference's, on the CPU, on
the reference's fixture (50 docs at dim 256, seed 7):

* the two, driven through the same operation sequence for every engine
  × codec, agree on ``live_ids``, ``next_id``, ``epoch``, ``generation``
  and the top-k ids, with scores within f16's atol (2e-3);
* mutable roots cross both ways: a root the reference wrote opens in the
  port's ``open_retriever`` and serves the reference's ids, the port
  mutates it and the reference reopens it; the same operations write
  equal ``state.json`` fields, ``store.npz`` arrays and artifact arrays
  in both packages;
* ``import repro_torch.serve.segments`` pulls in neither ``jax`` nor
  ``repro``."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.data import synthetic as ref_synthetic
from repro.serve import api as ref_api
from repro.serve import segments as ref_segments
from repro_torch.core.layout import available_layouts
from repro_torch.data.synthetic import SyntheticConfig, generate_collection
from repro_torch.serve.api import open_retriever
from repro_torch.serve.segments import MutableRetriever
from torch_segments_cases import (  # noqa: F401  (one_intra_op_thread: an autouse fixture)
    ATOL,
    ENGINE_PARAMS,
    ENGINES,
    N_BASE,
    SEGMENTS_COLLECTION,
    Twins,
    cfg_for,
    create,
    host,
    one_intra_op_thread,
)


@pytest.fixture(scope="module")
def collection():
    return generate_collection(SyntheticConfig(**SEGMENTS_COLLECTION), value_format="f16")


@pytest.fixture(scope="module")
def ref_collection():
    return ref_synthetic.generate_collection(
        ref_synthetic.SyntheticConfig(**SEGMENTS_COLLECTION), value_format="f16")


@pytest.fixture(scope="module")
def queries(collection):
    return np.stack([collection.query_dense(i) for i in range(collection.n_queries)])


@pytest.mark.parametrize("codec", available_layouts())
@pytest.mark.parametrize("engine", ENGINES)
def test_mutation_matches_reference(collection, ref_collection, queries, engine, codec):
    t = Twins(collection, ref_collection, engine, codec, N_BASE)
    t.check(queries, f"{engine}/{codec} base")
    t.do("delete", [3, 17])
    t.check(queries, f"{engine}/{codec} 0 segments")
    t.insert(range(N_BASE, N_BASE + 4))
    t.check(queries, f"{engine}/{codec} 1 segment")
    t.insert(range(44, 47))
    t.do("delete", [41, 45])
    for m, f in ((t.port, t.fwd), (t.ref, t.ref_fwd)):
        m.update([f.doc(47)], ids=[10])
    t.check(queries, f"{engine}/{codec} 3 segments")
    t.do("merge")
    t.check(queries, f"{engine}/{codec} post-merge")
    t.insert(range(48, 50))
    t.do("delete", [0, 48])
    t.check(queries, f"{engine}/{codec} generation 1 + segment")


def _ref_cfg(engine, codec, n_shards=1):
    return ref_api.RetrieverConfig(engine=engine, codec=codec, k=5, n_shards=n_shards,
                                   params=ENGINE_PARAMS[engine])


def _agree(port, ref, Q, label):
    np.testing.assert_array_equal(port.live_ids(), ref.live_ids(), err_msg=label)
    assert (port.next_id, port.epoch, port.generation) == (
        ref.next_id, ref.epoch, ref.generation), label
    pi, ps = host(port.search(Q))
    ri, rs = host(ref.search(Q))
    np.testing.assert_array_equal(pi, ri, err_msg=f"{label}: ids")
    np.testing.assert_allclose(ps, rs, rtol=0, atol=ATOL, err_msg=f"{label}: scores")


@pytest.mark.parametrize("n_shards", [1, 3])
@pytest.mark.parametrize("engine", ENGINES)
def test_roots_cross_both_ways(collection, ref_collection, queries, tmp_path, engine,
                               n_shards):
    """The reference writes a root (two generations, segments, tombstones,
    an orphan of a crashed insert); the port opens it and serves the
    reference's ids, mutates it, and the reference reopens what the port
    committed."""
    root = tmp_path / "root"
    fwd = ref_collection.fwd
    ref = ref_segments.MutableRetriever.create(fwd.slice(0, N_BASE),
                                               _ref_cfg(engine, "dotvbyte", n_shards), root=root)
    ref.insert([fwd.doc(i) for i in range(N_BASE, N_BASE + 3)])
    ref.delete([2, N_BASE])
    ref.merge()
    ref.insert([fwd.doc(i) for i in range(N_BASE + 3, N_BASE + 6)])
    ref.delete([5, N_BASE + 4])
    with pytest.raises(ref_segments.InjectedCrash):
        ref.insert([fwd.doc(49)], _crash_before_commit=True)
    port = open_retriever(root, device="cpu")
    assert isinstance(port, MutableRetriever) and port.device.type == "cpu"
    assert len(port.segments) == 1 and port.generation == 1
    _agree(port, ref, queries, f"{engine} reference root in the port")
    port.insert([collection.fwd.doc(49)])  # reclaims the reference's orphan
    port.delete([7])
    back = ref_api.open_retriever(root)
    assert isinstance(back, ref_segments.MutableRetriever)
    _agree(port, back, queries, f"{engine} port commits in the reference")
    port.merge()
    back = ref_api.open_retriever(root)
    assert back.generation == 2 and not back.segments
    _agree(port, back, queries, f"{engine} port generation in the reference")


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("engine", ENGINES)
def test_same_operations_write_equal_roots(collection, ref_collection, tmp_path, engine):
    """Port and reference, through the same operations on two roots,
    write the same ``CURRENT``, ``state.json`` fields, ``store.npz``
    arrays and artifact arrays (dtype and bytes), manifests alike."""
    roots = {"port": tmp_path / "port", "ref": tmp_path / "ref"}
    port = create(collection.fwd.slice(0, N_BASE), cfg_for(engine, "streamvbyte", k=5),
                  roots["port"])
    ref = ref_segments.MutableRetriever.create(ref_collection.fwd.slice(0, N_BASE),
                                               _ref_cfg(engine, "streamvbyte"),
                                               root=roots["ref"])
    for m, fwd in ((port, collection.fwd), (ref, ref_collection.fwd)):
        m.insert([fwd.doc(i) for i in range(N_BASE, N_BASE + 4)])
        m.delete([1, N_BASE + 1])
        m.merge()
        m.insert([fwd.doc(i) for i in range(N_BASE + 4, N_BASE + 6)])
        m.update([fwd.doc(49)], ids=[3])
    files = {name: sorted(p.relative_to(roots[name]).as_posix() for p in roots[name].rglob("*"))
             for name in roots}
    assert files["port"] == files["ref"]
    assert (roots["port"] / "CURRENT").read_text() == (roots["ref"] / "CURRENT").read_text()
    for rel in files["port"]:
        a, b = roots["port"] / rel, roots["ref"] / rel
        if rel.endswith("state.json"):
            assert json.loads(a.read_text()) == json.loads(b.read_text()), rel
        elif rel.endswith("manifest.json"):
            assert json.loads(a.read_text()) == json.loads(b.read_text()), rel
        elif rel.endswith(".npz"):
            za, zb = _npz(a), _npz(b)
            assert sorted(za) == sorted(zb), rel
            for k in za:
                assert za[k].dtype == zb[k].dtype and za[k].tobytes() == zb[k].tobytes(), (rel, k)


def test_segments_module_imports_neither_jax_nor_the_reference():
    code = ("import sys; import repro_torch.serve.segments; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'repro.'))"
            " or m == 'repro']; print(bad); sys.exit(1 if bad else 0)")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = {**os.environ, "PYTHONPATH": src}
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
