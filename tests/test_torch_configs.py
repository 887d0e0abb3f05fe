"""The port's retrieval configs (``repro_torch.configs``), the engines'
``array_specs``, the placements and ``roofline_terms`` against the
reference, on the CPU.

* The registry: ids, ``-optN``, the reference's ``KeyError``, every id
  of the reference's registry resolving.
* Both configs' fields, ``n_blocks``, ``packed_structs`` for every codec ×
  opt (and the fields and dtypes a real ``pack_blocks`` emits),
  ``model_flops``, ``_payload_bytes``, the engine and graph configs.
* ``array_specs`` for 3 engines × 4 codecs × 4 vqs.
* Every cell's per-device input and output shapes on the ``(16, 16)`` and
  ``(2, 16, 16)`` production meshes against the reference's
  ``NamedSharding.shard_shape`` (one subprocess with 512 forced jax
  devices: ``tests/torch_configs_cases.py``); ``shard_shape``'s error.
* Every cell run at a small ``dataclasses.replace`` of each config
  (dim 2,048, 240 docs) by the reference (jit on a ``(1, 1)`` mesh) and
  by the port (an in-process one-rank gloo group): scan scores within
  1e-4, search ids equal and scores within rtol 1e-5. The queries are
  100 for the scan and 16 for the searches (a cell's step takes any
  batch; 4,096 is the dry run's size).
* ``smoke()`` and no jax on import.

torch runs at one intra-op thread here (an autouse fixture).
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
from torch_configs_cases import ROOT, port_cells, reference_cells, torch_dtype_name

from repro import configs as ref_configs
from repro.launch import hlo_stats as ref_hlo
from repro.launch.mesh import make_debug_mesh as ref_debug_mesh
from repro.serve import api as ref_api
from repro_torch import configs
from repro_torch.core import layout
from repro_torch.data.synthetic import SyntheticConfig, generate_collection
from repro_torch.dist import sharding as shd
from repro_torch.launch import hlo_stats
from repro_torch.launch.mesh import (MeshShape, make_debug_mesh, make_production_mesh,
                                     production_mesh_shape)
from repro_torch.serve import api

CODECS = ("uncompressed", "dotvbyte", "streamvbyte", "bitpack")
VQS = ("f16", "u8_sq", "u4_sq", "pq")
IDS = configs.RETRIEVAL_IDS


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_dtype(dtype) -> str:
    return str(np.dtype(dtype))


def exact_payload_bytes(ref_arch) -> int:
    """The reference's ``_payload_bytes`` summed in Python integers: its
    own sum takes each stream's element count as a jnp int32 product,
    which wraps for LiLSR's ``seg`` and ``vals`` (6,955,520 × 512 >
    2**31), so the port's count is compared with the exact one."""
    return sum(int(np.dtype(v.dtype).itemsize) * int(np.prod(v.shape, dtype=np.int64))
               for v in ref_arch.packed_structs().values())


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def test_registry_ids_match_reference():
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert configs.RETRIEVAL_IDS == ref_configs.RETRIEVAL_IDS
    assert sorted(configs._MODULES) == sorted(configs.PORTED_IDS)  # the ported ids
    assert configs.PORTED_IDS == configs.ARCH_IDS + configs.RETRIEVAL_IDS  # every id
    assert configs._MODULES == ref_configs._MODULES


@pytest.mark.parametrize("opt", [0, 1, 2, 3])
@pytest.mark.parametrize("arch_id", IDS)
def test_get_arch_fields_match_reference(arch_id, opt):
    name = arch_id + (f"-opt{opt}" if opt else "")
    got, want = configs.get_arch(name), ref_configs.get_arch(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.name == name and got.opt == opt
    assert got.n_blocks == want.n_blocks
    assert got._payload_bytes() == exact_payload_bytes(want)
    if arch_id == "msmarco-splade":  # below 2**31 elements a stream, the reference's sum is exact
        assert got._payload_bytes() == want._payload_bytes()
    for shape in want.shape_names:
        assert got.model_flops(shape) == want.model_flops(shape)


def test_unknown_arch_raises_the_reference_key_error():
    for bad in ("nope", "msmarco-nope-opt2"):
        with pytest.raises(KeyError) as got:
            configs.get_arch(bad)
        with pytest.raises(KeyError) as want:
            ref_configs.get_arch(bad)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("arch_id", ref_configs.ARCH_IDS)
def test_unported_arch_raises_naming_a11(arch_id):
    """Every id of the reference's registry resolves (the LM family, and
    the GNN and RecSys families since they were ported), in the
    reference's family with its shapes and name."""
    ref = ref_configs.get_arch(arch_id)
    got = configs.get_arch(arch_id)
    assert (got.name, got.family, got.shape_names) == (arch_id, ref.family, ref.shape_names)
    assert arch_id in configs.PORTED_IDS


def test_all_cells_are_the_ported_ones():
    want = list(ref_configs.all_cells(include_retrieval=True))
    assert list(configs.all_cells()) == want and len(want) == 10 * 4 + 2 * 3
    assert list(configs.all_cells(include_retrieval=False)) == [
        (a, s) for a, s in want if a not in IDS]


@pytest.mark.parametrize("opt", [0, 1, 2, 3])
@pytest.mark.parametrize("codec", CODECS)
def test_packed_structs_match_reference_and_pack_blocks(codec, opt):
    arch = dataclasses.replace(configs.get_arch("msmarco-splade"), codec=codec, opt=opt)
    ref = dataclasses.replace(ref_configs.get_arch("msmarco-splade"), codec=codec, opt=opt)
    got, want = arch.packed_structs(), ref.packed_structs()
    assert list(got) == list(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert torch_dtype_name(got[k].dtype) == _np_dtype(want[k].dtype), k
        assert got[k].device.type == "meta"
    # the fields and dtypes a real pack emits
    col = generate_collection(SyntheticConfig(name="p", dim=2048, n_docs=40, n_queries=1,
                                              doc_nnz_mean=30.0, seed=0), value_format="f16")
    packed = layout.pack_blocks(col.fwd, codec=codec, block_size=512,
                                seg_dtype=np.int8 if opt >= 2 else np.int32).as_dict()
    assert list(packed) == list(got)
    for k, v in packed.items():
        assert torch_dtype_name(got[k].dtype) == str(v.dtype), k


@pytest.mark.parametrize("opt", [0, 2])
def test_count_abstract_params_matches_reference(opt):
    from repro.configs.base import count_abstract_params as ref_count
    from repro_torch.configs.base import count_abstract_params

    arch = dataclasses.replace(configs.get_arch("msmarco-lilsr"), opt=opt)
    ref = dataclasses.replace(ref_configs.get_arch("msmarco-lilsr"), opt=opt)
    tree = {"packed": arch.packed_structs(), "q": [torch.empty((3, 5), device="meta")]}
    ref_tree = {"packed": ref.packed_structs(), "q": [jax.ShapeDtypeStruct((3, 5), jnp.float32)]}
    assert count_abstract_params(tree) == ref_count(ref_tree) > 2**31


@pytest.mark.parametrize("arch_id", IDS)
def test_engine_and_graph_configs_match_reference(arch_id):
    arch, ref = configs.get_arch(arch_id), ref_configs.get_arch(arch_id)
    for fn in ("_engine_cfg", "_graph_cfg"):
        got, want = getattr(arch, fn)(), getattr(ref, fn)()
        assert (got.engine, got.codec, got.k, dict(got.params), got.vq) == (
            want.engine, want.codec, want.k, dict(want.params), want.vq)
        # the params are the engine's own knobs
        api.get_engine(got.engine).params(got)


# ---------------------------------------------------------------------------
# array_specs
# ---------------------------------------------------------------------------

ENGINE_DIMS = {
    "seismic": dict(dim=2048, n_docs=37, n_blocks=11, s_max=64, bs_max=64, l_max=384,
                    d_max=640),
    "hnsw": dict(n_docs=37, degree=32, l_max=384, d_max=640),
    "flat": dict(n_docs=37, l_max=384, d_max=640),
}


@pytest.mark.parametrize("vq", VQS)
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("engine", list(ENGINE_DIMS))
def test_array_specs_match_reference(engine, codec, vq):
    cfg = api.RetrieverConfig(engine=engine, codec=codec, vq=vq)
    ref_cfg = ref_api.RetrieverConfig(engine=engine, codec=codec, vq=vq)
    got = api.get_engine(engine).array_specs(cfg, **ENGINE_DIMS[engine])
    want = ref_api.get_engine(engine).array_specs(ref_cfg, **ENGINE_DIMS[engine])
    assert list(got) == list(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert torch_dtype_name(got[k].dtype) == _np_dtype(want[k].dtype), k
    rows = api.row_array_specs(codec, n_docs=5, l_max=64, d_max=128, vq=vq)
    ref_rows = ref_api.row_array_specs(codec, n_docs=5, l_max=64, d_max=128, vq=vq)
    assert {k: (tuple(v.shape), torch_dtype_name(v.dtype)) for k, v in rows.items()} == {
        k: (v.shape, _np_dtype(v.dtype)) for k, v in ref_rows.items()}


# ---------------------------------------------------------------------------
# placements on the production meshes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cells():
    return reference_cells(), port_cells()


def test_every_cell_matches_reference_per_device_shapes(cells):
    ref, port = cells
    assert sorted(port) == sorted(ref) and len(ref) == 2 * 4 * 2 * 3
    for key, want in ref.items():
        got = port[key]
        assert got["inputs"] == want["inputs"], key
        assert got["outputs"] == want["outputs"], key
        assert got["model_flops"] == want["model_flops"], key
        for k, v in want["meta"].items():  # the reference's meta keys, equal
            if k != "payload_bytes":
                assert got["meta"][k] == v, (key, k)
        if "payload_bytes" in want["meta"]:
            exact = exact_payload_bytes(ref_configs.get_arch(key.split("|")[0]))
            assert got["meta"]["payload_bytes"] == exact, key
        assert got["meta"]["device_flops"] == want["model_flops"] / want["n_chips"]


def test_production_mesh_shapes():
    for multi, (shape, axes) in {False: ((16, 16), ("data", "model")),
                                 True: ((2, 16, 16), ("pod", "data", "model"))}.items():
        m = production_mesh_shape(multi_pod=multi)
        assert (m.shape, m.mesh_dim_names) == (shape, axes)
        assert shd.mesh_size(m) == int(np.prod(shape))
        assert shd.data_axes(m) == axes[:-1]
        assert shd.axis_size(m, axes[:-1]) == int(np.prod(shape[:-1]))


def test_production_mesh_needs_its_ranks(tmp_path):
    with pytest.raises(ValueError, match="needs 256 ranks; the process group has 0"):
        make_production_mesh()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'init'}", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        with pytest.raises(ValueError, match="needs 512 ranks; the process group has 1"):
            make_production_mesh(multi_pod=True)
    finally:
        dist.destroy_process_group()


def test_shard_shape_matches_reference_and_its_error():
    mesh = MeshShape((2, 4), ("data", "model"))
    cases = [((16, 3), shd.P(("data", "model"), None)), ((8, 3, 5), shd.P("model")),
             ((8, 3, 5), shd.P()), ((6, 8), shd.P("data", "model")),
             ((4, 16), shd.P(None, ("data", "model")))]
    want = {(16, 3): (2, 3), (8, 3, 5): (2, 3, 5), (6, 8): (3, 2), (4, 16): (4, 2)}
    for shape, spec in cases:
        got = shd.shard_shape(shape, spec, mesh)
        assert got == (shape if spec == shd.P() else want[shape])
    with pytest.raises(ValueError, match=r"implies that array axis 0 is partitioned 8 times, "
                                         r"but the dimension size is 10 \(full shape: \(10, 3\), "
                                         r"per-dimension tiling factors: \[8, 1\] should evenly "
                                         r"divide the shape\)"):
        shd.shard_shape((10, 3), shd.P(("data", "model"), None), mesh)
    with pytest.raises(ValueError, match="3 entries for a 2-D array"):
        shd.shard_shape((8, 3), shd.P(None, None, "model"), mesh)
    placed = shd.to_shardings(mesh, {"a": shd.P("model"), "b": (shd.P(), shd.P(None, "data"))})
    assert placed["a"].shard_shape((8, 2)) == (2, 2)
    assert placed["b"][1].shard_shape((3, 4)) == (3, 2)
    assert shd.replicate({"x": 1, "y": (2, 3)}) == {"x": shd.P(), "y": (shd.P(), shd.P())}


def test_a_meshshape_cell_has_shapes_only():
    cell = configs.get_arch("msmarco-splade").build_cell("serve_4096q",
                                                        production_mesh_shape())
    with pytest.raises(ValueError, match="shapes only"):
        cell.fn({}, np.zeros((1, 1), np.int32), torch.zeros(1, 4))


def test_roofline_terms_match_reference():
    kw = dict(global_flops=3.2e12, device_flops=1.25e10, device_bytes=7.5e8,
              collective_bytes=3.3e5, n_chips=256, model_flops=2.1e12)
    ref_hw = ref_hlo.HW()
    same_hw = hlo_stats.HW(peak_flops=ref_hw.peak_flops, hbm_bw=ref_hw.hbm_bw,
                           ici_bw=ref_hw.ici_bw)
    assert hlo_stats.roofline_terms(**kw, hw=same_hw) == ref_hlo.roofline_terms(**kw)
    h100 = hlo_stats.HW()
    assert (h100.peak_flops, h100.hbm_bw, h100.ici_bw) == (989e12, 3.35e12, 450e9)
    r = hlo_stats.roofline_terms(**kw)
    assert r["memory_s"] == kw["device_bytes"] / 3.35e12
    assert r["dominant"] == "memory"


def test_roofline_terms_of_every_cell(cells):
    ref, port = cells
    for key, got in port.items():
        m = got["meta"]
        n_chips = ref[key]["n_chips"]
        kw = dict(global_flops=m["device_flops"] * n_chips, device_flops=m["device_flops"],
                  device_bytes=m["device_bytes"], collective_bytes=m["collective_bytes"],
                  n_chips=n_chips, model_flops=got["model_flops"])
        ref_hw = ref_hlo.HW()
        hw = hlo_stats.HW(ref_hw.peak_flops, ref_hw.hbm_bw, ref_hw.ici_bw)
        assert hlo_stats.roofline_terms(**kw, hw=hw) == ref_hlo.roofline_terms(**kw), key


# ---------------------------------------------------------------------------
# every cell at a small size, the reference and the port
# ---------------------------------------------------------------------------

SMALL = dict(dim=2048, n_docs=240)


@pytest.fixture(scope="module")
def small_collection():
    col = generate_collection(SyntheticConfig(name="s", dim=2048, n_docs=240, n_queries=100,
                                              doc_nnz_mean=60.0, query_nnz_mean=16.0, seed=0),
                              value_format="f16")
    return col.fwd, np.stack([col.query_dense(i) for i in range(col.n_queries)])


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """A one-rank gloo group in this process (the port's mesh) and the
    reference's one-device mesh."""
    init = tmp_path_factory.mktemp("group") / "init"
    dist.init_process_group("gloo", init_method=f"file://{init}", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=120))
    try:
        yield make_debug_mesh((1, 1), ("data", "model")), ref_debug_mesh((1, 1),
                                                                          ("data", "model"))
    finally:
        dist.destroy_process_group()


def _ref_run(cell_fn, mesh, in_sh, out_sh, *args):
    with jax.set_mesh(mesh):
        return jax.jit(cell_fn, in_shardings=in_sh, out_shardings=out_sh)(*args)


@pytest.mark.parametrize("opt", [0, 1, 2, 3])
@pytest.mark.parametrize("arch_id", IDS)
def test_scan_cell_small_matches_reference(meshes, small_collection, arch_id, opt):
    mesh, ref_mesh = meshes
    fwd, Q = small_collection
    name = arch_id + (f"-opt{opt}" if opt else "")
    arch = dataclasses.replace(configs.get_arch(name), **SMALL)
    ref = dataclasses.replace(ref_configs.get_arch(name), **SMALL)
    if opt == 0:
        arrays = layout.pack_blocks(fwd, codec=arch.codec, block_size=arch.block_size).as_dict()
    else:
        arrays, docs_local = layout.pack_blocks_sharded(
            fwd, 1, codec=arch.codec, block_size=arch.block_size,
            seg_dtype=np.int8 if opt >= 2 else np.int32)
        assert docs_local == fwd.n_docs
    cell, ref_cell = arch.build_cell("scan_100q", mesh), ref.build_cell("scan_100q", ref_mesh)
    dim_pad = cell.input_structs[1].shape[1]
    assert dim_pad == ref_cell.input_structs[1].shape[1]
    Qp = np.zeros((len(Q), dim_pad), np.float32)
    Qp[:, : fwd.dim] = Q
    got = cell.fn(arrays, torch.from_numpy(Qp)).numpy()
    want = np.asarray(_ref_run(ref_cell.fn, ref_mesh, ref_cell.in_shardings,
                               ref_cell.out_shardings,
                               {k: jnp.asarray(v) for k, v in arrays.items()}, jnp.asarray(Qp)))
    assert got.shape == want.shape == (len(Q), fwd.n_docs)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, np.stack([fwd.exact_scores(q) for q in Q]), rtol=1e-4,
                               atol=2e-3)


def test_global_scan_places_an_array_changed_in_place(meshes, small_collection):
    """The opt-0 scan keeps its placed pack only while the arrays hold the
    same tensors: one replaced in the same dict is placed anew."""
    mesh, _ = meshes
    fwd, Q = small_collection
    arch = dataclasses.replace(configs.get_arch("msmarco-splade"), **SMALL)
    arrays = layout.pack_blocks(fwd, codec=arch.codec, block_size=arch.block_size).as_dict()
    cell = arch.build_cell("scan_100q", mesh)
    Qp = np.zeros((len(Q), cell.input_structs[1].shape[1]), np.float32)
    Qp[:, : fwd.dim] = Q
    first = cell.fn(arrays, torch.from_numpy(Qp)).numpy()
    vals = arrays["vals"]
    arrays["vals"] = np.zeros_like(vals)
    assert not cell.fn(arrays, torch.from_numpy(Qp)).numpy().any()
    arrays["vals"] = vals
    assert cell.fn(arrays, torch.from_numpy(Qp)).numpy().tobytes() == first.tobytes()


@pytest.mark.parametrize("shape", ["serve_4096q", "graph_4096q"])
@pytest.mark.parametrize("arch_id", IDS)
def test_search_cell_small_matches_reference(meshes, small_collection, arch_id, shape):
    """The reference's side is its cell's program, ``make_sharded_search``
    with the cell's config, at the local size the arrays were built at
    (the cell's static size is the dry run's estimate)."""
    mesh, ref_mesh = meshes
    fwd, Q = small_collection
    Q = Q[:16]
    arch = dataclasses.replace(configs.get_arch(arch_id), **SMALL)
    ref = dataclasses.replace(ref_configs.get_arch(arch_id), **SMALL)
    which = "_graph_cfg" if shape == "graph_4096q" else "_engine_cfg"
    cfg, ref_cfg = getattr(arch, which)(), getattr(ref, which)()
    stacked, idmap, n_local = api.build_shard_arrays(fwd, cfg, 1)
    cell = arch.build_cell(shape, mesh)
    got_i, got_s = cell.fn(stacked, idmap, torch.from_numpy(Q))
    ref_fn = ref_api.make_sharded_search(ref_mesh, ref_cfg, n_local, ref.n_docs, ref.value_scale,
                                         index_axis="model", query_axes=("data",))
    want_i, want_s = _ref_run(ref_fn, ref_mesh, None, None,
                              {k: jnp.asarray(v) for k, v in stacked.items()},
                              jnp.asarray(idmap), jnp.asarray(Q))
    assert got_i.shape == (len(Q), 10)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5, atol=0)


@pytest.mark.parametrize("arch_id", IDS)
def test_smoke_matches_reference(arch_id):
    got = configs.get_arch(arch_id).smoke(seed=0, device="cpu")
    want = ref_configs.get_arch(arch_id).smoke(seed=0)
    assert got["device"] == "cpu"
    assert got["max_err"] < 2e-3
    assert abs(got["max_err"] - want["max_err"]) < 2e-3


def test_smoke_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        configs.get_arch("msmarco-splade").smoke()


def test_config_modules_import_no_jax():
    code = (
        "import sys\n"
        "import repro_torch.configs, repro_torch.configs.retrieval, repro_torch.configs.base\n"
        "import repro_torch.configs.msmarco_splade, repro_torch.configs.msmarco_lilsr\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.hlo_stats, repro_torch.launch.mesh\n"
        "from repro_torch.configs import get_arch\n"
        "from repro_torch.launch.mesh import production_mesh_shape\n"
        "for a in repro_torch.configs.RETRIEVAL_IDS:\n"
        "    arch = get_arch(a)\n"
        "    for s in arch.shape_names:\n"
        "        arch.build_cell(s, production_mesh_shape())\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})


# ---------------------------------------------------------------------------
# what the card's phase 13 relies on
# ---------------------------------------------------------------------------


def test_one_shard_hnsw_stack_is_the_graph_with_an_identity_map(small_collection):
    """``chip_smoke.py`` phase 13 serves ``graph_4096q`` over a built
    graph's arrays with a shard axis of 1 and the identity id map: that is
    what ``build_shard_arrays(n_shards=1)`` stacks for the graph so built."""
    fwd = small_collection[0].slice(0, 120)
    cfg = configs.get_arch("msmarco-splade")._graph_cfg()
    stacked, idmap, n_local = api.build_shard_arrays(fwd, cfg, 1)
    impl = api.get_engine("hnsw")
    arrays = impl.arrays_from_index(impl.host_index(fwd, cfg), cfg)
    assert n_local == fwd.n_docs
    assert list(stacked) == list(arrays)
    for k, v in arrays.items():
        assert stacked[k].dtype == v.dtype and np.array_equal(stacked[k], v[None]), k
    np.testing.assert_array_equal(idmap, np.arange(fwd.n_docs + 1, dtype=np.int32)[None])


@pytest.mark.parametrize("n_docs", [2_400, 2_750])
def test_full_corpus_replication_on_a_tenfold_copy(meshes, small_collection, n_docs):
    """``chip_smoke.py``'s ``replicate_pack`` / ``replicate_csr`` (phase 13
    (b)) on the CPU: ten copies of a 240-doc pack (the last one cut, or
    whole) scanned through the opt-0 cell equal ``exact_scores`` of the
    replicated collection, copy by copy the base's scores, and the CSR
    the replicated collection's."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    from repro_torch.core.forward_index import ForwardIndex

    fwd, Q = small_collection
    Q = Q[:8]
    n = fwd.n_docs
    base = {k: torch.from_numpy(v)
            for k, v in layout.pack_blocks(fwd, codec="dotvbyte", block_size=512).as_dict().items()}
    rep = chip_smoke.replicate_pack(base, n, n_docs)
    docs = [(fwd.components[fwd.offsets[i]:fwd.offsets[i + 1]],
             fwd.value_format.dequantise(fwd.values[fwd.offsets[i]:fwd.offsets[i + 1]]))
            for i in range(n)]
    big = ForwardIndex.from_docs([docs[i % n] for i in range(n_docs)], fwd.dim, value_format="f16")
    arch = dataclasses.replace(configs.get_arch("msmarco-splade"), dim=fwd.dim, n_docs=n_docs)
    got = arch.build_cell("scan_100q", meshes[0]).fn(rep, torch.from_numpy(Q))
    want = np.stack([big.exact_scores(q) for q in Q])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=2e-3)
    base_scores = torch.from_numpy(np.stack([fwd.exact_scores(q) for q in Q]))
    assert len(chip_smoke.replicas_close(got, base_scores, n, atol=2e-3)) == -(-n_docs // n)
    crow, col, val = chip_smoke.replicate_csr(
        torch.from_numpy(fwd.offsets.astype(np.int64)),
        torch.from_numpy(fwd.components.astype(np.int64)),
        torch.from_numpy(fwd.value_format.dequantise(fwd.values)), n, n_docs)
    assert crow.dtype == col.dtype == torch.int32
    np.testing.assert_array_equal(crow.numpy(), big.offsets)
    np.testing.assert_array_equal(col.numpy(), big.components)
    np.testing.assert_array_equal(val.numpy(), big.value_format.dequantise(big.values))
    # phase 13 (b)'s sparse.mm in row parts under an index limit (LiLSR's
    # corpus passes 2**31): int64 offsets, int32 columns, the parts' products
    # concatenated equal the whole CSR's
    wide = chip_smoke.replicate_csr(
        torch.from_numpy(fwd.offsets.astype(np.int64)),
        torch.from_numpy(fwd.components.astype(np.int64)),
        torch.from_numpy(fwd.value_format.dequantise(fwd.values)), n, n_docs,
        torch.int64, torch.int32)
    assert (wide[0].dtype, wide[1].dtype) == (torch.int64, torch.int32)
    limit = int(crow[-1]) // 3 + 1
    parts = chip_smoke.csr_row_parts(*wide, fwd.dim, max_nnz=limit)
    assert len(parts) >= 3 and sum(p.shape[0] for p in parts) == n_docs
    assert all(p.values().numel() <= limit and p.crow_indices().dtype == torch.int32
               for p in parts)
    Qt = torch.from_numpy(Q.T.copy())
    whole = torch.sparse.mm(torch.sparse_csr_tensor(crow, col, val, size=(n_docs, fwd.dim)), Qt)
    np.testing.assert_allclose(torch.cat([torch.sparse.mm(p, Qt) for p in parts]).numpy(),
                               whole.numpy(), rtol=1e-6, atol=1e-6)
