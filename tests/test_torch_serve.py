"""The port's serving path against the reference: Seismic and flat
top-k ids equal the reference ``Retriever.search`` (``backend="jnp"``)
on the same collection and params, scores allclose; artifacts cross
between the packages byte for byte; the CLI runs; the package imports
neither jax nor the reference; nothing runs on the CPU unless asked."""

import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp  # noqa: F401  (the reference runs on jax's CPU backend)
import numpy as np
import pytest
import torch

from repro.data import synthetic as ref_synthetic
from repro.serve import api as ref_api
from repro_torch.data import synthetic
from repro_torch.kernels import rows_dot
from repro_torch.launch import serve as serve_cli
from repro_torch.serve import api
from torch_cases import one_intra_op_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
# ids are compared exactly; scores sum the same f32 products in another order
RTOL, ATOL = 1e-5, 1e-4

CLI_SEISMIC = dict(cut=8, block_budget=512, n_probe=64, n_postings=2000, block_size=64)
TIGHT_SEISMIC = dict(cut=4, block_budget=64, n_probe=6, n_postings=60, block_size=8)


@pytest.fixture(scope="module", params=[(2048, 400), (30522, 200)], ids=["dim2048", "dim30522"])
def collection(request):
    dim, n_docs = request.param
    kw = dict(name="splade", dim=dim, n_docs=n_docs, n_queries=8, seed=1)
    ref = ref_synthetic.generate_collection(ref_synthetic.SyntheticConfig(**kw), value_format="f16")
    port = synthetic.generate_collection(synthetic.SyntheticConfig(**kw), value_format="f16")
    Q = np.stack([port.query_dense(i) for i in range(port.n_queries)])
    return ref, port, Q


def _ref_search(col, engine, params, Q, k=10):
    r = ref_api.Retriever.build(col.fwd, ref_api.RetrieverConfig(
        engine=engine, codec="dotvbyte", backend="jnp", k=k, params=params))
    ids, scores = r.search(Q)
    return r, np.asarray(ids), np.asarray(scores)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("engine,params", [
    ("seismic", CLI_SEISMIC), ("seismic", TIGHT_SEISMIC), ("flat", {}),
], ids=["seismic-cli", "seismic-tight", "flat"])
def test_topk_matches_reference(collection, engine, params, backend):
    ref, port, Q = collection
    _, want_ids, want_scores = _ref_search(ref, engine, params, Q)
    r = api.Retriever.build(port.fwd, api.RetrieverConfig(
        engine=engine, codec="dotvbyte", backend=backend, params=params), device="cpu")
    ids, scores = r.search(Q)
    assert ids.dtype == torch.int32 and ids.shape == (len(Q), 10)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_allclose(scores.numpy(), want_scores, rtol=RTOL, atol=ATOL)
    # search_one is the batch of one
    one_ids, one_scores = r.impl.search_one(r.cfg, r.n_docs, r.value_scale, r.arrays,
                                            torch.from_numpy(Q[3]))
    np.testing.assert_array_equal(one_ids.numpy(), want_ids[3])


def test_from_host_index_matches_build(collection):
    """One host Seismic build serves both backends, as ``Retriever.build``
    would."""
    _, port, Q = collection
    from repro_torch.serve.engines.seismic import SeismicEngine

    cfg = api.RetrieverConfig(engine="seismic", codec="dotvbyte", params=TIGHT_SEISMIC)
    index = SeismicEngine().host_index(port.fwd, cfg)
    built = api.Retriever.build(port.fwd, cfg, device="cpu")
    for backend in ("torch", "cuda"):
        r = api.Retriever.from_host_index(index, cfg.replace(backend=backend), device="cpu")
        assert sorted(r.arrays) == sorted(built.arrays)
        torch.testing.assert_close(r.search(Q)[1], built.search(Q)[1], rtol=0, atol=0)
    with pytest.raises(ValueError, match="no host-index form"):
        api.Retriever.from_host_index(index, cfg.replace(engine="flat"), device="cpu")


def test_reference_artifact_opens_byte_equal(collection, tmp_path):
    ref, _, Q = collection
    r, want_ids, want_scores = _ref_search(ref, "seismic", TIGHT_SEISMIC, Q)
    r.save(tmp_path / "ref")
    with np.load(tmp_path / "ref" / "arrays.npz") as npz:
        saved = {k: npz[k] for k in npz.files}
    port = api.open_retriever(tmp_path / "ref", device="cpu")
    assert port.cfg.backend == "torch" and port.cfg.engine == "seismic"
    assert sorted(port.arrays) == sorted(saved)
    for k, v in saved.items():
        got = port.arrays[k].numpy()
        assert got.dtype == v.dtype and got.tobytes() == v.tobytes(), k
    ids, scores = port.search(Q)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_allclose(scores.numpy(), want_scores, rtol=RTOL, atol=ATOL)


def test_port_artifact_opens_in_reference(collection, tmp_path):
    _, port, Q = collection
    r = api.Retriever.build(port.fwd, api.RetrieverConfig(
        engine="flat", codec="dotvbyte", backend="cuda"), device="cpu")
    r.save(tmp_path / "port")
    ref = ref_api.open_retriever(tmp_path / "port")
    assert ref.cfg.backend == "pallas"  # the port writes the reference's names
    for k, v in r.arrays.items():
        assert np.asarray(ref.arrays[k]).tobytes() == v.numpy().tobytes(), k
    ids, _ = r.search(Q)
    ref_ids, _ = ref.search(Q)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))


def test_from_reference_arrays_hands_one_index_to_both(collection):
    ref, _, Q = collection
    r, want_ids, _ = _ref_search(ref, "flat", {}, Q)
    host = {k: np.asarray(v) for k, v in r.arrays.items()}
    manifest = ref_api.manifest_dict(r.cfg, host, n_docs=r.n_docs, dim=r.dim,
                                     value_scale=r.value_scale, value_format=r.value_format)
    tensors = api.from_reference_arrays(manifest, host, device="cpu")
    port = api.Retriever(api.cfg_from_manifest(manifest), tensors, n_docs=r.n_docs,
                         dim=r.dim, value_scale=r.value_scale,
                         value_format=r.value_format, device="cpu")
    np.testing.assert_array_equal(port.search(Q)[0].numpy(), want_ids)
    with pytest.raises(api.ArtifactError, match="payload mismatch"):
        api.from_reference_arrays(manifest, {k: host[k] for k in list(host)[1:]}, device="cpu")


@pytest.mark.parametrize("name,want", [
    ("jnp", "torch"), ("pallas", "cuda"), ("pallas_interpret", "cuda"),
    ("pallas_compiled", "cuda"),
])
def test_manifest_backend_names_map(name, want):
    from repro_torch.kernels import modes

    assert modes.backend_from_manifest(name) == want
    assert modes.backend_from_manifest(modes.backend_to_manifest(want)) == want


def test_artifact_errors(collection, tmp_path):
    _, port, _ = collection
    r = api.Retriever.build(port.fwd, api.RetrieverConfig(engine="flat", codec="dotvbyte"),
                            device="cpu")
    r.save(tmp_path / "a")
    mf = tmp_path / "a" / "manifest.json"
    text = mf.read_text()
    mf.write_text(text.replace('"version": 1', '"version": 99'))
    with pytest.raises(api.ArtifactError, match="version"):
        api.open_retriever(tmp_path / "a", device="cpu")
    mf.write_text(text.replace('"vq": "f16"', '"vq": "u2_sq"'))
    with pytest.raises(api.ArtifactError, match="unknown value codec"):
        api.open_retriever(tmp_path / "a", device="cpu")
    with pytest.raises(api.ArtifactError, match="no manifest"):
        api.open_retriever(tmp_path / "missing", device="cpu")


def test_cli_runs_end_to_end(tmp_path, capsys):
    argv = ["--device", "cpu", "--n-docs", "150", "--n-queries", "3", "--backend", "cuda"]
    serve_cli.main(argv + ["--save-index", str(tmp_path)])
    serve_cli.main(argv + ["--load-index", str(tmp_path), "--backend", "torch"])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if "recall@10=" in ln]
    assert len(lines) == 2 and "backend=cuda" in lines[0] and "backend=torch" in lines[1]
    assert "roundtrip=ids-identical" in lines[1] and "(CPU)" in lines[1]
    assert (tmp_path / "seismic-dotvbyte" / "manifest.json").is_file()


@pytest.mark.parametrize("engine", ["seismic", "hnsw", "flat"])
def test_cli_pipeline_load_generator(engine, capsys):
    """``--pipeline`` drives a 32-request trace through the scheduler,
    holds every response to direct search (byte for byte on the CPU)
    and prints the ServeStats line."""
    serve_cli.main(["--device", "cpu", "--n-docs", "300", "--n-queries", "4", "--pipeline",
                    "--requests", "32", "--engine", engine])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if "pipeline parity OK" in ln]
    assert len(lines) == 1 and lines[0].startswith(f"{engine} ") and "(32 requests, CPU)" in lines[0]
    held = re.search(r"parity: (\d+) bitwise, (\d+) cache replays", lines[0])
    assert held and int(held[1]) + int(held[2]) == 32 and int(held[1]) > 0
    assert re.search(r"served=32 qps=\d+ p50=\d+µs .* recompiles=8 buckets\[b\d", lines[0])


def test_cli_pipeline_refuses_index_flags(tmp_path):
    for flag in ("--save-index", "--load-index"):
        with pytest.raises(SystemExit):
            serve_cli.main(["--device", "cpu", "--pipeline", flag, str(tmp_path)])


def test_cli_hnsw_sweeps_one_host_graph(tmp_path, capsys):
    """``--engine hnsw --compare-codecs`` builds the graph once at the
    reference CLI's parameters and serves every row codec over it: the
    same recall for every codec (compression is lossless), and every
    reopened artifact returns the build-time top-k."""
    argv = ["--device", "cpu", "--engine", "hnsw", "--n-docs", "300", "--n-queries", "3",
            "--beam", "32", "--iters", "24", "--compare-codecs"]
    serve_cli.main(argv + ["--save-index", str(tmp_path)])
    serve_cli.main(argv + ["--load-index", str(tmp_path), "--backend", "torch"])
    out = capsys.readouterr().out
    assert out.count("hnsw: host index built") == 1
    lines = [ln for ln in out.splitlines() if "recall@10=" in ln]
    assert [ln.split("codec=")[1].split()[0] for ln in lines] == sorted(
        ["uncompressed", "dotvbyte", "streamvbyte", "bitpack"]) * 2
    assert all(ln.startswith("hnsw ") for ln in lines)
    assert len({ln.split("recall@10=")[1].split()[0] for ln in lines}) == 1
    assert all("roundtrip=ids-identical" in ln for ln in lines[4:])
    manifest = api.load_manifest(tmp_path / "hnsw-dotvbyte")
    assert manifest["params"] == dict(beam=32, iters=24, n_seeds=8, m=16, ef_construction=48)


def test_cli_compare_codecs_sweeps_one_host_index(tmp_path, capsys):
    """``--compare-codecs`` builds the Seismic host index once and serves
    every row codec over it; compression is lossless, so recall is the
    same for every codec, and the bits per component are the reference's."""
    from repro.data import synthetic as ref_syn
    from repro.core.forward_index import ForwardIndex as RefForwardIndex

    argv = ["--device", "cpu", "--n-docs", "150", "--n-queries", "3", "--compare-codecs"]
    serve_cli.main(argv + ["--save-index", str(tmp_path)])
    serve_cli.main(argv + ["--load-index", str(tmp_path), "--backend", "torch"])
    out = capsys.readouterr().out
    assert out.count("host index built") == 1
    lines = [ln for ln in out.splitlines() if "recall@10=" in ln]
    assert [ln.split("codec=")[1].split()[0] for ln in lines] == sorted(
        ["uncompressed", "dotvbyte", "streamvbyte", "bitpack"]) * 2
    assert len({ln.split("recall@10=")[1].split()[0] for ln in lines}) == 1
    fwd = ref_syn.generate_collection(ref_syn.splade_config(150, 3, 0), value_format="f16").fwd
    ref = RefForwardIndex(fwd.components, fwd.values, fwd.offsets, fwd.dim, fwd.value_format)
    for ln in lines:
        codec = ln.split("codec=")[1].split()[0]
        bits = 8 * ref.storage_bytes(codec)["components"] / ref.total_nnz
        assert f"({bits:.1f} bits/comp vs 16.0 raw" in ln
    assert all("roundtrip=ids-identical" in ln for ln in lines[4:])


def test_import_leaves_jax_and_reference_out():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.serve.api, repro_torch.launch.serve\n"
        "import repro_torch.kernels.rows_dot, repro_torch.kernels.build\n"
        "import repro_torch.serve.engines, repro_torch.data.synthetic\n"
        "import repro_torch.core.hnsw, repro_torch.serve.engines.hnsw\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})


def test_sources_import_no_jax_or_reference():
    pattern = re.compile(r"^\s*(import jax|from jax|import repro\.|from repro\.|from repro import)",
                         re.M)
    files = list((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders


def test_default_device_is_cuda_and_never_falls_back(collection, monkeypatch):
    _, port, Q = collection
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = api.RetrieverConfig(engine="flat", codec="dotvbyte")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        api.Retriever.build(port.fwd, cfg)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        serve_cli.main(["--n-docs", "20", "--n-queries", "1"])
    r = api.Retriever.build(port.fwd, cfg, device="cpu")
    assert r.device.type == "cpu" and rows_dot.launches == 0


def test_config_validation(collection):
    _, port, _ = collection
    with pytest.raises(ValueError, match="unknown backend"):
        api.Retriever.build(port.fwd, api.RetrieverConfig(engine="flat", backend="jnp"),
                            device="cpu")
    with pytest.raises(ValueError, match="unknown 'seismic' engine params"):
        api.Retriever.build(port.fwd, api.RetrieverConfig(params={"beam": 3}), device="cpu")
    with pytest.raises(ValueError, match="at least one document"):
        api.Retriever.build(port.fwd, api.RetrieverConfig(engine="flat",
                                                          n_shards=port.fwd.n_docs + 1),
                            device="cpu")
    with pytest.raises(ValueError, match="no registered engine"):
        api.get_engine("ivf")


# -- C1: a k past the axis raises where the reference raises ----------------------


@pytest.fixture(scope="module")
def c1_collection():
    """ROADMAP C1's probe: 600 docs at dim 2,000, 4 queries."""
    kw = dict(name="splade", dim=2000, n_docs=600, n_queries=4, seed=0)
    ref = ref_synthetic.generate_collection(ref_synthetic.SyntheticConfig(**kw), value_format="f16")
    port = synthetic.generate_collection(synthetic.SyntheticConfig(**kw), value_format="f16")
    Q = np.stack([port.query_dense(i) for i in range(port.n_queries)])
    return ref, port, Q


def _raises_like_reference(ref_fwd, port_fwd, Q, **cfg):
    """Both packages raise ValueError with the same ``jax.lax.top_k``
    message (the axis and k it names are the same)."""
    with pytest.raises(ValueError, match="k argument to top_k") as want:
        ref_api.Retriever.build(ref_fwd, ref_api.RetrieverConfig(backend="jnp", **cfg)).search(Q)
    for backend in ("torch", "cuda"):
        r = api.Retriever.build(port_fwd, api.RetrieverConfig(backend=backend, **cfg),
                                device="cpu")
        with pytest.raises(ValueError, match="k argument to top_k") as got:
            r.search(Q)
        assert str(got.value) == str(want.value)


def test_c1_seismic_k_above_candidates_raises(c1_collection):
    ref, port, Q = c1_collection
    _raises_like_reference(ref.fwd, port.fwd, Q, engine="seismic", k=50, params=dict(
        cut=3, block_budget=100, n_probe=5, block_size=8))


def test_c1_seismic_n_probe_above_budget_raises(c1_collection):
    ref, port, Q = c1_collection
    _raises_like_reference(ref.fwd, port.fwd, Q, engine="seismic", params=dict(
        n_probe=30, block_budget=8, block_size=8))


def test_c1_flat_k_above_rows_raises(c1_collection):
    ref, port, Q = c1_collection
    _raises_like_reference(ref.fwd.slice(0, 20), port.fwd.slice(0, 20), Q, engine="flat", k=25)
    # k = N + 1 takes every row, the sentinel last
    r = api.Retriever.build(port.fwd.slice(0, 20), api.RetrieverConfig(engine="flat", k=21),
                            device="cpu")
    ids, scores = r.search(Q)
    assert ids.shape == (len(Q), 21) and torch.all(ids[:, -1] == 20)
    assert torch.all(torch.isinf(scores[:, -1]))
