#!/usr/bin/env python
"""Parity gate of the PyTorch port against the JAX reference: every
engine × row codec × value codec of ``repro_torch`` serving artifacts
the reference saved.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/torch_parity.py [--device cpu|cuda]

Builds one SPLADE-statistics collection with the reference (``--n-docs``
160 at ``--dim`` 2,048, ``--n-queries`` 6, seed 4: the port tests'
fixture), one reference host index per engine (Seismic at a budget
that is not exhaustive, hnsw with the tests' graph parameters), and for
every engine, codec and vq a reference ``Retriever`` that it saves. The
port opens each artifact (``open_retriever``) on ``--device`` with
``backend="cuda"`` (the CUDA rows kernel on the card; its plain version
on the CPU) and ``"torch"``, and its top-k is held against the
reference's ``open_retriever(path).search(Q)`` on the same artifact:
ids equal and scores within rtol 1e-5 / atol 1e-4 (the port tests'
tolerances: the same f32 products summed in another order). On the card
an id may differ only where the two reference scores it swaps are tied
within rtol 1e-5 (counted as a tied swap). Exits non-zero at the first
mismatch. It imports the reference, and so jax, to compare against it;
the reference always runs on the host's CPU.
"""

from __future__ import annotations

import argparse
import sys
import tempfile

import numpy as np

RTOL, ATOL, TIE_RTOL = 1e-5, 1e-4, 1e-5
PARAMS = {
    "seismic": dict(cut=4, block_budget=64, n_probe=6, n_postings=60, block_size=8),
    "hnsw": dict(beam=16, iters=16, n_seeds=4, m=8, ef_construction=24),
    "flat": {},
}


def hold(label: str, ids, scores, want_ids, want_scores, tie_aware: bool) -> int:
    """Ids equal (up to tied swaps where ``tie_aware``) and scores close →
    the tied swaps; raises ``AssertionError`` with ``label`` otherwise."""
    diff = ids != want_ids
    if diff.any():
        tied = tie_aware and np.allclose(scores[diff], want_scores[diff], rtol=TIE_RTOL, atol=0)
        if not tied:
            raise AssertionError(f"{label}: top-k ids differ from the reference's")
    np.testing.assert_allclose(scores, want_scores, rtol=RTOL, atol=ATOL, err_msg=label)
    return int(diff.sum())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cpu", help="the port's device: cpu or cuda")
    ap.add_argument("--n-docs", type=int, default=160)
    ap.add_argument("--dim", type=int, default=2048)
    ap.add_argument("--n-queries", type=int, default=6)
    ap.add_argument("--seed", type=int, default=4)
    args = ap.parse_args(argv)

    import torch
    from repro.core.layout import available_layouts
    from repro.core.values import VALUE_CODECS
    from repro.data import synthetic as ref_synthetic
    from repro.serve import api as ref_api
    from repro_torch.serve import api

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("torch_parity: no CUDA device", file=sys.stderr)
        return 2
    col = ref_synthetic.generate_collection(ref_synthetic.SyntheticConfig(
        name="splade", dim=args.dim, n_docs=args.n_docs, n_queries=args.n_queries,
        seed=args.seed), value_format="f16")
    Q = np.stack([col.query_dense(i) for i in range(col.n_queries)])
    hosts = {e: ref_api.get_engine(e).host_index(col.fwd, ref_api.RetrieverConfig(
        engine=e, params=PARAMS[e])) for e in ("seismic", "hnsw")}
    n, swaps = 0, 0
    with tempfile.TemporaryDirectory() as tmp:
        for engine in ("seismic", "hnsw", "flat"):
            for codec in available_layouts():
                for vq in VALUE_CODECS:
                    label = f"{engine}/{codec}/{vq}"
                    cfg = ref_api.RetrieverConfig(engine=engine, codec=codec, vq=vq, k=10,
                                                  backend="jnp", params=PARAMS[engine])
                    ref = (ref_api.Retriever.from_host_index(hosts[engine], cfg)
                           if engine in hosts else ref_api.Retriever.build(col.fwd, cfg))
                    path = f"{tmp}/{engine}-{codec}-{vq}"
                    ref.save(path)
                    want_ids, want_scores = (np.asarray(a) for a in
                                             ref_api.open_retriever(path).search(Q))
                    port = api.open_retriever(path, device=device)
                    for backend in ("cuda", "torch"):
                        r = api.Retriever(port.cfg.replace(backend=backend), port.arrays,
                                          n_docs=port.n_docs, dim=port.dim,
                                          value_scale=port.value_scale,
                                          value_format=port.value_format, device=device)
                        ids, scores = (t.cpu().numpy() for t in r.search(Q))
                        try:
                            swaps += hold(f"{label} backend={backend}", ids, scores, want_ids,
                                          want_scores, tie_aware=device.type == "cuda")
                        except AssertionError as e:
                            print(f"MISMATCH {e}", file=sys.stderr)
                            return 1
                        n += 1
                    print(f"{label}: ids == reference on backends cuda and torch ({device})")
    print(f"torch_parity OK: {n} engine x codec x vq x backend cases on {device}, "
          f"{swaps} tied swaps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
