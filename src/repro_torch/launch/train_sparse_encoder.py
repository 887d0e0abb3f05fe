"""End-to-end training run — the port of
``examples/train_sparse_encoder.py``: train the SPLADE-style sparse
encoder with the fault-tolerant runner, encode a corpus, build the
forward index and Seismic, and measure recall.

    python -m repro_torch.launch.train_sparse_encoder --device cpu --steps 200

Defaults are CPU-sized (vocab 4096, 4 layers, d 128); ``--full`` selects
the reference's full configuration (vocab 30522, 8 layers, d 512: 40.9M
parameters). Runs on ``cuda`` unless ``--device cpu`` (no GPU and no
``--device cpu`` raises). ``--checkpoint-dir`` keeps the runner's
checkpoints (default: a temporary directory, removed at exit).

Lines printed, in the reference example's form: the parameter count,
the loss over the run, the corpus' learned nnz/doc, the DotVByte
bits/comp, and the host Seismic search's recall@10 with DotVByte
rescoring (``n_postings=800``, ``block_size=32``, ``heap_factor=0.9``,
``cut=8``). Then the same queries go through ``Retriever`` for the flat
and Seismic engines (codec dotvbyte; on the card the rows kernel, on the
CPU its plain torch version), one recall line each.

The topic stream is the example's (matching pairs draw tokens from one
topic's vocabulary slice), drawn with numpy from ``(seed, step)``:
``jax.random`` bits cannot be reproduced, so the batches, the weights
and the numbers differ from the reference's run.
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from .. import resolve_device
from ..core.forward_index import ForwardIndex
from ..core.seismic import SeismicIndex, SeismicParams, exact_top_k, recall_at_k
from ..models.common import count_params
from ..models.sparse_encoder import SparseEncoderConfig, contrastive_loss, encode, encoder_init
from ..serve.api import Retriever, RetrieverConfig
from ..train.elastic import Runner, RunnerConfig
from ..train.optimizer import OptimizerConfig, make_optimizer
from ..train.train_step import init_train_state, make_train_step

__all__ = ["synth_pairs", "small_config", "encode_corpus", "main"]

#: the Seismic build and host search of the example's recall line
SEISMIC_BUILD = dict(n_postings=800, block_size=32)
SEISMIC_SEARCH = dict(heap_factor=0.9, cut=8, codec="dotvbyte")


def small_config() -> SparseEncoderConfig:
    """The example's CPU-sized configuration."""
    return SparseEncoderConfig(vocab=4096, n_layers=4, d_model=128, n_heads=4,
                               d_ff=512, max_len=32, flops_lambda=3e-4)


def synth_pairs(seed: int, step: int, cfg: SparseEncoderConfig, *, batch: int = 16,
                seq: int = 24, n_topics: int = 64, device=None):
    """Deterministic (query, doc) token pairs sharing a latent topic:
    tokens come from a topic's vocabulary slice, so matching pairs share
    vocabulary — the signal the contrastive loss learns."""
    rng = np.random.default_rng([seed, step])
    topic = rng.integers(0, n_topics, size=batch)
    width = cfg.vocab // n_topics
    lo = topic[:, None] * width

    def draw(length):
        return torch.from_numpy(lo + rng.integers(0, width, size=(batch, length))).to(device)

    mask = torch.ones((batch, seq), dtype=torch.bool, device=device)
    return {"q_tokens": draw(seq), "q_mask": mask, "d_tokens": draw(seq), "d_mask": mask}


@torch.inference_mode()
def encode_corpus(params, cfg, seed: int, n_batches: int, n_query_batches: int, device):
    """Docs of the stream's batches ``10_000 + i`` as ``(components,
    values)`` pairs (an empty embedding keeps component 0, as in the
    example), and the queries of the first ``n_query_batches`` batches
    as dense f32 rows."""
    docs, queries = [], []
    for i in range(n_batches):
        b = synth_pairs(seed, 10_000 + i, cfg, device=device)
        d_emb = encode(params, cfg, b["d_tokens"], b["d_mask"]).cpu().numpy()
        for row in d_emb:
            c = np.flatnonzero(row).astype(np.uint32)
            if len(c) == 0:
                c = np.array([0], np.uint32)
            docs.append((c, row[c]))
        if i < n_query_batches:
            queries.extend(encode(params, cfg, b["q_tokens"], b["q_mask"]).cpu().numpy())
    return docs, np.stack(queries) if queries else np.zeros((0, cfg.vocab), np.float32)


def _train(cfg, args, device, ckpt_dir):
    params = encoder_init(torch.Generator().manual_seed(args.seed), cfg, device=device)
    print(f"encoder params: {count_params(params) / 1e6:.1f}M")
    oinit, oupd = make_optimizer(OptimizerConfig(lr=1e-3, warmup_steps=20,
                                                 total_steps=args.steps))
    step = make_train_step(lambda p, b: contrastive_loss(p, cfg, b), oupd)
    runner = Runner(
        RunnerConfig(total_steps=args.steps, checkpoint_dir=ckpt_dir, checkpoint_every=50),
        step, lambda i: synth_pairs(args.seed, i, cfg, device=device),
        init_train_state(params, oinit), device=device,
    )
    state, hist = runner.run()
    print(f"loss {hist[0]['loss']:.3f} → {hist[-1]['loss']:.3f} over {len(hist)} steps")
    return state


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full", action="store_true", help="the full 40.9M-parameter configuration")
    ap.add_argument("--n-docs", type=int, default=1500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="keep the runner's checkpoints here (default: a temporary directory)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = SparseEncoderConfig() if args.full else small_config()

    if args.checkpoint_dir is None:
        with tempfile.TemporaryDirectory() as ckpt_dir:
            state = _train(cfg, args, device, ckpt_dir)
    else:
        state = _train(cfg, args, device, args.checkpoint_dir)

    # --- encode a corpus and retrieve through the compressed index -------
    print("encoding corpus + queries…")
    docs, queries = encode_corpus(state["params"], cfg, args.seed, args.n_docs // 16, 2, device)
    fwd = ForwardIndex.from_docs(docs, cfg.vocab, value_format="f16")
    nnz = fwd.total_nnz / fwd.n_docs
    print(f"corpus: {fwd.n_docs} docs, learned sparsity {nnz:.0f} nnz/doc")
    comp_c = fwd.storage_bytes("dotvbyte")["components"]
    comp_u = fwd.storage_bytes("uncompressed")["components"]
    print(f"forward index components: {comp_u / 2**10:.0f} KiB raw → "
          f"{comp_c / 2**10:.0f} KiB DotVByte ({8 * comp_c / max(fwd.total_nnz, 1):.1f} bits/comp)")

    index = SeismicIndex.build(fwd, SeismicParams(**SEISMIC_BUILD))
    index.prepare_codec("dotvbyte")
    truth = [exact_top_k(fwd, q, 10)[0] for q in queries]
    recs = [recall_at_k(t, index.search(q, k=10, **SEISMIC_SEARCH)[0])
            for t, q in zip(truth, queries)]
    print(f"Seismic recall@10 with DotVByte rescoring: {np.mean(recs):.3f}")

    backend = "cuda" if device.type == "cuda" else "torch"
    retrievers = {
        "flat": Retriever.build(
            fwd, RetrieverConfig(engine="flat", codec="dotvbyte", backend=backend), device=device),
        "seismic": Retriever.from_host_index(
            index, RetrieverConfig(engine="seismic", codec="dotvbyte", backend=backend,
                                   params=SEISMIC_BUILD), device=device),
    }
    for name, ret in retrievers.items():
        ids = ret.search(queries)[0].cpu().numpy()
        rec = np.mean([recall_at_k(t, got) for t, got in zip(truth, ids)])
        print(f"Retriever {name} (dotvbyte, backend={backend}) recall@10: {rec:.3f}")


if __name__ == "__main__":
    main()
