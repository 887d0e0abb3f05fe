"""SPLADE-style learned sparse encoder (Formal et al., SIGIR 2022) — the
port of ``repro/models/sparse_encoder.py``.

The model that produces the embeddings the forward index stores: a
bidirectional transformer encoder whose MLM head is pooled as

    s = max_over_tokens( log(1 + relu(logits)) )        [vocab]

giving a sparse non-negative vocabulary-grounded vector, trained with an
in-batch-negative contrastive loss plus SPLADE's FLOPS regulariser.

Parameters are the reference's tree as nested dicts of tensors, under
its names, with the layers stacked ``[L, …]`` (``embed``, ``pos``,
``layers.{attn_norm, ffn_norm, wq, wk, wv, wo, w_up, w_down}``,
``final_norm``, ``mlm_bias`` and, under ``quantize``, ``quant_hi``).
The stacking matters beyond naming: the optimizers decay every leaf of
two or more dimensions, so the stacked norms are decayed and
``final_norm`` is not, as in the reference. ``SparseEncoder`` holds the
same tree as an ``nn.Module``; ``params_from_jax`` / ``params_to_numpy``
carry trees across.

Where the two frameworks' gradients differ at ties, the port takes the
reference's rule: the PACT clip is ``minimum(maximum(·))`` (half the
gradient to each side at a tie, as ``jnp.clip``), pooling is ``amax``
(ties split evenly, as ``jnp.max``), GELU is the tanh form (``jax.nn.gelu``'s
default). The padding mask gates the pooling only: attention is
unmasked, as in the reference.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .. import resolve_device
from .common import embed_init, normal, params_from_jax, params_to_numpy, rms_norm
from .transformer import attention

__all__ = [
    "SparseEncoderConfig",
    "SparseEncoder",
    "encoder_init",
    "encode",
    "contrastive_loss",
    "fake_quantize",
    "export_quant_clip",
    "params_from_jax",
    "params_to_numpy",
]

LAYER_KEYS = ("attn_norm", "ffn_norm", "wq", "wk", "wv", "wo", "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class SparseEncoderConfig:
    name: str = "sparse-encoder"
    vocab: int = 30522
    n_layers: int = 8
    d_model: int = 512
    n_heads: int = 8
    d_ff: int = 2048
    max_len: int = 128
    flops_lambda: float = 1e-3
    temperature: float = 0.05
    dtype: torch.dtype = torch.float32
    #: quantization-aware training: fake-quantize the pooled activations
    #: with a learnable PACT clip + straight-through rounding, on the grid
    #: the u8_sq/u4_sq serving codecs store
    quantize: bool = False
    quant_bits: int = 8
    quant_clip_init: float = 4.0  # log1p activations rarely exceed this

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def encoder_init(generator: torch.Generator, cfg: SparseEncoderConfig, *, device=None):
    """A fresh parameter tree on ``device`` (``cuda`` unless given), drawn
    from ``generator`` in the reference's order: embed, pos, wq, wk, wv,
    wo, w_up, w_down. A CPU generator gives the same tree on any device."""
    dev = resolve_device(device)
    L, D, V = cfg.n_layers, cfg.d_model, cfg.vocab

    def sd(a, b):
        return normal(generator, (L, a, b), (2.0 / (a + b)) ** 0.5, cfg.dtype, dev)

    embed = embed_init(generator, V, D, cfg.dtype, dev)
    pos = embed_init(generator, cfg.max_len, D, cfg.dtype, dev)
    params = {
        "embed": embed,
        "pos": pos,
        "layers": {
            "attn_norm": torch.ones((L, D), dtype=cfg.dtype, device=dev),
            "ffn_norm": torch.ones((L, D), dtype=cfg.dtype, device=dev),
            "wq": sd(D, D),
            "wk": sd(D, D),
            "wv": sd(D, D),
            "wo": sd(D, D),
            "w_up": sd(D, cfg.d_ff),
            "w_down": sd(cfg.d_ff, D),
        },
        "final_norm": torch.ones((D,), dtype=cfg.dtype, device=dev),
        "mlm_bias": torch.zeros((V,), dtype=cfg.dtype, device=dev),  # head tied to embed
    }
    if cfg.quantize:
        params["quant_hi"] = torch.tensor(cfg.quant_clip_init, dtype=torch.float32, device=dev)
    return params


def fake_quantize(acts: torch.Tensor, hi: torch.Tensor, bits: int) -> torch.Tensor:
    """PACT fake-quant with a straight-through estimator.

    Forward: clip to ``[0, hi]``, snap to the ``2**bits - 1``-level grid
    (the u8_sq/u4_sq serving grid with ``lo = 0``). Backward: the
    rounding is identity (STE), so gradients flow to the activations
    inside the clip and to ``hi`` through the clip boundary."""
    hi = torch.maximum(hi, hi.new_tensor(1e-6))  # keep the grid step finite
    maxcode = (1 << bits) - 1
    clipped = torch.minimum(torch.maximum(acts, acts.new_zeros(())), hi)
    step = hi / maxcode
    q = torch.round(clipped / step) * step
    return clipped + (q - clipped).detach()


def export_quant_clip(params, cfg: SparseEncoderConfig, storage_scale: float = 1.0):
    """Trained quantizer → the pack-time clip override ``(lo, hi)`` for
    ``layout.pack_rows(..., vq_clip=...)`` in STORAGE units (the learned
    range divided by the collection's ``value_format.scale``)."""
    if "quant_hi" not in params:
        raise ValueError(
            "params carry no quantizer; train with cfg.quantize=True"
        )
    hi = float(params["quant_hi"]) / float(storage_scale)
    return (0.0, hi)


def encode(params, cfg: SparseEncoderConfig, tokens: torch.Tensor, mask: torch.Tensor):
    """tokens int [B, S], mask bool [B, S] → sparse embeddings f32 [B, vocab]."""
    B, S = tokens.shape
    H, dh = cfg.n_heads, cfg.head_dim
    x = params["embed"][tokens] + params["pos"][None, :S]
    per_layer = {k: params["layers"][k].unbind(0) for k in LAYER_KEYS}
    for i in range(len(per_layer["wq"])):
        lp = {k: per_layer[k][i] for k in LAYER_KEYS}
        h = rms_norm(x, lp["attn_norm"])
        q = (h @ lp["wq"]).reshape(B, S, H, dh)
        k = (h @ lp["wk"]).reshape(B, S, H, dh)
        v = (h @ lp["wv"]).reshape(B, S, H, dh)
        a = attention(q, k, v, causal=False)  # bidirectional
        x = x + a.reshape(B, S, H * dh) @ lp["wo"]
        h = rms_norm(x, lp["ffn_norm"])
        x = x + F.gelu(h @ lp["w_up"], approximate="tanh") @ lp["w_down"]
    x = rms_norm(x, params["final_norm"])
    logits = x @ params["embed"].T + params["mlm_bias"]  # [B, S, V]
    acts = torch.log1p(torch.relu(logits.float()))
    acts = torch.where(mask[..., None], acts, 0.0)
    pooled = acts.amax(dim=1)  # SPLADE-max pooling → [B, V]
    if cfg.quantize:
        pooled = fake_quantize(pooled, params["quant_hi"], cfg.quant_bits)
    return pooled


def contrastive_loss(params, cfg: SparseEncoderConfig, batch):
    """In-batch negatives: query i ↔ doc i positive, others negative.
    → (loss, {contrastive_acc, nnz_query, nnz_doc})."""
    q = encode(params, cfg, batch["q_tokens"], batch["q_mask"])  # [B, V]
    d = encode(params, cfg, batch["d_tokens"], batch["d_mask"])  # [B, V]
    scores = (q @ d.T) / cfg.temperature  # [B, B]
    labels = torch.arange(q.shape[0], device=q.device)
    logz = torch.logsumexp(scores, dim=-1)
    nll = (logz - torch.diagonal(scores)).mean()
    # SPLADE FLOPS regulariser: (mean activation per vocab dim)², summed
    flops = torch.square(q.mean(dim=0)).sum() + torch.square(d.mean(dim=0)).sum()
    acc = (scores.argmax(dim=-1) == labels).float().mean()
    nnz_q = (q > 0).sum(dim=-1).float().mean()
    nnz_d = (d > 0).sum(dim=-1).float().mean()
    return nll + cfg.flops_lambda * flops, {
        "contrastive_acc": acc,
        "nnz_query": nnz_q,
        "nnz_doc": nnz_d,
    }


class SparseEncoder(torch.nn.Module):
    """The encoder as an ``nn.Module``: the reference's tree held as
    parameters under its names (``state_dict`` keys ``embed``,
    ``layers.wq``, …), its forward ``encode``. The functional API above
    works on ``tree()``, a view of the same storage."""

    def __init__(self, cfg: SparseEncoderConfig, params):
        super().__init__()
        self.cfg = cfg
        for name in ("embed", "pos", "final_norm", "mlm_bias", "quant_hi"):
            if name in params:
                self.register_parameter(name, torch.nn.Parameter(params[name]))
        self.layers = torch.nn.ParameterDict(
            {k: torch.nn.Parameter(v) for k, v in params["layers"].items()}
        )

    def tree(self) -> dict:
        out = {name: p for name, p in self.named_parameters() if "." not in name}
        out["layers"] = dict(self.layers.items())
        return out

    def forward(self, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return encode(self.tree(), self.cfg, tokens, mask)
