"""kimi-k2-1t-a32b — Kimi K2: trillion-param MoE, 32B active.

61L d_model=7168 64H (GQA kv=8) d_ff=2048/expert vocab=163840,
MoE 384 experts top-8 (+1 shared expert per public spec).
[arXiv:2501.kimi2; unverified — paper-table config]

Adafactor (factored second moment, bf16 state) + bf16 params, as in the
reference: AdamW's f32 m and v alone would take 8 TB (1.03T parameters ×
8 bytes) before params and activations.
"""

import torch

from ..models.moe import MoEConfig
from ..models.transformer import TransformerConfig
from ..train.optimizer import OptimizerConfig

from .base import LMArch

ARCH = LMArch(
    name="kimi-k2-1t-a32b",
    cfg=TransformerConfig(
        name="kimi-k2-1t-a32b",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        d_head=112,  # 7168 / 64
        d_ff=2048,
        vocab=163840,
        moe=MoEConfig(
            n_experts=384, top_k=8, d_model=7168, d_ff=2048, n_shared_experts=1
        ),
        dtype=torch.bfloat16,
    ),
    optimizer=OptimizerConfig(
        name="adafactor",
        lr=2e-4,
        warmup_steps=2000,
        total_steps=500_000,
        state_dtype=torch.bfloat16,
    ),
    microbatches=8,  # grad accumulation: activations / 8 per microbatch
    smoke_cfg=TransformerConfig(
        name="kimi-smoke",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_head=8,
        d_ff=32,
        vocab=256,
        moe=MoEConfig(n_experts=8, top_k=2, d_model=64, d_ff=32, n_shared_experts=1),
        dtype=torch.float32,
    ),
)
