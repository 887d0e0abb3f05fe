"""olmoe-1b-7b — OLMoE: 7B total / 1B active MoE LM.

16L d_model=2048 16H (GQA kv=16 ⇒ MHA) d_ff=1024/expert vocab=50304,
MoE 64 experts top-8.  [arXiv:2409.02060; hf]
"""

import torch

from ..models.moe import MoEConfig
from ..models.transformer import TransformerConfig
from ..train.optimizer import OptimizerConfig

from .base import LMArch

ARCH = LMArch(
    name="olmoe-1b-7b",
    cfg=TransformerConfig(
        name="olmoe-1b-7b",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1024,
        vocab=50304,
        qk_norm=True,  # OLMoE uses QK-norm
        moe=MoEConfig(n_experts=64, top_k=8, d_model=2048, d_ff=1024),
        dtype=torch.bfloat16,
    ),
    optimizer=OptimizerConfig(name="adamw", lr=4e-4, warmup_steps=2000, total_steps=500_000),
    microbatches=8,
    smoke_cfg=TransformerConfig(
        name="olmoe-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=32,
        vocab=256,
        qk_norm=True,
        moe=MoEConfig(n_experts=8, top_k=2, d_model=64, d_ff=32),
        dtype=torch.float32,
    ),
)
