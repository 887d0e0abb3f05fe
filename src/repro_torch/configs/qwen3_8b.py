"""qwen3-8b — dense LM with QK-norm and GQA.

36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936.
[hf:Qwen/Qwen3-8B; hf]
"""

import torch

from ..models.transformer import TransformerConfig
from ..train.optimizer import OptimizerConfig

from .base import LMArch

ARCH = LMArch(
    name="qwen3-8b",
    cfg=TransformerConfig(
        name="qwen3-8b",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=12288,
        vocab=151936,
        qk_norm=True,
        rope_theta=1_000_000.0,
        dtype=torch.bfloat16,
    ),
    optimizer=OptimizerConfig(name="adamw", lr=3e-4, warmup_steps=2000, total_steps=500_000),
    microbatches=8,
    smoke_cfg=TransformerConfig(
        name="qwen3-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        qk_norm=True,
        dtype=torch.float32,
    ),
)
