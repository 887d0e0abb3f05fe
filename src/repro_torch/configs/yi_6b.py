"""yi-6b — llama-architecture dense LM with aggressive GQA.

32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
[arXiv:2403.04652; hf]
"""

import torch

from ..models.transformer import TransformerConfig
from ..train.optimizer import OptimizerConfig

from .base import LMArch

ARCH = LMArch(
    name="yi-6b",
    cfg=TransformerConfig(
        name="yi-6b",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=4,
        d_ff=11008,
        vocab=64000,
        dtype=torch.bfloat16,
    ),
    optimizer=OptimizerConfig(name="adamw", lr=3e-4, warmup_steps=2000, total_steps=500_000),
    microbatches=8,
    smoke_cfg=TransformerConfig(
        name="yi-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        dtype=torch.float32,
    ),
)
