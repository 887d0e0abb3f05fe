"""deepseek-coder-33b — deep llama-architecture dense code LM.

62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256.
[arXiv:2401.14196; hf]
"""

import torch

from ..models.transformer import TransformerConfig
from ..train.optimizer import OptimizerConfig

from .base import LMArch

ARCH = LMArch(
    name="deepseek-coder-33b",
    cfg=TransformerConfig(
        name="deepseek-coder-33b",
        n_layers=62,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_head=128,
        d_ff=19200,
        vocab=32256,
        dtype=torch.bfloat16,
    ),
    optimizer=OptimizerConfig(name="adamw", lr=2e-4, warmup_steps=2000, total_steps=500_000),
    microbatches=16,
    smoke_cfg=TransformerConfig(
        name="dsc-smoke",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_ff=160,
        vocab=256,
        dtype=torch.float32,
    ),
)
