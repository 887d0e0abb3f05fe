"""din — Deep Interest Network (Zhou et al., KDD 2018).

embed_dim=18, history seq_len=100, target-attention MLP 80-40, final
MLP 200-80. [arXiv:1706.06978; paper]
"""

from ..models.recsys import DINConfig
from ..train.optimizer import OptimizerConfig

from .base import RecsysArch

ARCH = RecsysArch(
    name="din",
    cfg=DINConfig(
        n_items=1_000_000, embed_dim=18, seq_len=100, attn_mlp=(80, 40), mlp=(200, 80)
    ),
    optimizer=OptimizerConfig(name="adamw", lr=1e-3, warmup_steps=100, total_steps=100_000),
    smoke_cfg=DINConfig(n_items=512, embed_dim=8, seq_len=10, attn_mlp=(16, 8), mlp=(32, 16)),
)
