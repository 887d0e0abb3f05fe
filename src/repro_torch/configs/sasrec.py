"""sasrec — Self-Attentive Sequential Recommendation (Kang & McAuley,
ICDM 2018).

embed_dim=50, 2 blocks, 1 head, seq_len=50, self-attention over the
user's item sequence; 10⁶-item embedding table row-sharded.
[arXiv:1808.09781; paper]
"""

from ..models.recsys import SASRecConfig
from ..train.optimizer import OptimizerConfig

from .base import RecsysArch

ARCH = RecsysArch(
    name="sasrec",
    cfg=SASRecConfig(
        n_items=1_000_000, embed_dim=50, n_blocks=2, n_heads=1, seq_len=50,
        n_negatives=128,
    ),
    optimizer=OptimizerConfig(name="adamw", lr=1e-3, warmup_steps=100, total_steps=100_000),
    smoke_cfg=SASRecConfig(n_items=512, embed_dim=16, n_blocks=2, n_heads=1, seq_len=12,
                           n_negatives=4),
)
