"""dcn-v2 — Deep & Cross Network v2 (Wang et al., WWW 2021).

13 dense + 26 sparse fields, embed_dim=16, 3 full-matrix cross layers,
MLP 1024-1024-512 (stacked). [arXiv:2008.13535; paper]
"""

from ..models.recsys import DCNv2Config
from ..train.optimizer import OptimizerConfig

from .base import RecsysArch

_VOCABS = (
    (10_000_000, 4_000_000, 2_000_000, 1_000_000)
    + (500_000,) * 4
    + (100_000,) * 8
    + (10_000,) * 10
)
assert len(_VOCABS) == 26

ARCH = RecsysArch(
    name="dcn-v2",
    cfg=DCNv2Config(
        vocab_sizes=_VOCABS, embed_dim=16, n_cross_layers=3, mlp=(1024, 1024, 512)
    ),
    optimizer=OptimizerConfig(name="adamw", lr=1e-3, warmup_steps=100, total_steps=100_000),
    smoke_cfg=DCNv2Config(vocab_sizes=(64,) * 26, embed_dim=4, n_cross_layers=2, mlp=(16, 16)),
)
