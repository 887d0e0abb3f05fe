"""deepfm — DeepFM CTR model (Guo et al., IJCAI 2017).

39 sparse fields, embed_dim=10, MLP 400-400-400, FM interaction.
Criteo-scale heterogeneous vocabularies (~20.6M total rows) exercise the
row-sharded embedding path.  [arXiv:1703.04247; paper]
"""

from ..models.recsys import DeepFMConfig
from ..train.optimizer import OptimizerConfig

from .base import RecsysArch

_VOCABS = (
    (10_000_000, 4_000_000, 2_000_000, 1_000_000)
    + (500_000,) * 5
    + (100_000,) * 10
    + (10_000,) * 10
    + (1_000,) * 10
)
assert len(_VOCABS) == 39

ARCH = RecsysArch(
    name="deepfm",
    cfg=DeepFMConfig(vocab_sizes=_VOCABS, embed_dim=10, mlp=(400, 400, 400)),
    optimizer=OptimizerConfig(name="adamw", lr=1e-3, warmup_steps=100, total_steps=100_000),
    smoke_cfg=DeepFMConfig(vocab_sizes=(64,) * 39, embed_dim=4, mlp=(16, 16, 16)),
)
