"""gat-cora — Graph Attention Network (Veličković et al., ICLR 2018).

2 layers, d_hidden=8, 8 heads, attention aggregator. d_in/n_classes
track the per-shape dataset (Cora / Reddit / ogbn-products / molecule).
[arXiv:1710.10903; paper]
"""

from .base import GNNArch

ARCH = GNNArch(name="gat-cora", n_layers=2, d_hidden=8, n_heads=8)
