"""The plain reference: every document's exact score for a query, from
the benchmark's own corpus, in float64 — and the control, the same
scores from bfloat16 inputs summed in float32.

Plain PyTorch on whatever device the corpus lies on: the corpus as a
CSR matrix ``[n_docs, dim]`` times the dense queries (``torch.sparse.mm``).
It imports nothing of the program and takes nothing the program made.
"""

from __future__ import annotations

import warnings

import torch

__all__ = ["Reference"]

#: elements of the [block, n_docs] score matrix one block of queries holds
_BLOCK_ELEMS = 1 << 28


class Reference:
    """Exact scores over a corpus (``comps``, ``vals``, ``offsets``,
    ``dim``). The reference sums in float64. ``control=True`` is the step
    below the configuration's precision (f16 values, f32 scoring): the
    stored values and the queries rounded to bfloat16, summed in float32."""

    def __init__(self, comps, vals, offsets, dim: int, *, control: bool = False):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.control = control
        self.dtype = torch.float32 if control else torch.float64
        index = torch.int32 if offsets[-1] < 2**31 else torch.int64
        self.n_docs = offsets.shape[0] - 1
        self.dim = int(dim)
        v = vals.to(torch.bfloat16) if control else vals
        with warnings.catch_warnings():  # "sparse CSR support is in beta"
            warnings.simplefilter("ignore", UserWarning)
            self.csr = torch.sparse_csr_tensor(offsets.to(index), comps.to(index),
                                               v.to(self.dtype), size=(self.n_docs, self.dim),
                                               check_invariants=False)

    @property
    def block_rows(self) -> int:
        """Queries scored together: their scores hold ≤ 2**28 elements."""
        return max(1, _BLOCK_ELEMS // max(self.n_docs, 1))

    def scores(self, Q: torch.Tensor) -> torch.Tensor:
        """Dense queries f32 [nq, dim] → every document's score [nq,
        n_docs] (f64; f32 for the control)."""
        if self.control:
            Q = Q.to(torch.bfloat16)
        return torch.sparse.mm(self.csr, Q.to(self.dtype).t().contiguous()).t()
