"""msmarco-splade — the paper's primary evaluation workload.

MsMarco passages (8.84M docs) encoded with SPLADE (Formal et al.):
119 nonzeros per document, 43 per query, vocab 30522 (§3 of the paper).
"""

from .retrieval import RetrievalArch

ARCH = RetrievalArch(
    name="msmarco-splade",
    dim=30522,
    n_docs=8_842_240,  # 8,841,823 MsMarco passages, padded to /512
    doc_nnz=119,
    query_nnz=43,
    l_max=384,
)
