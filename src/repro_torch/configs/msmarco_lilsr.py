"""msmarco-lilsr — the paper's inference-free encoder workload.

LILSR (Nardini et al., SIGIR 2025): no query expansion (6 nnz/query)
but 3.2× heavier document expansion (387 nnz/doc) — the compression
stress case in Table 2.
"""

from .retrieval import RetrievalArch

ARCH = RetrievalArch(
    name="msmarco-lilsr",
    dim=30522,
    n_docs=8_842_240,  # 8,841,823 MsMarco passages, padded to /512
    doc_nnz=387,
    query_nnz=6,
    l_max=768,
)
