"""Built-in engine registrations for ``repro_torch.serve.api``: the
inverted-index ``seismic`` two-phase probe, the graph-based ``hnsw``
beam search and the exact ``flat`` full scan (the recall oracle).
``api.get_engine`` imports this package lazily."""

from . import flat, hnsw, seismic  # noqa: F401

__all__ = ["seismic", "hnsw", "flat"]
