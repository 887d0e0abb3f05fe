"""Built-in engine registrations for ``repro_torch.serve.api``: the
inverted-index ``seismic`` two-phase probe and the exact ``flat`` full
scan (the recall oracle). ``hnsw`` is ROADMAP queue A3's next engine.
``api.get_engine`` imports this package lazily."""

from . import flat, seismic  # noqa: F401

__all__ = ["seismic", "flat"]
