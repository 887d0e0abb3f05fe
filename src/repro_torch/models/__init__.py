"""Models of the port: the SPLADE encoder and the building blocks it
uses (``repro/models``' counterparts)."""
