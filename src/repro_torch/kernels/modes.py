"""The scoring backend axis — the port's counterpart of
``repro/kernels/modes.py`` and ``repro/kernels/registry.py``.

* ``"torch"`` — the plain torch path (``core/scoring.py``), on whatever
  device the tensors live on;
* ``"cuda"`` — the hand-written kernel of the codec
  (``kernels/rows_dot.py``). On CPU tensors its wrapper runs the
  kernel's plain version; on CUDA tensors it launches the kernel or
  raises. Nothing falls back.

Artifacts keep the reference's backend names, so one artifact format
serves both packages: reading maps ``jnp`` → ``torch`` and every
``pallas*`` name → ``cuda``; writing maps them back.
"""

from __future__ import annotations

__all__ = [
    "BACKENDS",
    "check_backend",
    "backend_from_manifest",
    "backend_to_manifest",
]

#: values RetrieverConfig.backend / score_candidate_rows accept
BACKENDS = ("torch", "cuda")

_FROM_REFERENCE = {
    "jnp": "torch",
    "pallas": "cuda",
    "pallas_interpret": "cuda",
    "pallas_compiled": "cuda",
}
_TO_REFERENCE = {"torch": "jnp", "cuda": "pallas"}


def check_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; have {list(BACKENDS)}")
    return backend


def backend_from_manifest(name: str) -> str:
    """A reference backend name (as an artifact stores it) → the port's."""
    try:
        return _FROM_REFERENCE[name]
    except KeyError:
        raise ValueError(
            f"unknown artifact backend {name!r}; have {sorted(_FROM_REFERENCE)}"
        ) from None


def backend_to_manifest(backend: str) -> str:
    """The port's backend → the reference name an artifact stores."""
    return _TO_REFERENCE[check_backend(backend)]
