"""Forward-index components codecs (paper §2) — the parts the row
layout needs: the d-gap transforms and DotVByte's control bits."""

from .base import components_from_gaps, gaps_from_components
from .dotvbyte import control_bits

__all__ = ["components_from_gaps", "gaps_from_components", "control_bits"]
