"""Synthetic collections (numpy)."""
