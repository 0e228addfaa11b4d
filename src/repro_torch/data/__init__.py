"""Synthetic data for the port (embedding sets)."""
from repro_torch.data import synthetic

__all__ = ["synthetic"]
