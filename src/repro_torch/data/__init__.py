"""Synthetic data for the port (embedding sets, LM token streams)."""
from repro_torch.data import synthetic

__all__ = ["synthetic"]
