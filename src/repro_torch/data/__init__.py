"""Synthetic data for the port (embedding sets; LM token, click and
sequence streams) and graphs (generation, neighbor sampling, batches of
small molecules)."""
from repro_torch.data import graphs, synthetic

__all__ = ["graphs", "synthetic"]
