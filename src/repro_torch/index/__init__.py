"""ANN index over ASH payloads (flat and IVF backends of ``repro.index``)."""
from repro_torch.index import common, flat, ivf, metrics
from repro_torch.index.api import (
    AshIndex, CorruptIndexError, available_backends, register_backend,
)
from repro_torch.index.metrics import exact_topk, recall_at, recall_curve

__all__ = ["AshIndex", "CorruptIndexError", "available_backends",
           "register_backend", "common", "flat", "ivf", "metrics",
           "exact_topk", "recall_at", "recall_curve"]
