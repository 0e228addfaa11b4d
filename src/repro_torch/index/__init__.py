"""ANN index over ASH payloads: the flat, IVF, sharded and tiered IVF
backends of ``repro.index``."""
from repro_torch.index import common, distributed, flat, ivf, metrics
from repro_torch.index.api import (
    AshIndex, CorruptIndexError, available_backends, register_backend,
)
from repro_torch.index import tiered  # registers backend="tiered_ivf"
from repro_torch.index.metrics import exact_topk, recall_at, recall_curve

__all__ = ["AshIndex", "CorruptIndexError", "available_backends",
           "register_backend", "common", "distributed", "flat", "ivf",
           "metrics", "tiered", "exact_topk", "recall_at", "recall_curve"]
