"""Serving layer of the port (counterpart of ``repro.serving``): the
micro-batching engine, its frontend, background compaction and
catalog retrieval.  The write-ahead log (``wal``) comes with
durability, ROADMAP item 10."""
from repro_torch.serving import cache, compactor, engine, frontend, retrieval
from repro_torch.serving.cache import ByteLRU
from repro_torch.serving.compactor import BackgroundCompactor
from repro_torch.serving.engine import (
    EngineConfig, EngineStats, MutationTicket, QueryEngine, RequestStats,
    Ticket,
)
from repro_torch.serving.frontend import (
    FrontendClosed, FrontendConfig, ServingFrontend,
)

__all__ = [
    "cache", "compactor", "engine", "frontend", "retrieval",
    "BackgroundCompactor", "ByteLRU", "EngineConfig", "EngineStats",
    "FrontendClosed", "FrontendConfig", "MutationTicket", "QueryEngine",
    "RequestStats", "ServingFrontend", "Ticket",
]
