"""Serving layer of the port (counterpart of ``repro.serving``): the
micro-batching engine, its frontend, background compaction, catalog
retrieval, and durability (the mutation write-ahead log and
``DurableIndex`` crash recovery)."""
from repro_torch.serving import (
    cache, compactor, engine, frontend, retrieval, wal,
)
from repro_torch.serving.cache import ByteLRU
from repro_torch.serving.compactor import BackgroundCompactor
from repro_torch.serving.engine import (
    EngineConfig, EngineStats, MutationTicket, QueryEngine, RequestStats,
    Ticket,
)
from repro_torch.serving.frontend import (
    FrontendClosed, FrontendConfig, ServingFrontend,
)
from repro_torch.serving.wal import (
    DurableIndex, RecoveryReport, WriteAheadLog,
)

__all__ = [
    "cache", "compactor", "engine", "frontend", "retrieval", "wal",
    "BackgroundCompactor", "ByteLRU", "DurableIndex", "EngineConfig",
    "EngineStats", "FrontendClosed", "FrontendConfig", "MutationTicket",
    "QueryEngine", "RecoveryReport", "RequestStats", "ServingFrontend",
    "Ticket", "WriteAheadLog",
]
