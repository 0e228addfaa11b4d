"""ASH core over torch tensors (counterpart of ``repro.core``)."""
from repro_torch.core.types import (
    ASHConfig, ASHModel, ASHPayload, ASHStats, CoarseCodes,
    CoarseQueryPrep, QueryPrep,
)
from repro_torch.core import quantization
from repro_torch.core import learning
from repro_torch.core import ash
from repro_torch.core import scoring
from repro_torch.core.ash import train, encode, decode, random_model
from repro_torch.core.scoring import (
    coarse_codes,
    payload_stats,
    prepare_coarse_queries,
    prepare_queries,
    score_dot,
    score_dot_1bit,
    score_l2,
    score_cosine,
    score_symmetric_dot,
)

__all__ = [
    "ASHConfig", "ASHModel", "ASHPayload", "ASHStats", "CoarseCodes",
    "CoarseQueryPrep", "QueryPrep",
    "quantization", "learning", "ash", "scoring",
    "train", "encode", "decode", "random_model",
    "coarse_codes", "payload_stats", "prepare_coarse_queries",
    "prepare_queries", "score_dot", "score_dot_1bit",
    "score_l2", "score_cosine", "score_symmetric_dot",
]
