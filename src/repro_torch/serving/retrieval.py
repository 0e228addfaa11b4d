"""ASH-compressed candidate retrieval as a serving feature.

Counterpart of ``repro.serving.retrieval``.  A candidate catalog is
encoded ONCE offline; per request the user-state vectors score every
candidate through the fused asymmetric scan (the CUDA kernels on the
card, their plain versions on the CPU), followed by top-k.  The payload
is 32D/(bd)x smaller than the fp32 table, and the scan reads packed
codes only.

Requests route through the micro-batching :class:`QueryEngine`: one
engine per index (cached on it), so repeated user vectors hit the prep
cache and request shapes collapse onto the engine's buckets.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import ASHConfig
from repro_torch.index import AshIndex
from repro_torch.serving.engine import QueryEngine


def build_index(
    gen: torch.Generator,
    embeddings: torch.Tensor,  # (n_items, e)
    *,
    bits: int = 4,
    reduce: int = 1,
    n_landmarks: int = 16,
    learned: bool = True,
    backend: str = "flat",
    metric: str = "dot",
    device="cuda",
) -> AshIndex:
    """Compress a candidate catalog into a searchable ``AshIndex`` on
    ``device``."""
    e = embeddings.shape[1]
    cfg = ASHConfig(b=bits, d=e // reduce, n_landmarks=n_landmarks)
    return AshIndex.build(
        gen, embeddings, cfg, backend=backend, metric=metric,
        learned=learned, device=device,
    )


def engine_for(index: AshIndex, **overrides) -> QueryEngine:
    """The (cached) serving engine fronting ``index``.  Overrides only
    apply on first construction for a given index.

    Cached on the index instance itself so the engine (and its prep
    cache) lives exactly as long as the index it fronts.  The default
    bucket ladder is power-of-two dense: synchronous one-shot callers
    with power-of-two batch sizes (the common recsys request shapes)
    pad by at most 2x and usually not at all.
    """
    engine = getattr(index, "_serving_engine", None)
    if engine is None:
        overrides.setdefault("batch_buckets", (8, 16, 32, 64, 128))
        engine = QueryEngine(index, **overrides)
        index._serving_engine = engine
    return engine


def serve_topk(
    index: AshIndex,
    user_vecs,  # (B, e)
    k: int = 10,
    use_kernel: bool = True,
    *,
    engine: QueryEngine | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k ASH MIPS through the engine's fused scoring path
    (``use_kernel=False``: the kernels' plain versions).  Returns CPU
    tensors of scores and ids, each (B, k)."""
    eng = engine if engine is not None else engine_for(index)
    return eng.search(user_vecs, k=k, use_kernel=use_kernel)


def sasrec_retrieve(params, seq, index: AshIndex, cfg, k: int = 10, *,
                    engine: QueryEngine | None = None):
    """End-to-end SASRec next-item retrieval over the compressed
    catalog: user sequences (B, S) -> user states (on the parameters'
    device, no autograd) -> engine-batched ASH MIPS.  Returns CPU
    tensors of scores and ids, each (B, k)."""
    from repro_torch.models import sasrec as SR

    with torch.no_grad():
        u = SR.user_state(params, torch.as_tensor(seq).to(
            params["item_emb"].device), cfg)
    return serve_topk(index, u, k=k, engine=engine)
