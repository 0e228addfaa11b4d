"""Flat (exhaustive-scan) ASH index with optional exact re-ranking.

Counterpart of ``repro.index.flat``.  Entry point is
``repro_torch.index.AshIndex`` with ``backend="flat"``.  Every metric
scores through the scan kernels; the route (fused selection, or
materialize and sort, optionally behind the int8 coarse first pass) is
picked by ``common.execute_plan``.  Deletes tombstone rows in a
validity bitmap that reaches the fused kernels as their runtime mask
operand; ``_compact`` evicts them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core import ash as A
from repro_torch.core import scoring as S
from repro_torch.core.types import (
    ASHConfig, ASHModel, ASHPayload, ASHStats, CoarseCodes, QueryPrep,
)
from repro_torch.device import resolve_device
from repro_torch.index import common as C


@dataclasses.dataclass(frozen=True)
class FlatIndex:
    metric: str  # "dot" | "l2" | "cos"
    model: ASHModel
    payload: ASHPayload
    # bf16 raw vectors for exact re-ranking (None: compressed only)
    raw: Optional[torch.Tensor]
    # encode-time row statistics read by the l2/cos epilogues
    stats: Optional[ASHStats] = None
    # user id of each payload row (int32); None = identity
    ids: Optional[torch.Tensor] = None
    # row-validity bitmap, False = tombstoned; None = all rows live
    live: Optional[torch.Tensor] = None
    # id of the next added row once mutations set it (None = derived)
    next_id: Optional[int] = None
    # operands of the int8 coarse first pass (the scale-weighted code
    # mean; no value matrix): derived from the payload at build / add /
    # compact / load, never persisted
    coarse: Optional[CoarseCodes] = None


def _build(
    gen: torch.Generator,
    X: torch.Tensor,
    config: ASHConfig,
    *,
    metric: str = "dot",
    device="cuda",
    learned: bool = True,
    keep_raw: bool = False,
    model: Optional[ASHModel] = None,
    **train_kw,
) -> FlatIndex:
    C.validate_metric(metric)
    dev = resolve_device(device)
    X = X.to(dev)
    if model is None:
        if learned:
            model, _ = A.train(gen, X, config, device=dev, **train_kw)
        else:
            model = A.random_model(
                gen, X.shape[1], config, X_for_landmarks=X, device=dev
            )
    with tracing.span("build.encode"):
        payload = A.encode(model, X)
        return FlatIndex(
            metric=metric, model=model, payload=payload,
            raw=X.to(torch.bfloat16) if keep_raw else None,
            stats=S.payload_stats(model, payload),
            coarse=S.coarse_codes(payload),
        )


def _search_prepped(
    index: FlatIndex,
    prep: QueryPrep,
    k: int = 10,
    rerank: int = 0,
    use_kernel: bool = True,
    coarse: Optional[str] = None,
    shortlist: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k search from precomputed query projections: (scores, ids),
    each (m, k).  rerank > 0 re-ranks a shortlist of that size with
    exact scores on the bf16 raw vectors (requires keep_raw);
    ``coarse="int8"`` puts the coarse first pass of ``shortlist`` rows
    ahead (see ``common.ScanPlan``)."""
    plan = C.ScanPlan(
        metric=index.metric, k=k, rerank=rerank, row_valid=index.live,
        ids=index.ids, use_kernel=use_kernel, coarse=coarse,
        shortlist=shortlist,
    )
    return C.execute_plan(
        index.model, prep, index.payload, plan,
        stats=index.stats, raw=index.raw, coarse_cache=index.coarse,
    )


def _search(index: FlatIndex, queries, k=10, rerank=0, use_kernel=True,
            coarse=None, shortlist=None):
    """``prepare_queries`` then :func:`_search_prepped`."""
    prep = S.prepare_queries(index.model, queries)
    return _search_prepped(
        index, prep, k=k, rerank=rerank, use_kernel=use_kernel,
        coarse=coarse, shortlist=shortlist,
    )


def _add(index: FlatIndex, X_new: torch.Tensor) -> FlatIndex:
    """Encode new rows under the existing model and append them; they
    get the next ``n_new`` user ids."""
    dev = index.model.device
    X_new = X_new.to(dev)
    payload_new = A.encode(index.model, X_new)
    n_new = payload_new.n
    nid = C.effective_next_id(index.next_id, index.ids, index.payload.n)
    ids = index.ids
    if ids is not None:
        ids = torch.cat([
            ids, nid + torch.arange(n_new, dtype=torch.int32, device=dev)
        ])
    live = index.live
    if live is not None:
        live = torch.cat([live, torch.ones(n_new, dtype=torch.bool, device=dev)])
    raw = index.raw
    if raw is not None:
        raw = torch.cat([raw, X_new.to(torch.bfloat16)])
    payload = C.concat_payloads(index.payload, payload_new)
    return FlatIndex(
        metric=index.metric,
        model=index.model,
        payload=payload,
        raw=raw,
        stats=C.concat_stats(
            index.stats, S.payload_stats(index.model, payload_new)
        ),
        ids=ids,
        live=live,
        next_id=None if index.next_id is None else nid + n_new,
        coarse=S.coarse_codes(payload),
    )


def _delete(index: FlatIndex, del_ids) -> tuple[FlatIndex, int]:
    """Tombstone rows by user id: (index, rows newly removed)."""
    new_live, removed = C.mark_deleted(
        index.ids, index.live, del_ids, index.payload.n
    )
    if removed == 0:
        return index, 0
    live = torch.as_tensor(new_live, device=index.model.device)
    return dataclasses.replace(index, live=live), removed


def _compact(index: FlatIndex) -> FlatIndex:
    """Evict tombstoned rows from codes/stats/raw/ids; search afterwards
    equals a fresh build over the survivors with the same model."""
    if index.live is None:
        return index
    live_np = index.live.cpu().numpy().astype(bool)
    if live_np.all():
        return dataclasses.replace(index, live=None)
    if not live_np.any():
        raise ValueError(
            "compact() would evict every row; an empty index cannot "
            "be searched — keep at least one live row or rebuild"
        )
    nid = C.effective_next_id(index.next_id, index.ids, index.payload.n)
    keep = torch.as_tensor(
        np.nonzero(live_np)[0].astype(np.int32), device=index.model.device
    )
    ids = keep if index.ids is None else index.ids[keep.long()]
    payload = C.gather_payload(index.payload, keep)
    return FlatIndex(
        metric=index.metric,
        model=index.model,
        payload=payload,
        raw=None if index.raw is None else index.raw[keep.long()],
        stats=C.take_stats(index.stats, keep),
        ids=ids.to(torch.int32),
        live=None,
        next_id=nid,
        coarse=S.coarse_codes(payload),
    )
