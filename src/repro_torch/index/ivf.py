"""Inverted-file (IVF) ASH index.

Counterpart of ``repro.index.ivf``.  The ASH landmarks are the IVF
centroids: the coarse quantizer used for residual centering doubles as
the routing structure.  Rows are stored sorted by list, so list ``c``
is the contiguous row range ``[starts[c], starts[c] + counts[c])``;
``invlists`` pads every list to the longest with row id -1.

A search with ``nprobe >= nlist`` probes every list and runs the flat
backend's dense plan over the list-sorted payload.  A partial probe
picks each query's ``nprobe`` nearest centroids (stable top-k, ties to
the lowest list id), gathers their padded lists into an (m, nprobe *
max_list_len) candidate table, drops tombstoned rows to the pad id,
and lowers to a gathered ``common.ScanPlan``: the gathered kernels
score straight off the packed codes.  Queries with fewer than k live
candidates pad their results with (-inf, -1).

The reference pads a single-query batch to two queries because XLA
compiles m = 1 differently; here every gathered score and selection is
computed query by query, so no pad is needed.

Entry point is ``repro_torch.index.AshIndex`` with ``backend="ivf"``.
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
from repro_torch.kernels.ref import stable_top_k


@dataclasses.dataclass(frozen=True)
class IVFIndex:
    metric: str
    max_list_len: int
    model: ASHModel  # landmarks == IVF centroids (nlist, D)
    payload: ASHPayload  # rows sorted by list
    ids: torch.Tensor  # (n,) int32 user ids, sorted by list
    invlists: torch.Tensor  # (nlist, max_list_len) int32 rows, -1 pad
    raw: Optional[torch.Tensor]  # bf16 vectors (sorted) for rerank
    # encode-time row statistics of the sorted payload (l2/cos epilogues)
    stats: Optional[ASHStats] = None
    # row-validity bitmap of the sorted payload, False = tombstoned;
    # full probes mask it in the kernels, partial probes drop the rows
    # from the candidate table; None = all live
    live: Optional[torch.Tensor] = None
    # id of the next added row once mutations set it (None = derived)
    next_id: Optional[int] = None
    # operands of the int8 coarse first pass (derived, never persisted)
    coarse: Optional[CoarseCodes] = None


def list_geometry(cluster, nlist: int):
    """``(counts, starts)`` of the contiguous lists of a cluster column,
    each (nlist,) int64 numpy: in cluster-sorted row order list ``c``
    occupies rows ``[starts[c], starts[c] + counts[c])``."""
    counts = np.bincount(np.asarray(cluster), minlength=nlist).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    return counts, starts


def build_invlists(counts, starts, max_len: int) -> np.ndarray:
    """Padded inverted lists (nlist, max_len) int32 of global rows, -1
    beyond each list's count."""
    t = np.arange(max_len, dtype=np.int64)
    rows = starts[:, None] + t[None, :]
    return np.where(t[None, :] < counts[:, None], rows, -1).astype(np.int32)


def _assemble(
    metric: str,
    model: ASHModel,
    payload: ASHPayload,
    ids: torch.Tensor,
    raw: Optional[torch.Tensor],
    live: Optional[torch.Tensor] = None,
    next_id: Optional[int] = None,
) -> IVFIndex:
    """Sort rows by cluster (stably) and build the padded inverted
    lists.  payload/ids/raw/live are row-aligned in any order; a stable
    sort keeps add() results equal to an assembly from scratch over
    the concatenated rows.  Used by build, add and compact."""
    dev = model.device
    cluster = payload.cluster.cpu().numpy()
    if cluster.size and cluster.min() < 0:
        raise ValueError(
            "payload contains pad-sentinel cluster ids (-1); assemble "
            "inverted lists from an unpadded payload"
        )
    nlist = model.landmarks.shape[0]
    order = np.argsort(cluster, kind="stable")
    counts, starts = list_geometry(cluster, nlist)
    max_len = int(counts.max())
    perm = torch.as_tensor(order, device=dev)
    sorted_payload = C.gather_payload(payload, perm)
    return IVFIndex(
        metric=metric,
        max_list_len=max_len,
        model=model,
        payload=sorted_payload,
        ids=ids.to(dev)[perm].to(torch.int32),
        invlists=torch.as_tensor(build_invlists(counts, starts, max_len),
                                 device=dev),
        raw=None if raw is None else raw[perm],
        stats=S.payload_stats(model, sorted_payload),
        live=None if live is None else live.to(dev)[perm],
        next_id=next_id,
        coarse=S.coarse_codes(sorted_payload),
    )


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
) -> IVFIndex:
    """nlist = config.n_landmarks."""
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
        ids = torch.arange(payload.n, dtype=torch.int32, device=dev)
        raw = X.to(torch.bfloat16) if keep_raw else None
        return _assemble(metric, model, payload, ids, raw)


def _add(index: IVFIndex, X_new: torch.Tensor) -> IVFIndex:
    """Encode new rows under the existing model and merge them into the
    inverted lists; they get the next ``n_new`` user ids."""
    dev = index.model.device
    X_new = X_new.to(dev)
    payload_new = A.encode(index.model, X_new)
    n_new = payload_new.n
    nid = C.effective_next_id(index.next_id, index.ids, index.payload.n)
    ids = torch.cat([
        index.ids, nid + torch.arange(n_new, dtype=torch.int32, device=dev)
    ])
    live = index.live
    if live is not None:
        live = torch.cat([live, torch.ones(n_new, dtype=torch.bool,
                                           device=dev)])
    raw = index.raw
    if raw is not None:
        raw = torch.cat([raw, X_new.to(torch.bfloat16)])
    return _assemble(
        index.metric, index.model,
        C.concat_payloads(index.payload, payload_new), ids, raw,
        live=live, next_id=None if index.next_id is None else nid + n_new,
    )


def _delete(index: IVFIndex, del_ids) -> tuple[IVFIndex, int]:
    """Tombstone rows by user id: (index, rows newly removed).  The
    inverted lists stay as they are; :func:`_compact` re-sorts."""
    new_live, removed = C.mark_deleted(
        index.ids, index.live, del_ids, index.payload.n
    )
    if removed == 0:
        return index, 0
    live = torch.as_tensor(new_live, device=index.model.device)
    return dataclasses.replace(index, live=live), removed


def _compact(index: IVFIndex) -> IVFIndex:
    """Evict tombstoned rows and rebuild the inverted lists.  Survivors
    keep their relative (stable cluster-sorted) order, so search
    afterwards equals a fresh build over them with the same model."""
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
    return _assemble(
        index.metric, index.model, C.gather_payload(index.payload, keep),
        index.ids[keep.long()],
        None if index.raw is None else index.raw[keep.long()],
        next_id=nid,
    )


def _full_scan(index: IVFIndex, prep: QueryPrep, k: int, rerank: int,
               use_kernel: bool = True, coarse=None, shortlist=None):
    """Every list probed: the flat backend's dense plan over the
    list-sorted payload, rows mapped to user ids via ``index.ids``."""
    plan = C.ScanPlan(
        metric=index.metric, k=k, rerank=rerank, row_valid=index.live,
        ids=index.ids, use_kernel=use_kernel, coarse=coarse,
        shortlist=shortlist,
    )
    return C.execute_plan(
        index.model, prep, index.payload, plan,
        stats=index.stats, raw=index.raw, coarse_cache=index.coarse,
    )


def _probe_lists(index: IVFIndex, prep: QueryPrep, nprobe: int
                 ) -> torch.Tensor:
    """The ``nprobe`` nearest centroids per query, best first (m,
    nprobe) int64: nearest by L2 == max <q, mu> - ||mu||^2 / 2, from
    the prep's landmark inner products; ties to the lowest list id, as
    ``lax.top_k``."""
    with tracing.span("ivf.probe"):
        score = (
            prep.ip_q_landmarks
            - 0.5 * index.model.landmark_sq_norms[None, :]
        )
        return stable_top_k(score, nprobe)[1]


def candidate_rows(index: IVFIndex, probe: torch.Tensor) -> torch.Tensor:
    """The (m, nprobe * max_list_len) int32 candidate table of probed
    lists, with list padding and tombstoned rows as -1."""
    with tracing.span("ivf.table"):
        m = probe.shape[0]
        cand = index.invlists[probe.long()].reshape(m, -1)
        if index.live is not None:
            cand = torch.where(index.live[cand.clamp(min=0).long()], cand,
                               -1)
        return cand


def _score_probed(index: IVFIndex, prep: QueryPrep, probe: torch.Tensor,
                  k: int, rerank: int, use_kernel: bool = True,
                  coarse=None, shortlist=None):
    """The probed lists' candidate table as a gathered ``ScanPlan``."""
    plan = C.ScanPlan(
        metric=index.metric, k=k, rerank=rerank,
        rows=candidate_rows(index, probe), ids=index.ids,
        use_kernel=use_kernel, coarse=coarse, shortlist=shortlist,
    )
    return C.execute_plan(
        index.model, prep, index.payload, plan,
        stats=index.stats, raw=index.raw, coarse_cache=index.coarse,
    )


def _search_prepped(
    index: IVFIndex,
    prep: QueryPrep,
    k: int = 10,
    nprobe: int = 8,
    rerank: int = 0,
    use_kernel: bool = True,
    coarse: Optional[str] = None,
    shortlist: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k from precomputed query projections: (scores, ids), (m, k).
    ``nprobe >= nlist`` runs the dense plan; partial probes the
    gathered one.  ``coarse="int8"`` puts the coarse first pass ahead
    on either route."""
    if nprobe >= index.invlists.shape[0]:
        return _full_scan(index, prep, k, rerank, use_kernel=use_kernel,
                          coarse=coarse, shortlist=shortlist)
    probe = _probe_lists(index, prep, nprobe)
    return _score_probed(index, prep, probe, k, rerank,
                         use_kernel=use_kernel, coarse=coarse,
                         shortlist=shortlist)


def _search_probed(
    index: IVFIndex,
    prep: QueryPrep,
    probe: torch.Tensor,
    k: int = 10,
    rerank: int = 0,
    use_kernel: bool = True,
    coarse: Optional[str] = None,
    shortlist: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over an explicit (m, nprobe) probed-list set; equal to
    :func:`_search_prepped` when ``probe`` is the coarse assignment."""
    return _score_probed(index, prep, probe.to(index.invlists.device), k,
                         rerank, use_kernel=use_kernel, coarse=coarse,
                         shortlist=shortlist)


def _search(index: IVFIndex, queries, k: int = 10, nprobe: int = 8,
            rerank: int = 0, use_kernel: bool = True,
            coarse: Optional[str] = None, shortlist: Optional[int] = None):
    """``prepare_queries`` then :func:`_search_prepped`."""
    prep = S.prepare_queries(index.model, queries)
    return _search_prepped(
        index, prep, k=k, nprobe=nprobe, rerank=rerank,
        use_kernel=use_kernel, coarse=coarse, shortlist=shortlist,
    )
