"""Shared machinery of the index backends (counterpart of
``repro.index.common``).

Every search lowers to a :class:`ScanPlan` and :func:`execute_plan`
picks the route:

* dense plans (flat, IVF full probe): the fused scan + selection
  kernel when the requested top-k (or rerank shortlist) fits
  ``FUSED_TOPK_MAX_K``, else the materializing kernel and a stable
  sort;
* gathered plans (IVF partial probes, ``rows=``): the fused gathered
  kernel, or the materializing gathered kernel and a stable sort,
  at the same boundary;
* ``coarse="int8"`` puts the symmetric int8 coarse scan first and
  refines its top-``shortlist`` rows with the gathered kernels.

:func:`plan_paged_probe` plans a gathered scan over the union of the
probed inverted lists that the tiered IVF backend pages in.

The fused and materializing routes return identical results, so the
routing boundary is invisible to callers.

Score convention: higher is better for every metric (L2 scores are
negated squared distances); missing candidates carry ``-inf`` and id
-1.  Every selection orders ties by lowest id (or candidate position)
first, as the reference's ``lax.top_k`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core import scoring as S
from repro_torch.core.types import (
    ASHModel, ASHPayload, ASHStats, CoarseCodes, QueryPrep,
)
from repro_torch.device import row_blocked
from repro_torch.kernels import ops as K
from repro_torch.kernels.ref import stable_top_k

NEG_INF = float("-inf")
METRICS = ("dot", "l2", "cos")
COARSE_MODES = ("int8",)
_EPS = 1e-12


def validate_metric(metric: str) -> str:
    if metric not in METRICS:
        raise ValueError(
            f"unknown metric {metric!r}; expected one of {METRICS}"
        )
    return metric


def approx_scores(
    model: ASHModel,
    prep: QueryPrep,
    payload: ASHPayload,
    metric: str,
    *,
    use_kernel: bool = False,
    stats: Optional[ASHStats] = None,
) -> torch.Tensor:
    """ASH scores of all payload rows, (m, n), higher-is-better.

    use_kernel=False: the plain reference scorers of ``core.scoring``;
    True: the materializing scan kernel with its metric epilogue
    (the plain version on CPU tensors)."""
    if not use_kernel:
        if metric == "dot":
            return S.score_dot(model, prep, payload)
        if metric == "l2":
            return -S.score_l2(model, prep, payload)
        if metric == "cos":
            return S.score_cosine(model, prep, payload)
        raise ValueError(metric)
    validate_metric(metric)
    return K.ash_score(model, prep, payload, metric=metric, stats=stats)


def approx_topk(
    model: ASHModel,
    prep: QueryPrep,
    payload: ASHPayload,
    metric: str,
    k: int,
    *,
    stats: Optional[ASHStats] = None,
    n_valid: Any = None,
    row_valid: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused-selection top-k over all payload rows: (scores, rows).
    Callers keep ``k <= fused_topk_limit()`` and ``k <= payload.n``."""
    validate_metric(metric)
    return K.ash_score_topk(
        model, prep, payload, k, metric=metric, stats=stats,
        n_valid=n_valid, row_valid=row_valid,
    )


def fused_topk_limit() -> int:
    """Largest k the fused-selection route serves."""
    return K.FUSED_TOPK_MAX_K


def default_shortlist() -> int:
    """Default coarse-shortlist size L."""
    return K.DEFAULT_SHORTLIST


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """Declarative description of one top-k scan.

    WHAT to score:
      * dense (``rows is None``): every payload row, optionally
        truncated by ``n_valid`` (rows at/beyond it score -inf) and
        filtered by ``row_valid`` ((n,) bool; False rows are
        tombstones), both folded into the fused kernels' runtime mask
        operand;
      * gathered (``rows`` = (m, R) int32): query i scores its own
        candidate rows ``rows[i]`` (IVF partial probes); pad entries
        carry id -1 and score -inf.  Tombstones are dropped from the
        table (mapped to -1) BEFORE planning: ``row_valid`` or
        ``n_valid`` on a gathered plan is an error.

    HOW to select: top-``k`` per query; ``rerank > 0`` retrieves a
    ``max(rerank, k)`` shortlist and re-ranks it with exact scores over
    the ``raw`` vectors given to :func:`execute_plan`.  ``ids`` maps
    payload rows to user ids.  ``use_kernel=False`` scores with the
    plain versions instead of the scan kernels (the reference's
    ``use_pallas=False``).

    FIRST PASS: ``coarse="int8"`` runs the symmetric int8 coarse scan
    first and rescores only its top ``shortlist`` (L) rows
    asymmetrically; ``shortlist=None`` takes :func:`default_shortlist`,
    raised to the refine depth.  Coarse search changes results by
    design, except when L covers every candidate (L >= n dense, L >= R
    gathered): the coarse stage is then skipped and results equal the
    plain asymmetric plan's.  ``shortlist`` without ``coarse`` is an
    error, as is an unknown coarse mode.
    """

    metric: str
    k: int
    rerank: int = 0
    rows: Optional[torch.Tensor] = None
    n_valid: Any = None
    row_valid: Optional[torch.Tensor] = None
    ids: Optional[torch.Tensor] = None
    use_kernel: bool = True
    coarse: Optional[str] = None
    shortlist: Optional[int] = None


def _map_ids(rows: torch.Tensor, ids: Optional[torch.Tensor]) -> torch.Tensor:
    """Map payload rows to user ids, keeping the -1 sentinel."""
    if ids is None:
        return rows
    return torch.where(rows < 0, -1, ids[rows.clamp(min=0).long()])


def execute_plan(
    model: ASHModel,
    prep: QueryPrep,
    payload: ASHPayload,
    plan: ScanPlan,
    *,
    stats: Optional[ASHStats] = None,
    raw: Optional[torch.Tensor] = None,
    coarse_cache: Optional[CoarseCodes] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run a :class:`ScanPlan`: (scores, ids), each (m, k).

    ``coarse_cache`` is the backend's :class:`CoarseCodes` for coarse
    plans; when absent it is rebuilt per call (one database unpack)."""
    with tracing.span("index.scan"):
        validate_metric(plan.metric)
        if plan.coarse is not None and plan.coarse not in COARSE_MODES:
            raise ValueError(
                f"unknown coarse mode {plan.coarse!r}; expected one of "
                f"{COARSE_MODES} (or None)"
            )
        if plan.shortlist is not None and plan.coarse is None:
            raise ValueError(
                "shortlist= sets the coarse first-pass size and requires "
                "coarse='int8'"
            )
        if plan.rows is None:
            return _execute_dense(model, prep, payload, plan, stats=stats,
                                  raw=raw, coarse_cache=coarse_cache)
        if plan.n_valid is not None or plan.row_valid is not None:
            raise ValueError(
                "n_valid/row_valid apply to dense plans only; gathered "
                "plans mask by pad id (drop tombstoned rows to -1 in "
                "`rows` before planning)"
            )
        return _execute_gather(model, prep, payload, plan, stats=stats,
                               raw=raw, coarse_cache=coarse_cache)


def _coarse_depth(plan: ScanPlan, n_cand: int, want_rerank: bool):
    """(refine_k, L) of a coarse plan over ``n_cand`` candidates: the
    refine returns the rerank shortlist (or k), and L is raised to it."""
    refine_k = (
        min(max(plan.rerank, plan.k), n_cand) if want_rerank else plan.k
    )
    return refine_k, max(plan.shortlist or default_shortlist(), refine_k)


def _finish_refine(prep, raw, ss, srows, plan, want_rerank, *, dense):
    """Tail of both coarse routes: exact rerank of the refined
    shortlist, or its first k mapped to user ids (the dense route also
    maps -inf slots to -1, as the reference does)."""
    if want_rerank:
        return exact_rerank(prep, raw, ss, srows, plan.metric, plan.k,
                            ids=plan.ids)
    ss, srows = ss[:, :plan.k], srows[:, :plan.k]
    if dense:
        srows = torch.where(torch.isneginf(ss), -1, srows)
    return ss, _map_ids(srows, plan.ids)


def _execute_dense(model, prep, payload, plan, *, stats, raw,
                   coarse_cache=None):
    """Dense-scan lowering (flat, IVF full probe)."""
    n = payload.n
    cap = fused_topk_limit()
    masked = plan.n_valid is not None or plan.row_valid is not None
    want_rerank = bool(plan.rerank) and raw is not None

    if plan.coarse is not None:
        refine_k, L = _coarse_depth(plan, n, want_rerank)
        if L < n:
            ss, srows = K.coarse_refine_topk(
                model, prep, payload, refine_k, shortlist=L,
                metric=plan.metric, stats=stats, coarse=coarse_cache,
                n_valid=plan.n_valid, row_valid=plan.row_valid,
                use_kernel=plan.use_kernel,
            )
            return _finish_refine(prep, raw, ss, srows, plan, want_rerank,
                                  dense=True)
        # L >= n: the shortlist covers every row, so the coarse pass
        # cannot change the candidate set; the asymmetric plan runs as is

    def materialized():
        s = approx_scores(
            model, prep, payload, plan.metric,
            use_kernel=plan.use_kernel, stats=stats,
        )
        if not masked:
            return s
        return K.mask_valid_rows(s, plan.n_valid, plan.row_valid)

    def select(size):
        if plan.use_kernel and size <= min(cap, n):
            return approx_topk(
                model, prep, payload, plan.metric, size, stats=stats,
                n_valid=plan.n_valid, row_valid=plan.row_valid,
            )
        s, rows = stable_top_k(materialized(), size)
        return s, rows.to(torch.int32)

    if want_rerank:
        short_s, short_rows = select(min(max(plan.rerank, plan.k), n))
        return exact_rerank(
            prep, raw, short_s, short_rows, plan.metric, plan.k,
            ids=plan.ids,
        )
    s, rows = select(plan.k)
    if masked:
        # -inf slots carry route-dependent ids under row masking (the
        # fused kernel emits sentinels, the sort the masked rows);
        # normalize both routes to -1
        rows = torch.where(torch.isneginf(s), -1, rows)
    return s, _map_ids(rows, plan.ids)


def _execute_gather(model, prep, payload, plan, *, stats, raw,
                    coarse_cache=None):
    """Gathered-candidate lowering (IVF partial probes)."""
    rows = plan.rows.to(torch.int32).contiguous()
    R = rows.shape[1]
    cap = fused_topk_limit()
    want_rerank = bool(plan.rerank) and raw is not None

    if plan.coarse is not None:
        refine_k, L = _coarse_depth(plan, R, want_rerank)
        if L < R:
            ss, srows = K.coarse_refine_gather_topk(
                model, prep, payload, rows, refine_k, shortlist=L,
                metric=plan.metric, stats=stats, coarse=coarse_cache,
                use_kernel=plan.use_kernel,
            )
            return _finish_refine(prep, raw, ss, srows, plan, want_rerank,
                                  dense=False)
        # L >= R: the shortlist covers the whole candidate table

    def shortlist(size):
        if plan.use_kernel and size <= cap:
            return K.ash_score_gather_topk(
                model, prep, payload, rows, size, metric=plan.metric,
                stats=stats,
            )
        sc = K.ash_score_gather(
            model, prep, payload, rows, metric=plan.metric, stats=stats,
            use_kernel=plan.use_kernel,
        )
        s, pos = stable_top_k(sc, size)
        return s, rows.gather(1, pos).to(torch.int32)

    if want_rerank:
        ss, srows = shortlist(min(max(plan.rerank, plan.k), R))
        return exact_rerank(prep, raw, ss, srows, plan.metric, plan.k,
                            ids=plan.ids)
    s, rows_out = shortlist(plan.k)
    return s, _map_ids(rows_out, plan.ids)


@dataclasses.dataclass(frozen=True)
class PagedScanPlan:
    """A gathered scan whose candidate rows index a UNION of probed
    inverted lists instead of the global payload: the tiered IVF
    backend, whose lists live in host memory and reach the device only
    when probed.

    Built on the host by :func:`plan_paged_probe` from the probe set and
    the contiguous-list geometry.  ``union_lists`` are the probed lists
    in ascending id order; concatenating their row blocks in that order
    reproduces the global (list-sorted) row order restricted to the
    union, so a global candidate row maps into the union by a per-list
    constant shift (``delta``), a monotone map: candidate order,
    per-candidate scores, tie order and ids all stay those of the
    HBM-resident gathered plan.
    """

    probe: Any  # (m, nprobe) probed list ids, numpy
    counts: Any  # (nlist,) int64 rows per list
    starts: Any  # (nlist,) int64 first global row of each list
    live: Any  # (n,) bool row validity, or None
    max_list_len: int
    union_lists: tuple  # ascending probed list ids
    n_union: int  # rows in the union
    delta: Any  # (nlist,) int64: union row = global row + delta[list]

    def candidate_rows(self) -> np.ndarray:
        """(m, nprobe * max_list_len) int32 union-local candidate rows,
        slot for slot the layout of ``invlists[probe]`` (probe order,
        each list's tail padded with -1), tombstoned rows -1."""
        probe = self.probe
        m = probe.shape[0]
        t = np.arange(self.max_list_len, dtype=np.int64)
        g = self.starts[probe][:, :, None] + t[None, None, :]
        valid = t[None, None, :] < self.counts[probe][:, :, None]
        if self.live is not None:
            live = np.asarray(self.live).astype(bool)
            valid &= live[np.minimum(g, max(live.size - 1, 0))]
        loc = g + self.delta[probe][:, :, None]
        return np.where(valid, loc, -1).reshape(m, -1).astype(np.int32)


def plan_paged_probe(probe, counts, starts, live,
                     max_list_len: int) -> PagedScanPlan:
    """Plan a paged gathered scan over a probe set, on the host.

    ``probe``: (m, nprobe) probed list ids per query (any order,
    duplicates allowed); ``counts``/``starts``: the contiguous list
    geometry (``ivf.list_geometry``); ``live``: an optional (n,) row
    validity bitmap, whose tombstones become -1 in
    :meth:`PagedScanPlan.candidate_rows` before any copy.  Counterpart
    of the reference's ``plan_paged_probe``: the same union and the same
    candidates, candidate for candidate; the reference's pad of the
    union to a few trace shapes is not needed here (nothing is
    compiled per shape)."""
    probe = np.asarray(probe)
    counts = np.asarray(counts, dtype=np.int64)
    starts = np.asarray(starts, dtype=np.int64)
    union = np.unique(probe.ravel())
    union = union[(union >= 0) & (union < counts.size)]
    c_u = counts[union]
    local_starts = np.concatenate([[0], np.cumsum(c_u)[:-1]]).astype(
        np.int64)
    delta = np.zeros(counts.size, dtype=np.int64)
    delta[union] = local_starts - starts[union]
    return PagedScanPlan(
        probe=probe, counts=counts, starts=starts, live=live,
        max_list_len=int(max_list_len),
        union_lists=tuple(int(c) for c in union), n_union=int(c_u.sum()),
        delta=delta,
    )


def exact_scores(prep: QueryPrep, cand: torch.Tensor, metric: str):
    """Metric-aware exact scores of raw candidates (m, R, D) -> (m, R),
    higher-is-better; inner products by broadcast-multiply and reduce,
    over blocks of a fixed query count (:func:`row_blocked`: a reduction
    over more outputs may take another summation order)."""
    if metric == "dot":
        return row_blocked(lambda q, c: (q[:, None, :] * c).sum(dim=-1),
                           prep.q, cand)
    ip, c_sq = row_blocked(lambda q, c: ((q[:, None, :] * c).sum(dim=-1),
                                         (c * c).sum(dim=-1)), prep.q, cand)
    if metric == "l2":
        return -(prep.q_sq_norm[:, None] - 2.0 * ip + c_sq)
    if metric == "cos":
        q_norm = torch.sqrt(torch.clamp(prep.q_sq_norm, min=_EPS))[:, None]
        c_norm = torch.clamp(torch.sqrt(c_sq), min=_EPS)
        return ip / (q_norm * c_norm)
    raise ValueError(metric)


def exact_rerank(
    prep: QueryPrep,
    raw: torch.Tensor,
    shortlist_scores: torch.Tensor,
    shortlist_rows: torch.Tensor,
    metric: str,
    k: int,
    ids: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Re-rank a shortlist (m, R) with exact scores on the raw vectors;
    entries without a valid candidate get (-inf, -1)."""
    with tracing.span("index.rerank"):
        cand = raw[shortlist_rows.clamp(min=0).long()].to(torch.float32)
        exact = exact_scores(prep, cand, metric)
        exact = torch.where(torch.isneginf(shortlist_scores), NEG_INF,
                            exact)
        rs, ri = stable_top_k(exact, k)
        rows_k = shortlist_rows.gather(1, ri)
        out = rows_k if ids is None else ids[rows_k.clamp(min=0).long()]
        return rs, torch.where(torch.isneginf(rs), -1, out).to(torch.int32)


# ---------------------------------------------------------------------------
# Payload manipulation shared by backends
# ---------------------------------------------------------------------------


def gather_payload(payload: ASHPayload, rows: torch.Tensor) -> ASHPayload:
    """Gather payload rows; -1 rows read row 0 (callers mask them)."""
    safe = rows.clamp(min=0).long()
    return ASHPayload(
        b=payload.b, d=payload.d,
        codes=payload.codes[safe], scale=payload.scale[safe],
        offset=payload.offset[safe], cluster=payload.cluster[safe],
    )


def take_stats(stats: Optional[ASHStats], rows) -> Optional[ASHStats]:
    """Gather stats rows (compaction keeps survivors' encode-time
    statistics bit for bit)."""
    if stats is None:
        return None
    rows = rows.long()
    return ASHStats(
        res_norm=stats.res_norm[rows], ip_x_mu=stats.ip_x_mu[rows],
        x_sq=stats.x_sq[rows],
    )


def concat_stats(a: Optional[ASHStats], b: Optional[ASHStats]):
    """Row-concatenate two stats blocks (None if either is missing)."""
    if a is None or b is None:
        return None
    return ASHStats(
        res_norm=torch.cat([a.res_norm, b.res_norm]),
        ip_x_mu=torch.cat([a.ip_x_mu, b.ip_x_mu]),
        x_sq=torch.cat([a.x_sq, b.x_sq]),
    )


def concat_payloads(a: ASHPayload, b: ASHPayload) -> ASHPayload:
    """Row-concatenate two payloads encoded under the same model."""
    if (a.b, a.d) != (b.b, b.d):
        raise ValueError(
            f"payload mismatch: (b={a.b}, d={a.d}) vs (b={b.b}, d={b.d})"
        )
    return ASHPayload(
        b=a.b, d=a.d,
        codes=torch.cat([a.codes, b.codes]),
        scale=torch.cat([a.scale, b.scale]),
        offset=torch.cat([a.offset, b.offset]),
        cluster=torch.cat([a.cluster, b.cluster]),
    )


# ---------------------------------------------------------------------------
# Tombstone (delete) bookkeeping shared by backends
# ---------------------------------------------------------------------------


def effective_next_id(next_id, ids, n: int) -> int:
    """The user id the next added row receives: ``next_id`` once
    mutations set it, else ``n`` for identity ids, else max(ids) + 1.
    Ids are never reused."""
    if next_id is not None:
        return int(next_id)
    if ids is None or n == 0:
        return int(n)
    return int(ids.max()) + 1


def mark_deleted(ids, live, del_ids, n: int) -> tuple[np.ndarray, int]:
    """Tombstone payload rows by user id: (new live bitmap (n,) bool
    numpy, rows newly removed).  Unknown or already-deleted ids are
    ignored (FAISS ``remove_ids`` semantics)."""
    del_ids = np.unique(np.asarray(del_ids).reshape(-1).astype(np.int64))
    row_ids = (
        np.arange(n, dtype=np.int64) if ids is None
        else ids.cpu().numpy().astype(np.int64)
    )
    hit = np.isin(row_ids, del_ids)
    if live is not None:
        old = live.cpu().numpy().astype(bool)
        hit &= old
        new_live = old & ~hit
    else:
        new_live = ~hit
    return new_live, int(hit.sum())
