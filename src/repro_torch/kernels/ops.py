"""Model-level entry points of the scan kernels.

Counterpart of ``repro.kernels.ops``.  Dispatch works as the
reference's ``_auto_interpret``: the kernel wrappers launch the CUDA
kernel for CUDA tensors and run its plain version for CPU tensors.
``use_kernel=False`` (the reference's ``use_pallas=False``) calls the
plain versions directly, on any device.
"""
from __future__ import annotations

import torch

from repro_torch.core import quantization as Q
from repro_torch.core import scoring as S
from repro_torch.core.types import (
    ASHModel, ASHPayload, ASHStats, CoarseCodes, CoarseQueryPrep, QueryPrep,
)
from repro_torch.kernels import ref
from repro_torch.kernels.ash_kv_attn import ash_kv_attn_cuda
from repro_torch.kernels.ash_score import (
    ash_score_coarse_cuda,
    ash_score_coarse_topk_cuda,
    ash_score_cuda,
    ash_score_gather_cuda,
    ash_score_gather_topk_cuda,
    ash_score_topk_cuda,
)

_EPS = 1e-12

# Largest k (or rerank shortlist) the fused-selection route serves; the
# index layers materialize and sort beyond it.  Scores of the two
# kernels are identical element for element, so the route never
# changes results.
FUSED_TOPK_MAX_K = 128

# Default coarse shortlist size L of the coarse -> refine plans: the
# reference's value, picked there by a recall-vs-shortlist sweep;
# ``execute_plan`` raises L to the requested top-k / rerank depth.
DEFAULT_SHORTLIST = 32


def _metric_operands(
    model: ASHModel,
    prep: QueryPrep,
    payload: ASHPayload,
    stats: ASHStats | None,
    metric: str,
):
    """(qterm, rowterm) epilogue vectors; None for dot.  Built from the
    encode-time ``ASHStats`` (recomputed when ``stats`` is None, which
    unpacks the database once)."""
    if metric == "dot":
        return None, None
    if stats is None:
        stats = S.payload_stats(model, payload)
    if metric == "l2":
        res = stats.res_norm.to(torch.float32)
        rowterm = (
            res * res
            + 2.0 * stats.ip_x_mu.to(torch.float32)
            - model.landmark_sq_norms[payload.cluster.long()]
        )  # == ||x||^2 recovered: -l2 = 2<q,x> - ||q||^2 - ||x||^2
        return prep.q_sq_norm.to(torch.float32).contiguous(), rowterm
    if metric == "cos":
        qterm = 1.0 / torch.sqrt(torch.clamp(prep.q_sq_norm, min=_EPS))
        rowterm = 1.0 / torch.sqrt(torch.clamp(stats.x_sq, min=_EPS))
        return qterm.to(torch.float32), rowterm.to(torch.float32)
    raise ValueError(metric)


def _score_args(prep: QueryPrep, payload: ASHPayload):
    """Kernel operands: codes, q_proj zero-padded to the packed width
    d_pad = Wd * 32/b (pad lanes add nothing), f32 headers, cluster,
    <q, mu_c>."""
    d_pad = payload.codes.shape[1] * Q.codes_per_word(payload.b)
    q_proj = prep.q_proj.to(torch.float32)
    if q_proj.shape[-1] < d_pad:
        q_proj = torch.nn.functional.pad(q_proj, (0, d_pad - q_proj.shape[-1]))
    return (
        payload.codes.contiguous(),
        q_proj.contiguous(),
        payload.scale.to(torch.float32).contiguous(),
        payload.offset.to(torch.float32).contiguous(),
        payload.cluster.contiguous(),
        prep.ip_q_landmarks.to(torch.float32).contiguous(),
    )


def ash_score(
    model: ASHModel,
    prep: QueryPrep,
    payload: ASHPayload,
    *,
    metric: str = "dot",
    stats: ASHStats | None = None,
) -> torch.Tensor:
    """Fused all-metric scoring: (m, n) f32, higher-is-better."""
    qterm, rowterm = _metric_operands(model, prep, payload, stats, metric)
    return ash_score_cuda(
        *_score_args(prep, payload), qterm, rowterm, b=payload.b,
        metric=metric,
    )


def mask_valid_rows(scores: torch.Tensor, n_valid=None, row_valid=None):
    """Force masked columns to -inf: the materialized-path equivalent of
    the fused kernel's runtime row-validity mask operand."""
    return ref.mask_rows_ref(scores, n_valid, row_valid)


def ash_score_topk(
    model: ASHModel,
    prep: QueryPrep,
    payload: ASHPayload,
    k: int,
    *,
    metric: str = "dot",
    stats: ASHStats | None = None,
    k_tilde: int | None = None,
    n_valid=None,
    row_valid=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused scan + selection: top-k (scores, int32 row ids), (m, k).
    Equal to a stable top-k of ``mask_valid_rows(ash_score(...))`` for
    k <= k_tilde (default k); see ``ash_score_topk_cuda``."""
    qterm, rowterm = _metric_operands(model, prep, payload, stats, metric)
    return ash_score_topk_cuda(
        *_score_args(prep, payload), qterm, rowterm, n_valid, row_valid,
        b=payload.b, k=k, k_tilde=k_tilde, metric=metric,
    )


# ---------------------------------------------------------------------------
# Gathered scans (IVF partial probes, coarse refine)
# ---------------------------------------------------------------------------


def ash_score_gather(
    model: ASHModel,
    prep: QueryPrep,
    payload: ASHPayload,
    rows: torch.Tensor,
    *,
    metric: str = "dot",
    stats: ASHStats | None = None,
    use_kernel: bool = True,
) -> torch.Tensor:
    """Gathered scoring: (m, R) f32, query i against its own candidate
    rows ``rows[i]`` (payload rows, -1 = padding -> ``-inf``)."""
    qterm, rowterm = _metric_operands(model, prep, payload, stats, metric)
    args = _score_args(prep, payload)
    rows = rows.to(torch.int32).contiguous()
    fn = ash_score_gather_cuda if use_kernel else ref.ash_score_gather_ref
    return fn(args[0], rows, *args[1:], qterm, rowterm, b=payload.b,
              metric=metric)


def ash_score_gather_topk(
    model: ASHModel,
    prep: QueryPrep,
    payload: ASHPayload,
    rows: torch.Tensor,
    k: int,
    *,
    metric: str = "dot",
    stats: ASHStats | None = None,
    k_tilde: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused gathered scan + selection: (scores, payload rows), each
    (m, k); equal to a stable top-k over positions of
    :func:`ash_score_gather`, mapped back through ``rows``."""
    qterm, rowterm = _metric_operands(model, prep, payload, stats, metric)
    args = _score_args(prep, payload)
    return ash_score_gather_topk_cuda(
        args[0], rows.to(torch.int32).contiguous(), *args[1:], qterm,
        rowterm, b=payload.b, k=k, k_tilde=k_tilde, metric=metric,
    )


# ---------------------------------------------------------------------------
# Symmetric int8 coarse first pass and the coarse -> refine plans
# ---------------------------------------------------------------------------


def _coarse_prep(
    prep: QueryPrep,
    payload: ASHPayload,
    coarse: CoarseCodes | None,
    cprep: CoarseQueryPrep | None,
) -> CoarseQueryPrep:
    """The int8 query quantization, built when absent (from ``coarse``,
    itself built when absent: one unpack of the database; index
    backends keep it)."""
    if cprep is not None:
        return cprep
    if coarse is None:
        coarse = S.coarse_codes(payload)
    return S.prepare_coarse_queries(prep, coarse.mean)


def _coarse_score_args(prep: QueryPrep, cprep: CoarseQueryPrep,
                       payload: ASHPayload):
    """Kernel operands; q_int8 zero-padded to the packed width d_pad
    (zero columns add nothing to the integer accumulation)."""
    d_pad = payload.codes.shape[1] * Q.codes_per_word(payload.b)
    qi = cprep.q_int8
    if qi.shape[-1] < d_pad:
        qi = torch.nn.functional.pad(qi, (0, d_pad - qi.shape[-1]))
    return (
        payload.codes.contiguous(),
        qi.contiguous(),
        cprep.q_scale.to(torch.float32).contiguous(),
        cprep.q_corr.to(torch.float32).contiguous(),
        payload.scale.to(torch.float32).contiguous(),
        payload.offset.to(torch.float32).contiguous(),
        payload.cluster.contiguous(),
        prep.ip_q_landmarks.to(torch.float32).contiguous(),
    )


def ash_score_coarse(
    model: ASHModel,
    prep: QueryPrep,
    payload: ASHPayload,
    *,
    metric: str = "dot",
    stats: ASHStats | None = None,
    coarse: CoarseCodes | None = None,
    cprep: CoarseQueryPrep | None = None,
    use_kernel: bool = True,
) -> torch.Tensor:
    """Symmetric int8 coarse scores: (m, n) f32, higher-is-better.
    Kernel and plain version are bit-equal (exact integer
    accumulation, one epilogue order)."""
    cprep = _coarse_prep(prep, payload, coarse, cprep)
    args = _coarse_score_args(prep, cprep, payload)
    qterm, rowterm = _metric_operands(model, prep, payload, stats, metric)
    if not use_kernel:
        return ref.ash_score_coarse_ref(*args, qterm, rowterm, b=payload.b,
                                        metric=metric)
    return ash_score_coarse_cuda(*args, qterm, rowterm, b=payload.b,
                                 metric=metric)


def ash_score_coarse_topk(
    model: ASHModel,
    prep: QueryPrep,
    payload: ASHPayload,
    k: int,
    *,
    metric: str = "dot",
    stats: ASHStats | None = None,
    coarse: CoarseCodes | None = None,
    cprep: CoarseQueryPrep | None = None,
    k_tilde: int | None = None,
    n_valid=None,
    row_valid=None,
    use_kernel: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Coarse shortlist: top-k (scores, int32 ids) of the coarse scores,
    ``k`` being the shortlist size L.  Routes as the reference: the
    fused kernel up to ``FUSED_TOPK_MAX_K``, beyond it the materializing
    kernel and a stable sort (identical per-element scores).  Masking
    as :func:`ash_score_topk`."""
    cprep = _coarse_prep(prep, payload, coarse, cprep)
    args = _coarse_score_args(prep, cprep, payload)
    qterm, rowterm = _metric_operands(model, prep, payload, stats, metric)
    if use_kernel and k <= FUSED_TOPK_MAX_K:
        return ash_score_coarse_topk_cuda(
            *args, qterm, rowterm, n_valid, row_valid, b=payload.b, k=k,
            k_tilde=k_tilde, metric=metric,
        )
    if use_kernel:
        scores = ash_score_coarse_cuda(*args, qterm, rowterm, b=payload.b,
                                       metric=metric)
    else:
        scores = ref.ash_score_coarse_ref(*args, qterm, rowterm,
                                          b=payload.b, metric=metric)
    s, ids = ref.stable_top_k(mask_valid_rows(scores, n_valid, row_valid), k)
    return s, ids.to(torch.int32)


def ash_score_coarse_gather(
    model: ASHModel,
    prep: QueryPrep,
    payload: ASHPayload,
    rows: torch.Tensor,
    *,
    metric: str = "dot",
    stats: ASHStats | None = None,
    coarse: CoarseCodes | None = None,
    cprep: CoarseQueryPrep | None = None,
) -> torch.Tensor:
    """Coarse scores over per-query candidate rows: (m, R) f32, pad ids
    -inf (the IVF partial-probe coarse pass).  Plain PyTorch on every
    device, as the reference keeps it on its oracle: there is no
    gathered coarse kernel."""
    cprep = _coarse_prep(prep, payload, coarse, cprep)
    codes, qi, qs, qc, scale, offset, cluster, ipq = _coarse_score_args(
        prep, cprep, payload
    )
    qterm, rowterm = _metric_operands(model, prep, payload, stats, metric)
    return ref.ash_score_coarse_gather_ref(
        codes, rows, qi, qs, qc, scale, offset, cluster, ipq, qterm,
        rowterm, b=payload.b, metric=metric,
    )


def sort_candidate_rows(rows: torch.Tensor) -> torch.Tensor:
    """Ascending-id sort of a (m, R) candidate-row table with -1 pads
    last: the gathered selection breaks ties by position, so an
    ascending table makes its tie order the lowest-id-first one."""
    big = torch.iinfo(torch.int32).max
    s = torch.sort(torch.where(rows < 0, big, rows.to(torch.int32)),
                   dim=1).values
    return torch.where(s == big, -1, s)


def _refine_topk(model, prep, payload, rows, k, *, metric, stats,
                 use_kernel):
    """Asymmetric refine of a candidate table, routed at the fused cap
    as the reference: the fused gathered kernel up to
    ``FUSED_TOPK_MAX_K``, beyond it the materializing gathered kernel
    and a stable sort."""
    if use_kernel and k <= FUSED_TOPK_MAX_K:
        return ash_score_gather_topk(
            model, prep, payload, rows, k, metric=metric, stats=stats,
        )
    sc = ash_score_gather(model, prep, payload, rows, metric=metric,
                          stats=stats, use_kernel=use_kernel)
    s, pos = ref.stable_top_k(sc, k)
    return s, rows.gather(1, pos).to(torch.int32)


def coarse_refine_topk(
    model: ASHModel,
    prep: QueryPrep,
    payload: ASHPayload,
    k: int,
    *,
    shortlist: int,
    metric: str = "dot",
    stats: ASHStats | None = None,
    coarse: CoarseCodes | None = None,
    cprep: CoarseQueryPrep | None = None,
    n_valid=None,
    row_valid=None,
    use_kernel: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense two-stage scan: the top-L coarse shortlist (masked rows
    and -inf slots dropped to pad id -1), sorted by id, refined with
    the asymmetric gathered scan: top-k (scores, payload rows).
    Requires ``k <= shortlist``."""
    L = min(shortlist, payload.n)
    if k > L:
        raise ValueError(f"k={k} exceeds shortlist={L}")
    svals, ids = ash_score_coarse_topk(
        model, prep, payload, L, metric=metric, stats=stats,
        coarse=coarse, cprep=cprep, n_valid=n_valid, row_valid=row_valid,
        use_kernel=use_kernel,
    )
    rows = sort_candidate_rows(torch.where(torch.isneginf(svals), -1, ids))
    return _refine_topk(model, prep, payload, rows, k, metric=metric,
                        stats=stats, use_kernel=use_kernel)


def coarse_refine_gather_topk(
    model: ASHModel,
    prep: QueryPrep,
    payload: ASHPayload,
    rows: torch.Tensor,
    k: int,
    *,
    shortlist: int,
    metric: str = "dot",
    stats: ASHStats | None = None,
    coarse: CoarseCodes | None = None,
    cprep: CoarseQueryPrep | None = None,
    use_kernel: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gathered two-stage scan (IVF partial probes): coarse-score the
    (m, R) candidate table, keep the top-L rows per query (stable: ties
    to the lowest position), refine them asymmetrically: top-k
    (scores, payload rows)."""
    R = rows.shape[1]
    L = min(shortlist, R)
    if k > L:
        raise ValueError(f"k={k} exceeds shortlist={L}")
    scores = ash_score_coarse_gather(
        model, prep, payload, rows, metric=metric, stats=stats,
        coarse=coarse, cprep=cprep,
    )
    svals, pos = ref.stable_top_k(scores, L)
    cand = rows.gather(1, pos)
    cand = sort_candidate_rows(torch.where(torch.isneginf(svals), -1, cand))
    return _refine_topk(model, prep, payload, cand, k, metric=metric,
                        stats=stats, use_kernel=use_kernel)


def ash_kv_attention(
    q_k: torch.Tensor,  # (..., G, dk) projected queries (W_k q), f32
    k_codes: torch.Tensor,  # (..., S, Wk)
    k_scale: torch.Tensor,  # (..., S)
    k_bias,  # (..., S) or None
    v_codes: torch.Tensor,  # (..., S, Wv)
    v_scale: torch.Tensor,  # (..., S)
    mask,  # (..., S) bool or None
    *,
    b_k: int,
    b_v: int,
    use_kernel: bool = True,
) -> torch.Tensor:
    """Batched ASH-KV decode attention, G query heads per KV stream.

    Returns the reduced-space accumulation (..., G, dv); the caller
    decodes with W_v^T.  The kernel for CUDA tensors (at most two lead
    dims; operands read through their strides), the plain version for
    CPU tensors or ``use_kernel=False``.  The reference's single-query
    form is G = 1.
    """
    if use_kernel:
        return ash_kv_attn_cuda(q_k, k_codes, k_scale, k_bias, v_codes,
                                v_scale, mask, b_k=b_k, b_v=b_v)
    return ref.ash_kv_attn_ref(q_k, k_codes, k_scale, k_bias, v_codes,
                               v_scale, b_k, b_v, mask=mask)[0]
