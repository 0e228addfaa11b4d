"""Model-level entry points of the dense scan kernels.

Counterpart of ``repro.kernels.ops`` (dense half).  Dispatch works as
the reference's ``_auto_interpret``: the kernel wrappers launch the
CUDA kernel for CUDA tensors and run its plain version for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.core import quantization as Q
from repro_torch.core import scoring as S
from repro_torch.core.types import ASHModel, ASHPayload, ASHStats, QueryPrep
from repro_torch.kernels import ref
from repro_torch.kernels.ash_score import ash_score_cuda, ash_score_topk_cuda

_EPS = 1e-12

# Largest k (or rerank shortlist) the fused-selection route serves; the
# index layers materialize and sort beyond it.  Scores of the two
# kernels are identical element for element, so the route never
# changes results.
FUSED_TOPK_MAX_K = 128


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
