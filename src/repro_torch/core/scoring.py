"""Similarity computations from ASH payloads.

The asymmetric dot product (Eq. 20) and its 1-bit masked-add form
(Eq. 22), Euclidean distance and cosine similarity (Appendix A), the
symmetric dot product of two encoded sets (Appendix B) and the Eq. (34)
bias correction: the plain reference scorers.  The CUDA
kernels in ``repro_torch.kernels`` are held against their plain
versions in ``repro_torch.kernels.ref``, which apply the same terms.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import tracing
from repro_torch.core import quantization as Q
from repro_torch.core.types import (
    ASHModel, ASHPayload, ASHStats, CoarseCodes, CoarseQueryPrep, QueryPrep,
)

from repro_torch.device import full_fp32, row_blocked

_EPS = 1e-12


def prepare_queries(model: ASHModel, q: torch.Tensor) -> QueryPrep:
    """One-time per-query work: q_breve = W q, <q, mu_c>, ||q||^2.
    ``q`` moves to the model's device.  Each row's terms are bit-equal
    however many rows are prepared with it (:func:`row_blocked`), so
    rows prepared apart and stacked equal rows prepared together."""
    with tracing.span("index.prep"):
        full_fp32()
        q32 = q.to(device=model.device, dtype=torch.float32)
        W_T, lm_T = model.W.T, model.landmarks.T
        q_proj, ipl, q_sq = row_blocked(
            lambda x: (x @ W_T, x @ lm_T, (x * x).sum(dim=-1)), q32)
        return QueryPrep(q=q32, q_proj=q_proj, ip_q_landmarks=ipl,
                         q_sq_norm=q_sq)


def _unpacked(payload: ASHPayload) -> torch.Tensor:
    return Q.unpack_codes(payload.codes, payload.d, payload.b).to(
        torch.float32
    )


def _recovered_full(model: ASHModel, payload: ASHPayload, V=None):
    """One decompression pass -> every Table-1 recovery, including the
    <W mu*, v> inner products."""
    if V is None:
        V = _unpacked(payload)
    cl = payload.cluster.long()
    vnorm = Q.code_norms(V)
    scale = payload.scale.to(torch.float32)
    offset = payload.offset.to(torch.float32)
    res_norm = scale * vnorm
    ip_Wmu_v = (model.W_landmarks[cl] * V).sum(dim=-1)
    ip_x_mu = offset + scale * ip_Wmu_v + model.landmark_sq_norms[cl]
    return V, vnorm, res_norm, ip_x_mu, ip_Wmu_v


def recovered_terms(model: ASHModel, payload: ASHPayload, V=None):
    """Recover (V float, ||v||, ||x-mu*||, <x, mu*>) from the payload."""
    return _recovered_full(model, payload, V)[:4]


def _x_sq_estimate(model, payload, vnorm, res_norm, ip_Wmu_v):
    """||x||^2 estimate of Eq. (A.5), shared by :func:`payload_stats`
    and :func:`score_cosine`."""
    return (
        res_norm**2
        + 2.0 * (res_norm / torch.clamp(vnorm, min=_EPS)) * ip_Wmu_v
        + model.landmark_sq_norms[payload.cluster.long()]
    )


def payload_stats(model: ASHModel, payload: ASHPayload) -> ASHStats:
    """The :class:`ASHStats` row statistics of a payload (one
    decompression pass, at build/add time)."""
    _, vnorm, res_norm, ip_x_mu, ip_Wmu_v = _recovered_full(model, payload)
    x_sq = _x_sq_estimate(model, payload, vnorm, res_norm, ip_Wmu_v)
    return ASHStats(
        res_norm=res_norm.to(torch.float32),
        ip_x_mu=ip_x_mu.to(torch.float32),
        x_sq=x_sq.to(torch.float32),
    )


# ---------------------------------------------------------------------------
# Symmetric int8 coarse pass (query quantizer + coarse operands)
# ---------------------------------------------------------------------------

# int8 query grid half-width; with |code| <= 255 (b = 8) every coarse
# partial sum stays below 2^24 for d_pad <= 512, so the integer
# accumulation is exact in int32 and in fp32 alike.
COARSE_QMAX = 127
_MEAN_CHUNK = 1 << 18  # rows unpacked at a time for the coarse mean


def coarse_codes(payload: ASHPayload) -> CoarseCodes:
    """The :class:`CoarseCodes` of a payload: the scale-weighted mean of
    the dequantized rows, unpacked in chunks of rows."""
    full_fp32()
    d_pad = payload.codes.shape[1] * Q.codes_per_word(payload.b)
    scale = payload.scale.to(torch.float32)
    total = torch.zeros(d_pad, dtype=torch.float32, device=scale.device)
    for r0 in range(0, payload.n, _MEAN_CHUNK):
        V = Q.unpack_codes(
            payload.codes[r0:r0 + _MEAN_CHUNK], d_pad, payload.b
        ).to(torch.float32)
        total += (scale[r0:r0 + _MEAN_CHUNK, None] * V).sum(dim=0)
    return CoarseCodes(mean=total / max(payload.n, 1))


def prepare_coarse_queries(prep: QueryPrep, mean: torch.Tensor
                           ) -> CoarseQueryPrep:
    """Symmetric int8 quantization of the projected queries: per-query
    scale ``s = max|q_proj| / 127`` (eps-guarded), codes
    ``round(q_proj / s)`` (half to even, as ``jnp.round``) clipped to
    [-127, 127], and ``q_corr = <q_proj - s * q_int8, mean[:d]>``."""
    full_fp32()
    qp = prep.q_proj.to(torch.float32)
    s = torch.clamp(qp.abs().amax(dim=-1), min=_EPS) / COARSE_QMAX
    qi = torch.clamp(torch.round(qp / s[..., None]), -COARSE_QMAX,
                     COARSE_QMAX)
    resid = qp - s[..., None] * qi
    mean = mean.to(torch.float32)[: qp.shape[-1]]
    return CoarseQueryPrep(
        q_int8=qi.to(torch.int8),
        q_scale=s,
        q_corr=row_blocked(lambda r: r @ mean, resid),
    )


def score_dot(
    model: ASHModel, prep: QueryPrep, payload: ASHPayload,
    *, rowwise: bool = False,
) -> torch.Tensor:
    """<q, x_i> approximation, Eq. (20): (m, n).

    rowwise=True computes the dot term as a broadcast-multiply and
    last-axis reduce instead of a matrix product: same values up to
    reduction order, with an order that does not depend on m.
    """
    return _score_dot_from_V(prep, payload, _unpacked(payload), rowwise)


def _score_dot_from_V(prep, payload, V, rowwise):
    full_fp32()
    if rowwise:
        dot = (prep.q_proj[:, None, :] * V[None, :, :]).sum(dim=-1)
    else:
        V_T = V.T
        dot = row_blocked(lambda q: q @ V_T, prep.q_proj)
    scale = payload.scale.to(torch.float32)[None, :]
    offset = payload.offset.to(torch.float32)[None, :]
    query_compute = prep.ip_q_landmarks[:, payload.cluster.long()]
    return scale * dot + query_compute + offset


def score_dot_1bit(
    model: ASHModel, prep: QueryPrep, payload: ASHPayload
) -> torch.Tensor:
    """1-bit masked-add formulation, Eq. (22): (m, n).  Equal to
    :func:`score_dot` at b = 1 up to rounding; mirrors the masked-load
    kernel."""
    if payload.b != 1:
        raise ValueError(f"score_dot_1bit takes b = 1, got b = {payload.b}")
    full_fp32()
    d = payload.d
    V = Q.unpack_codes(payload.codes, d, 1).to(torch.float32)
    Bmat = torch.div(V + 1, 2, rounding_mode="floor")  # bin() in {0, 1}
    sqrt_d = torch.sqrt(torch.tensor(float(d), dtype=torch.float32))
    scale_h = payload.scale.to(torch.float32)
    res_norm = scale_h * sqrt_d  # ||v|| = sqrt(d) for b = 1
    inv_sqrt_d = 1.0 / sqrt_d
    masked_add = prep.q_proj @ Bmat.T  # (m, n): sum of q_j where bit set
    sum_q = prep.q_proj.sum(dim=-1, keepdim=True)  # <q, 1>
    scale = 2.0 * inv_sqrt_d * res_norm[None, :]
    cl = payload.cluster.long()
    query_compute = (
        -inv_sqrt_d * res_norm[None, :] * sum_q
        + prep.ip_q_landmarks[:, cl]
    )
    ip_Wmu_2b1 = (model.W_landmarks[cl] * (2.0 * Bmat - 1.0)).sum(dim=-1)
    offset_terms = (
        # <x, mu*> recovered
        payload.offset.to(torch.float32)
        + scale_h * sqrt_d * inv_sqrt_d * ip_Wmu_2b1
        + model.landmark_sq_norms[cl]
        # minus d^-1/2 ||x-mu|| <W mu, 2b-1> - ||mu||^2  (Eq. 22 OFFSET)
        - inv_sqrt_d * res_norm * ip_Wmu_2b1
        - model.landmark_sq_norms[cl]
    )
    return scale * masked_add + query_compute + offset_terms[None, :]


def score_l2(
    model: ASHModel, prep: QueryPrep, payload: ASHPayload,
    *, rowwise: bool = False,
) -> torch.Tensor:
    """||q - x_i||^2 approximation (Appendix A): (m, n)."""
    V, _, res_norm, ip_x_mu = recovered_terms(model, payload)
    ip_qx = _score_dot_from_V(prep, payload, V, rowwise)
    cl = payload.cluster.long()
    mu_sq = model.landmark_sq_norms[cl]
    ip_q_mu = prep.ip_q_landmarks[:, cl]
    q_sq_mu = prep.q_sq_norm[:, None] - 2.0 * ip_q_mu + mu_sq[None, :]
    return (
        q_sq_mu
        + (res_norm**2)[None, :]
        - 2.0 * (ip_qx - ip_x_mu[None, :] - ip_q_mu + mu_sq[None, :])
    )


def score_cosine(
    model: ASHModel, prep: QueryPrep, payload: ASHPayload,
    *, rowwise: bool = False,
) -> torch.Tensor:
    """cosSim(q, x_i) using the norm estimate of Eq. (A.5): (m, n)."""
    V, vnorm, res_norm, _, ip_Wmu_v = _recovered_full(model, payload)
    ip_qx = _score_dot_from_V(prep, payload, V, rowwise)
    x_sq = _x_sq_estimate(model, payload, vnorm, res_norm, ip_Wmu_v)
    x_norm = torch.sqrt(torch.clamp(x_sq, min=_EPS))
    q_norm = torch.sqrt(torch.clamp(prep.q_sq_norm, min=_EPS))
    return ip_qx / (q_norm[:, None] * x_norm[None, :])


# ---------------------------------------------------------------------------
# Symmetric scoring (Appendix B) -- for graph-index construction
# ---------------------------------------------------------------------------


def score_symmetric_dot(
    model: ASHModel, pa: ASHPayload, pb: ASHPayload
) -> torch.Tensor:
    """<x, y> for two encoded sets (C == 1 assumed per Appendix B):
    (n_a, n_b), Eq. (B.2) with cosSim(quant(Wx~), quant(Wy~))."""
    full_fp32()
    Va, va_n, ra_n, ip_a_mu = recovered_terms(model, pa)
    Vb, vb_n, rb_n, ip_b_mu = recovered_terms(model, pb)
    cos = (Va @ Vb.T) / torch.clamp(va_n[:, None] * vb_n[None, :],
                                    min=_EPS)
    mu_sq = model.landmark_sq_norms[0]
    return (
        ra_n[:, None] * rb_n[None, :] * cos
        + ip_a_mu[:, None]
        + ip_b_mu[None, :]
        - mu_sq
    )


# ---------------------------------------------------------------------------
# Bias correction (Eq. 34)
# ---------------------------------------------------------------------------


def fit_bias(
    model: ASHModel,
    payload: ASHPayload,
    X: torch.Tensor,
    queries: torch.Tensor,
    sample: int = 100,
) -> ASHModel:
    """Least-squares (rho, beta) so that rho*<q,x> + beta ~ <q, x^>.

    Per the paper, a ~100-sample regression over the first ``sample``
    queries and rows; the correction (:func:`debias`) divides the
    estimate by rho after subtracting beta, for L2-faithful scores.
    Returns a new model with ``bias_rho``/``bias_beta`` set.
    """
    full_fp32()
    dev = model.device
    qs = queries[:sample].to(device=dev, dtype=torch.float32)
    xs = X[:sample].to(device=dev, dtype=torch.float32)
    sub = ASHPayload(b=payload.b, d=payload.d, **{
        f: getattr(payload, f)[:sample] for f in ASHPayload.ARRAY_FIELDS})
    prep = prepare_queries(model, qs)
    est = score_dot(model, prep, sub).reshape(-1)
    true = (qs @ xs.T).reshape(-1)
    A = torch.stack([true, torch.ones_like(true)], dim=1)
    coef = torch.linalg.lstsq(A, est[:, None]).solution[:, 0]
    return dataclasses.replace(model, bias_rho=coef[0], bias_beta=coef[1])


def debias(model: ASHModel, scores: torch.Tensor) -> torch.Tensor:
    """Apply the inverse linear correction to estimated dot products."""
    return (scores - model.bias_beta) / torch.clamp(model.bias_rho,
                                                    min=_EPS)
