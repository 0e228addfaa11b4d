"""Learning the ASH parameters (Section 3 of the paper).

W = R @ P: P (d, D) the top-d PCA directions of the normalized
residuals; R in SO(d) refined by ITQ-style alternation, each step an
orthogonal Procrustes problem (``procrustes_svd``, or the SVD-free
``newton_schulz`` polar iteration).  Landmarks come from k-means
(k-means++ seeding + Lloyd).  Early stopping follows the paper's
Section 5 setup: at most 25 iterations, patience 3, absolute
loss-improvement threshold 1e-4, relative threshold 2.5e-3.

Random draws come from an explicit ``torch.Generator``: they are made
on the generator's device and moved to the data's, so one seeded CPU
generator gives the same draws whichever device trains.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import quantization as Q
from repro_torch.device import full_fp32

_EPS = 1e-12


# ---------------------------------------------------------------------------
# Orthogonal linear algebra
# ---------------------------------------------------------------------------


def random_rotation(gen: torch.Generator, d: int, device) -> torch.Tensor:
    """R(0): orthogonal polar factor of a standard normal matrix."""
    full_fp32()
    g = torch.randn(d, d, generator=gen, device=gen.device).to(device)
    u, _, vt = torch.linalg.svd(g, full_matrices=False)
    return u @ vt


def procrustes_svd(M: torch.Tensor) -> torch.Tensor:
    """argmax_{R orthogonal} Tr(R M) = V U^T for M = U S V^T."""
    u, _, vt = torch.linalg.svd(M, full_matrices=False)
    return vt.T @ u.T


def newton_schulz(M: torch.Tensor, steps: int = 12) -> torch.Tensor:
    """Polar factor of M^T by the quintic Newton-Schulz iteration (the
    same maximizer as :func:`procrustes_svd`, without an SVD)."""
    X = M.T
    X = X / (torch.linalg.norm(X) + _EPS)
    a, b, c = 3.4445, -4.7750, 2.0315  # Muon's quintic coefficients
    for _ in range(steps):
        A = X @ X.T
        B = b * A + c * (A @ A)
        X = a * X + B @ X
    return X


def pca_topd(X: torch.Tensor, d: int) -> torch.Tensor:
    """Top-d principal directions (rows) of X (n, D): P (d, D).

    Eigenvectors are defined up to sign (and order within repeated
    eigenvalues), so P matches the reference by subspace, not by entry.
    """
    full_fp32()
    cov = (X.T @ X).to(torch.float32)
    _, eigvecs = torch.linalg.eigh(cov)  # ascending
    return eigvecs.flip(-1)[:, :d].T.contiguous()


# ---------------------------------------------------------------------------
# k-means landmarks
# ---------------------------------------------------------------------------


def _kmeanspp_init(gen: torch.Generator, X: torch.Tensor, C: int):
    """k-means++ seeding (D^2 sampling by inverse CDF of uniform draws)."""
    n = X.shape[0]
    first = torch.randint(0, n, (1,), generator=gen, device=gen.device)
    u = torch.rand(max(C - 1, 0), generator=gen, device=gen.device).cpu()
    first = first.to(X.device)
    centroids = torch.zeros(C, X.shape[1], dtype=X.dtype, device=X.device)
    centroids[0] = X[first[0]]
    d2 = ((X - X[first]) ** 2).sum(dim=-1)
    for i in range(1, C):
        p = d2 / torch.clamp(d2.sum(), min=_EPS)
        # the CDF on the host: a 1-D float scan on the card (CUB's
        # decoupled look-back) adds in an order that changes from run to
        # run, which moved the sampled index and made training
        # irreproducible
        cdf = torch.cumsum(p.cpu(), dim=0)
        idx = torch.clamp(
            torch.searchsorted(cdf, u[i - 1 : i] * cdf[-1]), max=n - 1
        ).to(X.device)
        c_new = X[idx]  # (1, D)
        centroids[i] = c_new[0]
        d2 = torch.minimum(d2, ((X - c_new) ** 2).sum(dim=-1))
    return centroids


def assign_clusters(X: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest centroid per row (Eq. 13), int32; first index on ties."""
    full_fp32()
    d2 = -2.0 * X @ centroids.T + (centroids * centroids).sum(-1)[None, :]
    return torch.argmin(d2, dim=-1).to(torch.int32)


# Rows per one-hot block of :func:`segment_sum`: bounds the (C, rows)
# indicator matrix to 2^26 elements (256 MB in fp32).
_SEGMENT_ELEMS = 2**26


def segment_sum(X: torch.Tensor, seg: torch.Tensor, C: int) -> torch.Tensor:
    """sum of the rows of X (n, D) per segment id in [0, C): (C, D).

    Deterministic on every device: a product of a one-hot (C, rows)
    block with X, block by block in a fixed order.  ``index_add_`` on a
    CUDA tensor adds with float atomics in an order that changes from
    run to run, which made training on the card irreproducible.
    """
    full_fp32()
    sums = torch.zeros(C, X.shape[1], dtype=X.dtype, device=X.device)
    ids = torch.arange(C, device=X.device)[:, None]
    step = max(1, _SEGMENT_ELEMS // C)
    for i in range(0, X.shape[0], step):
        onehot = (seg[None, i:i + step] == ids).to(X.dtype)
        sums += onehot @ X[i:i + step]
    return sums


def lloyd_step(X: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """One Lloyd update; empty clusters keep their old centroid."""
    C = centroids.shape[0]
    assign = assign_clusters(X, centroids).long()
    sums = segment_sum(X, assign, C)
    counts = torch.bincount(assign, minlength=C).to(X.dtype)
    new = sums / torch.clamp(counts[:, None], min=1.0)
    return torch.where(counts[:, None] > 0, new, centroids)


def kmeans(
    gen: torch.Generator, X: torch.Tensor, C: int, iters: int = 25
) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's k-means. Returns (centroids (C, D), assignment (n,))."""
    if C == 1:
        mu = X.mean(dim=0, keepdim=True)
        return mu, torch.zeros(X.shape[0], dtype=torch.int32, device=X.device)
    centroids = _kmeanspp_init(gen, X, C)
    for _ in range(iters):
        centroids = lloyd_step(X, centroids)
    return centroids, assign_clusters(X, centroids)


# ---------------------------------------------------------------------------
# Residual normalization (Eq. 12)
# ---------------------------------------------------------------------------


def normalized_residuals(
    X: torch.Tensor,
    centroids: torch.Tensor,
    assign: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x~_i = (x_i - mu*_i) / ||x_i - mu*_i||.

    Returns (x_tilde (n, D), residual norm (n,), assign (n,) int32).
    """
    if assign is None:
        assign = assign_clusters(X, centroids)
    resid = X - centroids[assign.long()]
    norms = torch.linalg.norm(resid, dim=-1)
    x_tilde = resid / torch.clamp(norms, min=_EPS)[:, None]
    return x_tilde, norms, assign


# ---------------------------------------------------------------------------
# ITQ-style alternation (Section 3)
# ---------------------------------------------------------------------------


class ITQState(NamedTuple):
    R: torch.Tensor  # (d, d)
    loss: torch.Tensor  # scalar: negated objective of Eq. (24), normalized


def itq_step(
    R: torch.Tensor, Z: torch.Tensor, *, b: int,
    use_newton_schulz: bool = False,
) -> ITQState:
    """One alternation step; Z = x~ P^T (n, d).

    v_i = quant_b(R z_i);  M = sum_i ||v_i||^-1 z_i v_i^T;  R <- polar.
    """
    full_fp32()
    U = Z @ R.T
    V = Q.quant(U, b).to(torch.float32)
    vnorm = torch.clamp(torch.linalg.norm(V, dim=-1), min=_EPS)
    M = Z.T @ (V / vnorm[:, None])
    R_new = newton_schulz(M) if use_newton_schulz else procrustes_svd(M)
    obj = torch.trace(R_new @ M) / Z.shape[0]
    return ITQState(R=R_new, loss=-obj)


def learn_rotation(
    gen: torch.Generator,
    Z: torch.Tensor,
    b: int,
    *,
    max_iters: int = 25,
    patience: int = 3,
    abs_tol: float = 1e-4,
    rel_tol: float = 2.5e-3,
    use_newton_schulz: bool = False,
) -> tuple[torch.Tensor, list[float]]:
    """Full alternation with the paper's early-stopping rule.
    Returns (R, loss_history)."""
    R = random_rotation(gen, Z.shape[1], Z.device)
    history: list[float] = []
    best = float("inf")
    bad = 0
    for _ in range(max_iters):
        state = itq_step(R, Z, b=b, use_newton_schulz=use_newton_schulz)
        R = state.R
        loss = float(state.loss)
        history.append(loss)
        if best == float("inf"):
            improved = True
        else:
            improved = (best - loss) > max(abs_tol, rel_tol * abs(best))
        if improved:
            best, bad = loss, 0
        else:
            bad += 1
            if bad >= patience:
                break
    return R, history
