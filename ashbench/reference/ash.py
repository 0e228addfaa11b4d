"""ASH training and encoding in plain PyTorch (the paper's Sections 2-3).

Encoder  g(x):  c* = nearest landmark; x~ = (x-mu*)/||x-mu*||;
                v = quant_b(W x~);  payload = (codes, SCALE, OFFSET, c*).
  SCALE  = ||v||^-1 ||x - mu*||
  OFFSET = <x, mu*> - SCALE * <W mu*, v> - ||mu*||^2      (Eq. 20)

W = R P: P the top-d PCA directions of the normalized residuals, R
refined by ITQ-style alternation (orthogonal Procrustes by SVD, at most
25 steps, patience 3, thresholds 1e-4 absolute and 2.5e-3 relative);
landmarks by k-means++ seeding and 25 Lloyd steps.  Every random draw
comes from the caller's generator in a fixed order, every reduction
that could change order from run to run is done in a fixed order (the
k-means++ CDF on the host, cluster sums as one-hot products), and row
products run over fixed 1,024-row blocks: the same rows and seed give
the same model and codes bit for bit on one device.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

_EPS = 1e-12
_QEPS = 1e-30
_FP16_MAX = float(torch.finfo(torch.float16).max)
_ENCODE_CHUNK_ELEMS = 2**24  # breakpoint-sweep elements per encode chunk
_ENCODE_BLOCK = 1024  # rows per product block of encode
_SEGMENT_ELEMS = 2**26  # one-hot elements per block of a cluster sum


@contextlib.contextmanager
def precision(tf32: bool = False):
    """Float32 products in full float32 (``tf32=False``) or in TF32,
    the control's precision; the previous setting is restored."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def row_blocked(fn, *rows: torch.Tensor, block: int):
    """``fn(*rows)`` over ``block`` rows at a time (the last block
    zero-padded), so a row's result does not depend on the rows beside
    it."""
    m = rows[0].shape[0]
    if m == 0:
        return fn(*rows)
    full = m - m % block
    blocks = [fn(*(r[i:i + block].contiguous() for r in rows))
              for i in range(0, full, block)]
    if full < m:
        pad = block - (m - full)
        blocks.append(fn(*(
            torch.nn.functional.pad(r[full:], (0, 0) * (r.dim() - 1)
                                    + (0, pad)) for r in rows)))

    def join(parts):
        return (parts[0] if len(parts) == 1 else torch.cat(parts))[:m]

    if isinstance(blocks[0], tuple):
        return tuple(join(parts) for parts in zip(*blocks))
    return join(blocks)


# ---------------------------------------------------------------------------
# The quantizer onto the odd-integer grid V_b and the bit packing
# ---------------------------------------------------------------------------


def quant(u: torch.Tensor, b: int) -> torch.Tensor:
    """Exact argmax_{v in V_b^d} cosSim(v, u) by the sorted breakpoint
    sweep (b <= 6); stable order of tied breakpoints, first maximum."""
    if b == 1:
        return torch.where(u >= 0, 1, -1).to(torch.int32)
    if b > 6:
        raise ValueError(f"the reference quantizer takes b <= 6, got {b}")
    d = u.shape[-1]
    a = u.reshape(-1, d).to(torch.float32).abs()
    N = a.shape[0]
    sgn = torch.where(u.reshape(-1, d) >= 0, 1, -1).to(torch.int32)
    n_bp = 2 ** (b - 1) - 1
    m = torch.arange(1, n_bp + 1, dtype=torch.float32, device=u.device)
    t = (2.0 * m[None, None, :]) / torch.clamp(a[:, :, None], min=_QEPS)
    dS1 = (2.0 * a[:, :, None]).expand(N, d, n_bp).reshape(N, -1)
    dS2 = (8.0 * m).expand(N, d, n_bp).reshape(N, -1)
    order = torch.argsort(t.reshape(N, -1), dim=1, stable=True)
    sum_a = a.sum(dim=1, keepdim=True)
    S1 = torch.cumsum(torch.gather(dS1, 1, order), dim=1) + sum_a
    S2 = torch.cumsum(torch.gather(dS2, 1, order), dim=1) + d
    obj0 = sum_a / torch.sqrt(torch.full((), float(d), device=u.device))
    obj = torch.cat([obj0, S1 / torch.sqrt(S2)], dim=1)
    k_star = torch.argmax(obj, dim=1)
    ranks = torch.empty_like(order)
    ranks.scatter_(
        1, order,
        torch.arange(order.shape[1], device=u.device).expand(N, -1),
    )
    taken = (ranks < k_star[:, None]).reshape(N, d, n_bp)
    mag = 1 + 2 * taken.sum(dim=2, dtype=torch.int32)
    return (sgn * mag).to(torch.int32).reshape(u.shape)


def code_norms(values: torch.Tensor) -> torch.Tensor:
    v = values.to(torch.float32)
    return torch.sqrt(torch.sum(v * v, dim=-1))


def pack(values: torch.Tensor, b: int) -> torch.Tensor:
    """Grid values (n, d) -> packed words (n, ceil(d / (32/b))), int32
    bit patterns, code j of a word in bits [j*b, (j+1)*b) as its level
    (value + 2^b - 1) / 2."""
    levels = torch.div(values.to(torch.int32) + (2**b - 1), 2,
                       rounding_mode="floor").to(torch.int64)
    k = 32 // b
    d = levels.shape[-1]
    n_words = -(-d // k)
    if n_words * k > d:
        levels = torch.nn.functional.pad(levels, (0, n_words * k - d))
    grouped = levels.reshape(levels.shape[:-1] + (n_words, k))
    shifts = torch.arange(k, dtype=torch.int64, device=values.device) * b
    words = (grouped << shifts).sum(dim=-1)
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32)


def unpack(words: torch.Tensor, d: int, b: int) -> torch.Tensor:
    """Packed words -> (..., d) int32 grid values."""
    k = 32 // b
    shifts = torch.arange(k, dtype=torch.int32, device=words.device) * b
    grouped = (words.to(torch.int32)[..., None] >> shifts) & (2**b - 1)
    levels = grouped.reshape(words.shape[:-1] + (-1,))[..., :d]
    return (2 * levels - (2**b - 1)).to(torch.int32)


# ---------------------------------------------------------------------------
# Landmarks (k-means) and the learned projection
# ---------------------------------------------------------------------------


def assign(X: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest centroid per row, int32, first index on ties."""
    d2 = -2.0 * X @ centroids.T + (centroids * centroids).sum(-1)[None, :]
    return torch.argmin(d2, dim=-1).to(torch.int32)


def _segment_sum(X, seg, C):
    sums = torch.zeros(C, X.shape[1], dtype=X.dtype, device=X.device)
    ids = torch.arange(C, device=X.device)[:, None]
    step = max(1, _SEGMENT_ELEMS // C)
    for i in range(0, X.shape[0], step):
        onehot = (seg[None, i:i + step] == ids).to(X.dtype)
        sums += onehot @ X[i:i + step]
    return sums


def _kmeanspp(gen, X, C):
    n = X.shape[0]
    first = torch.randint(0, n, (1,), generator=gen, device=gen.device)
    u = torch.rand(max(C - 1, 0), generator=gen, device=gen.device).cpu()
    first = first.to(X.device)
    centroids = torch.zeros(C, X.shape[1], dtype=X.dtype, device=X.device)
    centroids[0] = X[first[0]]
    d2 = ((X - X[first]) ** 2).sum(dim=-1)
    for i in range(1, C):
        p = d2 / torch.clamp(d2.sum(), min=_EPS)
        cdf = torch.cumsum(p.cpu(), dim=0)
        idx = torch.clamp(
            torch.searchsorted(cdf, u[i - 1:i] * cdf[-1]), max=n - 1
        ).to(X.device)
        c_new = X[idx]
        centroids[i] = c_new[0]
        d2 = torch.minimum(d2, ((X - c_new) ** 2).sum(dim=-1))
    return centroids


def kmeans(gen, X, C, iters=25):
    """k-means++ seeding and ``iters`` Lloyd steps; empty clusters keep
    their centroid."""
    if C == 1:
        return X.mean(dim=0, keepdim=True)
    centroids = _kmeanspp(gen, X, C)
    for _ in range(iters):
        a = assign(X, centroids).long()
        sums = _segment_sum(X, a, C)
        counts = torch.bincount(a, minlength=C).to(X.dtype)
        new = sums / torch.clamp(counts[:, None], min=1.0)
        centroids = torch.where(counts[:, None] > 0, new, centroids)
    return centroids


def normalized_residuals(X, centroids):
    a = assign(X, centroids)
    resid = X - centroids[a.long()]
    norms = torch.linalg.norm(resid, dim=-1)
    return resid / torch.clamp(norms, min=_EPS)[:, None], norms, a


def _learn_rotation(gen, Z, b, max_iters=25, patience=3, abs_tol=1e-4,
                    rel_tol=2.5e-3):
    d = Z.shape[1]
    g = torch.randn(d, d, generator=gen, device=gen.device).to(Z.device)
    u, _, vt = torch.linalg.svd(g, full_matrices=False)
    R = u @ vt
    best, bad = float("inf"), 0
    for _ in range(max_iters):
        V = quant(Z @ R.T, b).to(torch.float32)
        vnorm = torch.clamp(torch.linalg.norm(V, dim=-1), min=_EPS)
        M = Z.T @ (V / vnorm[:, None])
        u, _, vt = torch.linalg.svd(M, full_matrices=False)
        R = vt.T @ u.T
        loss = float(-(torch.trace(R @ M) / Z.shape[0]))
        if best == float("inf") or (best - loss) > max(abs_tol,
                                                       rel_tol * abs(best)):
            best, bad = loss, 0
        else:
            bad += 1
            if bad >= patience:
                break
    return R


@dataclasses.dataclass(frozen=True)
class Model:
    b: int
    d: int
    W: torch.Tensor  # (d, D)
    landmarks: torch.Tensor  # (C, D)
    W_landmarks: torch.Tensor  # (C, d)
    landmark_sq_norms: torch.Tensor  # (C,)


def _sample(gen, n, k, device):
    return torch.randperm(n, generator=gen, device=gen.device)[:k].to(device)


def train(gen: torch.Generator, X: torch.Tensor, *, b: int, d: int,
          n_landmarks: int, landmark_sample: Optional[int] = None) -> Model:
    """Landmarks, then W = R P, from the rows ``X`` (on their device)."""
    n, D = X.shape
    if landmark_sample is not None and landmark_sample < n:
        X_lm = X[_sample(gen, n, landmark_sample, X.device)].float()
    else:
        X_lm = X.float()
    centroids = kmeans(gen, X_lm, n_landmarks)
    train_sample = min(n, max(10 * D, 4096))
    if train_sample < n:
        Xt = X[_sample(gen, n, train_sample, X.device)].float()
    else:
        Xt = X.float()
    x_tilde, _, _ = normalized_residuals(Xt, centroids)
    cov = (x_tilde.T @ x_tilde).to(torch.float32)
    _, eigvecs = torch.linalg.eigh(cov)
    P = eigvecs.flip(-1)[:, :d].T.contiguous()
    R = _learn_rotation(gen, x_tilde @ P.T, b)
    W = (R @ P).to(torch.float32).contiguous()
    return Model(b=b, d=d, W=W, landmarks=centroids,
                 W_landmarks=centroids @ W.T,
                 landmark_sq_norms=(centroids * centroids).sum(dim=-1))


@dataclasses.dataclass(frozen=True)
class Payload:
    codes: torch.Tensor  # (n, Wd) int32 packed words
    scale: torch.Tensor  # (n,) fp16
    offset: torch.Tensor  # (n,) fp16
    cluster: torch.Tensor  # (n,) int32


def _encode_rows(model: Model, X32: torch.Tensor):
    W_T = model.W.T

    def project(x):
        x_tilde, res_norm, a = normalized_residuals(x, model.landmarks)
        return x_tilde @ W_T, res_norm, a

    U, res_norm, a = row_blocked(project, X32, block=_ENCODE_BLOCK)
    V = quant(U, model.b)
    scale = res_norm / torch.clamp(code_norms(V), min=_EPS)
    cl = a.long()
    ip_x_mu = (X32 * model.landmarks[cl]).sum(dim=-1)
    ip_Wmu_v = (model.W_landmarks[cl] * V.to(torch.float32)).sum(dim=-1)
    offset = ip_x_mu - scale * ip_Wmu_v - model.landmark_sq_norms[cl]
    return pack(V, model.b), scale, offset, a


def encode(model: Model, X: torch.Tensor) -> Payload:
    """The payload of Table 1 with fp16 SCALE/OFFSET headers, clipped to
    the fp16-finite range."""
    per_row = model.d * max(1, 2 ** (model.b - 1) - 1)
    chunk = max(1, _ENCODE_CHUNK_ELEMS // per_row)
    parts = [_encode_rows(model, X[i:i + chunk].to(torch.float32))
             for i in range(0, X.shape[0], chunk)]
    codes, scale, offset, a = (torch.cat(p) for p in zip(*parts))
    return Payload(
        codes=codes,
        scale=torch.clamp(scale, 0.0, _FP16_MAX).to(torch.float16),
        offset=torch.clamp(offset, -_FP16_MAX, _FP16_MAX).to(torch.float16),
        cluster=a,
    )
