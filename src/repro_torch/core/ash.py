"""ASH encoder/decoder and end-to-end training (Sections 2-3).

Encoder  g(x):  c* = nearest landmark; x~ = (x-mu*)/||x-mu*||;
                v = quant_b(W x~);  payload = (codes, SCALE, OFFSET, c*).
Decoder  f(v):  x^ = ||x-mu*|| * ||v||^-1 W^T v + mu*.

  SCALE  = ||v||^-1 ||x - mu*||
  OFFSET = <x, mu*> - SCALE * <W mu*, v> - ||mu*||^2      (Eq. 20)
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import learning as L
from repro_torch.core import quantization as Q
from repro_torch.core.types import ASHConfig, ASHModel, ASHPayload
from repro_torch.device import full_fp32, resolve_device, row_blocked

_EPS = 1e-12
_FP16_MAX = float(torch.finfo(torch.float16).max)
# Breakpoint-sweep elements per encode chunk: bounds quant_exact's
# (rows x d x (2^(b-1)-1)) working set to ~1 GB at any corpus size.
_ENCODE_CHUNK_ELEMS = 2**24
# Rows per block of encode's products (row_blocked): one size for every
# encode, large enough that a corpus takes few launches; a single added
# vector pays one 1024-row product.
_ENCODE_BLOCK = 1024


def _sample_rows(gen: torch.Generator, n: int, k: int, device):
    return torch.randperm(n, generator=gen, device=gen.device)[:k].to(device)


def _model(config: ASHConfig, W, centroids) -> ASHModel:
    one = torch.ones((), dtype=torch.float32, device=W.device)
    return ASHModel(
        config=config,
        W=W,
        landmarks=centroids,
        W_landmarks=centroids @ W.T,
        landmark_sq_norms=(centroids * centroids).sum(dim=-1),
        bias_rho=one,
        bias_beta=one * 0.0,
    )


def train(
    gen: torch.Generator,
    X: torch.Tensor,
    config: ASHConfig,
    *,
    device="cuda",
    train_sample: Optional[int] = None,
    landmark_sample: Optional[int] = None,
    max_iters: int = 25,
    use_newton_schulz: bool = False,
    kmeans_iters: int = 25,
) -> tuple[ASHModel, list[float]]:
    """Learn landmarks + W = R P from data, on ``device``.

    W is learned on a subsample of max(10*D, 4096) vectors (10x
    covariance oversampling), PCA init for P, random-rotation init for
    R, <= 25 alternation iterations with early stopping.  k-means runs
    on the full set unless ``landmark_sample`` caps it.
    """
    dev = resolve_device(device)
    full_fp32()
    n, D = X.shape
    d = config.d if config.d > 0 else D
    if d > D:
        raise ValueError(f"target dim {d} exceeds input dim {D}")
    config = ASHConfig(
        b=config.b, d=d, n_landmarks=config.n_landmarks,
        store_fp16=config.store_fp16,
    )
    X = X.to(dev)
    if landmark_sample is not None and landmark_sample < n:
        X_lm = X[_sample_rows(gen, n, landmark_sample, dev)].float()
    else:
        X_lm = X.float()
    centroids, _ = L.kmeans(gen, X_lm, config.n_landmarks, iters=kmeans_iters)

    if train_sample is None:
        train_sample = min(n, max(10 * D, 4096))
    if train_sample < n:
        Xt = X[_sample_rows(gen, n, train_sample, dev)].float()
    else:
        Xt = X.float()
    x_tilde, _, _ = L.normalized_residuals(Xt, centroids)
    P = L.pca_topd(x_tilde, d)
    Z = x_tilde @ P.T
    R, history = L.learn_rotation(
        gen, Z, config.b, max_iters=max_iters,
        use_newton_schulz=use_newton_schulz,
    )
    W = (R @ P).to(torch.float32).contiguous()
    return _model(config, W, centroids), history


def random_model(
    gen: torch.Generator, D: int, config: ASHConfig, X_for_landmarks=None,
    *, device="cuda",
) -> ASHModel:
    """Data-agnostic ASH: W = random row-orthonormal (JL baseline)."""
    dev = resolve_device(device)
    full_fp32()
    d = config.d if config.d > 0 else D
    config = ASHConfig(
        b=config.b, d=d, n_landmarks=config.n_landmarks,
        store_fp16=config.store_fp16,
    )
    g = torch.randn(D, D, generator=gen, device=gen.device).to(dev)
    qmat, _ = torch.linalg.qr(g)
    W = qmat[:, :d].T.contiguous()
    if X_for_landmarks is not None and config.n_landmarks > 1:
        centroids, _ = L.kmeans(
            gen, X_for_landmarks.to(dev).float(), config.n_landmarks
        )
    elif X_for_landmarks is not None:
        centroids = X_for_landmarks.to(dev).float().mean(dim=0, keepdim=True)
    else:
        centroids = torch.zeros(config.n_landmarks, D, device=dev)
    return _model(config, W, centroids)


def _encode_rows(model: ASHModel, X32: torch.Tensor, exact: bool):
    cfg = model.config
    W_T = model.W.T

    def project(x):  # the landmark assignment and the projection
        x_tilde, res_norm, assign = L.normalized_residuals(
            x, model.landmarks)
        return x_tilde @ W_T, res_norm, assign

    # over fixed-shape row blocks (row_blocked): a row encodes alike
    # however many rows are encoded with it
    U, res_norm, assign = row_blocked(project, X32, block=_ENCODE_BLOCK)
    V = Q.quant(U, cfg.b, exact=exact)
    vnorm = torch.clamp(Q.code_norms(V), min=_EPS)
    scale = res_norm / vnorm
    cl = assign.long()
    ip_x_mu = (X32 * model.landmarks[cl]).sum(dim=-1)
    ip_Wmu_v = (model.W_landmarks[cl] * V.to(torch.float32)).sum(dim=-1)
    offset = ip_x_mu - scale * ip_Wmu_v - model.landmark_sq_norms[cl]
    return Q.pack_codes(V, cfg.b), scale, offset, assign


def encode(model: ASHModel, X: torch.Tensor, exact: bool = True) -> ASHPayload:
    """Encode database vectors into the ASH payload (Table 1), on the
    model's device, in row chunks that bound the quantizer's memory."""
    full_fp32()
    cfg = model.config
    X = X.to(model.device)
    per_row = cfg.d * max(1, 2 ** (cfg.b - 1) - 1)
    chunk = max(1, _ENCODE_CHUNK_ELEMS // per_row)
    parts = [
        _encode_rows(model, X[i : i + chunk].to(torch.float32), exact)
        for i in range(0, X.shape[0], chunk)
    ]
    codes, scale, offset, assign = (torch.cat(p) for p in zip(*parts))
    # IEEE fp16 (10-bit mantissa) headers, Table 1; clipped into the
    # fp16-finite range so extreme-norm rows lose precision instead of
    # overflowing to inf and poisoning every score of the row.
    if cfg.store_fp16:
        scale = torch.clamp(scale, 0.0, _FP16_MAX).to(torch.float16)
        offset = torch.clamp(offset, -_FP16_MAX, _FP16_MAX).to(torch.float16)
    return ASHPayload(
        b=cfg.b, d=cfg.d, codes=codes, scale=scale, offset=offset,
        cluster=assign,
    )


def decode(model: ASHModel, payload: ASHPayload) -> torch.Tensor:
    """Reconstruct x^ = ||x-mu*|| ||v||^-1 W^T v + mu* from the payload."""
    full_fp32()
    V = Q.unpack_codes(payload.codes, payload.d, payload.b).to(torch.float32)
    vn = Q.code_norms(V)
    x_tilde_hat = (V / torch.clamp(vn, min=_EPS)[:, None]) @ model.W
    res_norm = payload.scale.to(torch.float32) * vn
    return (
        res_norm[:, None] * x_tilde_hat
        + model.landmarks[payload.cluster.long()]
    )


def reconstruction_error(model: ASHModel, X: torch.Tensor) -> torch.Tensor:
    """Mean squared reconstruction error of the normalized residuals
    (Eq. 5/14), the quantity the learning minimizes."""
    full_fp32()
    X32 = X.to(device=model.device, dtype=torch.float32)
    x_tilde, _, _ = L.normalized_residuals(X32, model.landmarks)
    V = Q.quant(x_tilde @ model.W.T, model.config.b).to(torch.float32)
    vnorm = torch.clamp(Q.code_norms(V), min=_EPS)
    x_hat = (V / vnorm[:, None]) @ model.W
    return ((x_tilde - x_hat) ** 2).sum(dim=-1).mean()
