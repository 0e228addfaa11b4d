"""Synthetic embedding data (counterpart of ``repro.data.synthetic``).

``embedding_dataset`` reproduces the paper's Table-4 non-isotropy:
anisotropic covariance (power-law spectrum), non-zero mean and cluster
structure; ``isotropy_diagnostics`` measures it.  Draws come from a
``torch.Generator`` seeded with ``seed`` on the target device, so a
million-row set is made on the card.
"""
from __future__ import annotations

import torch

from repro_torch.device import full_fp32, resolve_device


def embedding_dataset(
    n: int,
    D: int,
    *,
    seed: int = 0,
    device="cuda",
    spectrum_pow: float = 0.7,
    mean_shift: float = 0.5,
    n_clusters: int = 8,
    cluster_spread: float = 2.0,
    normalize: bool = False,
) -> torch.Tensor:
    """(n, D) f32 anisotropic, shifted, clustered embedding-like vectors."""
    dev = resolve_device(device)
    full_fp32()
    gen = torch.Generator(device=dev).manual_seed(seed)
    A = torch.randn(D, D, generator=gen, device=dev) * (
        torch.arange(1, D + 1, dtype=torch.float32, device=dev)
        ** -spectrum_pow
    )[None, :]
    centers = (
        torch.randn(n_clusters, D, generator=gen, device=dev) @ A.T
        * cluster_spread
    )
    assign = torch.randint(0, n_clusters, (n,), generator=gen, device=dev)
    X = torch.randn(n, D, generator=gen, device=dev) @ A.T
    X += centers[assign] + mean_shift
    if normalize:
        X /= torch.linalg.norm(X, dim=-1, keepdim=True)
    return X


def isotropy_diagnostics(X: torch.Tensor, sample: int = 2048) -> dict:
    """The paper's Table-4 statistics of ``X`` (on its device): min
    pairwise cosSim over the first ``sample`` rows, and ||mean||_inf."""
    full_fp32()
    Xs = X[:sample].to(torch.float32)
    Xn = Xs / torch.linalg.norm(Xs, dim=-1, keepdim=True)
    cos = Xn @ Xn.T
    return {
        "min_cos_sim": float(cos.min()),
        "mean_inf_norm": float(X.to(torch.float32).mean(0).abs().max()),
    }
