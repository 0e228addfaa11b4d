"""EDEN [Vargaftik et al. 2022] and TurboQuant [Zandieh et al. 2025].

Counterpart of ``repro.baselines.eden``.  Both: random rotation R, then
per-dimension b-bit Lloyd-Max scalar quantization (Eq. 30 of the ASH
paper).
  * EDEN scale: s = ||x||_2 / ||R^T w_LM(assign(Rx))||_2  (stored fp).
  * TurboQuant (MSE variant): s = 1, Lloyd-Max grid calibrated to the
    coordinate distribution (one global population std, ddof = 0, from
    the first 1,024 rotated rows, since TQ stores no per-vector scale).

The Lloyd-Max grid for N(0,1) is computed once by 1-D k-means over a
large deterministic Gaussian sample (:func:`lloyd_max_grid_np`, numpy,
a copy of the reference's).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core.types import _tensor
from repro_torch.device import full_fp32, resolve_device

_EPS = 1e-12


@functools.lru_cache(maxsize=None)
def lloyd_max_grid_np(b: int, n_samples: int = 200_000, iters: int = 60):
    """2^b-level Lloyd-Max quantizer grid for N(0,1), as a numpy array."""
    rng = np.random.RandomState(0)
    x = np.sort(rng.randn(n_samples).astype(np.float32))
    # quantile init
    qs = (np.arange(2**b) + 0.5) / (2**b)
    grid = np.quantile(x, qs).astype(np.float32)
    for _ in range(iters):
        mids = (grid[1:] + grid[:-1]) / 2
        idx = np.searchsorted(mids, x)
        sums = np.bincount(idx, weights=x, minlength=2**b)
        cnts = np.bincount(idx, minlength=2**b)
        grid = np.where(cnts > 0, sums / np.maximum(cnts, 1), grid).astype(
            np.float32
        )
    return grid


@dataclasses.dataclass(frozen=True)
class EDENState:
    b: int
    variant: str  # "eden" | "turboquant"
    rotation: torch.Tensor  # (D, D)
    grid: torch.Tensor  # (2^b,) Lloyd-Max levels (possibly rescaled)

    @property
    def bits_per_vector(self) -> int:
        D = self.rotation.shape[0]
        return D * self.b + (16 if self.variant == "eden" else 0)


def from_numpy(*, b: int, variant: str, rotation, grid,
               device="cuda") -> EDENState:
    """The reference state's fields (numpy) as an :class:`EDENState`."""
    dev = resolve_device(device)
    return EDENState(b=b, variant=variant,
                     rotation=_tensor(rotation, dev, torch.float32),
                     grid=_tensor(grid, dev, torch.float32))


def train(gen: torch.Generator, X: torch.Tensor, b: int,
          variant: str = "eden", *, device="cuda") -> EDENState:
    dev = resolve_device(device)
    full_fp32()
    X32 = X.to(device=dev, dtype=torch.float32)
    D = X32.shape[1]
    g = torch.randn(D, D, generator=gen, device=gen.device).to(dev)
    qmat, _ = torch.linalg.qr(g)
    grid = torch.as_tensor(lloyd_max_grid_np(b), device=dev)
    if variant == "turboquant":
        grid = calibrated_grid(grid, X32, qmat)
    return EDENState(b=b, variant=variant, rotation=qmat, grid=grid)


def calibrated_grid(grid: torch.Tensor, X32: torch.Tensor,
                    rotation: torch.Tensor) -> torch.Tensor:
    """TurboQuant's grid: the N(0,1) levels times the population std
    (ddof = 0, as ``jnp.std``) of the first 1,024 rotated rows (TQ
    stores no per-vector scale)."""
    full_fp32()
    sample = X32[: min(1024, X32.shape[0])] @ rotation
    return grid * torch.std(sample, correction=0)


def _nearest_level(grid: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    mids = (grid[1:] + grid[:-1]) / 2.0
    return torch.searchsorted(mids, y.contiguous(), right=False).to(
        torch.int32)


def encode(state: EDENState, X: torch.Tensor):
    """-> (codes (n, D) int32, scale (n,) fp32)."""
    full_fp32()
    X32 = X.to(device=state.rotation.device, dtype=torch.float32)
    Y = X32 @ state.rotation  # (n, D)
    if state.variant == "eden":
        norms = torch.linalg.norm(Y, dim=-1, keepdim=True)
        Yn = Y / torch.clamp(norms, min=_EPS) * torch.sqrt(
            torch.tensor(float(Y.shape[1]), dtype=torch.float32))
        codes = _nearest_level(state.grid, Yn)  # unit-variance coords
        rnorm = torch.linalg.norm(state.grid[codes.long()], dim=-1)
        return codes, norms[:, 0] / torch.clamp(rnorm, min=_EPS)
    codes = _nearest_level(state.grid, Y)
    return codes, torch.ones(X32.shape[0], dtype=torch.float32,
                             device=X32.device)


def decode(state: EDENState, encoded) -> torch.Tensor:
    codes, s = encoded
    return (s[:, None] * state.grid[codes.long()]) @ state.rotation.T


def score(state: EDENState, encoded, Qm: torch.Tensor) -> torch.Tensor:
    """<q, quant(x)> = s * <Rq, grid[codes]>  (m, n)."""
    full_fp32()
    codes, s = encoded
    Q32 = Qm.to(device=state.rotation.device, dtype=torch.float32)
    Qrot = Q32 @ state.rotation  # (m, D)
    return (Qrot @ state.grid[codes.long()].T) * s[None, :]
