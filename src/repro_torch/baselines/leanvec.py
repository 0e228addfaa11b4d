"""LeanVec (in-distribution) [Tepper et al., TMLR 2024].

Counterpart of ``repro.baselines.leanvec``.  SVD/PCA dimensionality
reduction to d, then LVQ [Aguerrebere et al. 2023] per-vector min-max
scalar quantization of the reduced vectors.  The query is projected
too; scoring is <P q, LVQ(P x)>.  Quantization is a post-processing
step (the PCA is NOT refined by the quantizer) -- the drawback Section 4
of the ASH paper highlights.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import learning as L
from repro_torch.core.types import _tensor
from repro_torch.device import full_fp32, resolve_device

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class LeanVecState:
    b: int
    d: int
    P: torch.Tensor  # (d, D) top-d right singular vectors
    mean: torch.Tensor  # (D,) centering

    @property
    def bits_per_vector(self) -> int:
        return self.d * self.b + 2 * 16  # codes + (min, delta) fp16 pair


def from_numpy(*, b: int, d: int, P, mean, device="cuda") -> LeanVecState:
    """The reference state's fields (numpy) as a :class:`LeanVecState`."""
    dev = resolve_device(device)
    return LeanVecState(b=b, d=d, P=_tensor(P, dev, torch.float32),
                        mean=_tensor(mean, dev, torch.float32))


def train(gen: torch.Generator, X: torch.Tensor, d: int, b: int = 4, *,
          device="cuda") -> LeanVecState:
    """PCA of the centered data (``gen`` unused: the reference's key is
    unused too)."""
    del gen
    dev = resolve_device(device)
    full_fp32()
    X32 = X.to(device=dev, dtype=torch.float32)
    mean = X32.mean(dim=0)
    return LeanVecState(b=b, d=d, P=L.pca_topd(X32 - mean, d), mean=mean)


def encode(state: LeanVecState, X: torch.Tensor):
    """LVQ: per-vector [min, max] range, uniform levels (round half to
    even).  -> (codes (n, d) int32, vmin (n,), delta (n,))."""
    full_fp32()
    X32 = X.to(device=state.P.device, dtype=torch.float32)
    U = (X32 - state.mean) @ state.P.T  # (n, d)
    vmin = U.amin(dim=-1)
    vmax = U.amax(dim=-1)
    levels = 2**state.b - 1
    delta = (vmax - vmin) / levels
    codes = torch.clamp(
        torch.round((U - vmin[:, None]) / torch.clamp(delta, min=_EPS)[:, None]),
        0, levels,
    ).to(torch.int32)
    return codes, vmin, delta


def decode_reduced(state: LeanVecState, encoded) -> torch.Tensor:
    codes, vmin, delta = encoded
    return vmin[:, None] + codes.to(torch.float32) * delta[:, None]


def score(state: LeanVecState, encoded, Qm: torch.Tensor) -> torch.Tensor:
    """<P q, LVQ(P x)> + <q, mean>, the estimate of <q, x> (m, n)."""
    full_fp32()
    Q32 = Qm.to(device=state.P.device, dtype=torch.float32)
    Urecon = decode_reduced(state, encoded)  # (n, d)
    qproj = Q32 @ state.P.T  # project query (in-distribution)
    return qproj @ Urecon.T + (Q32 @ state.mean)[:, None]
