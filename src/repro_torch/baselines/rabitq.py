"""RaBitQ [Gao & Long 2024] / extended RaBitQ [Gao et al. 2025].

Counterpart of ``repro.baselines.rabitq``.  Per Section 2 of the ASH
paper these are exact special cases of the ASH model: D == d, C == 1,
W = random orthogonal rotation; b == 1 (RaBitQ) or b > 1 (extended).
They are thin wrappers over the ASH encoder with a data-agnostic model,
which doubles as the JL-random-W ablation of Figure 1 when d < D; the
state is an ``ASHModel``, so an ``AshIndex.from_parts(model, payload)``
searches it through the scan kernels.

Also provides ``expected_dot_1bit(D)``: the closed-form expectation
E_R[<x, quant_1(Rx)>] of Eq. (33).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import ash as A
from repro_torch.core import scoring as S
from repro_torch.core.types import ASHConfig, ASHModel


def train(
    gen: torch.Generator,
    X: torch.Tensor,
    b: int = 1,
    d: int = 0,
    center: bool = True,
    *,
    device="cuda",
) -> ASHModel:
    """RaBitQ state == data-agnostic ASH model (random W, C=1)."""
    D = X.shape[1]
    cfg = ASHConfig(b=b, d=(d or D), n_landmarks=1, store_fp16=True)
    return A.random_model(gen, D, cfg, X_for_landmarks=(X if center else None),
                          device=device)


def from_numpy(config: ASHConfig, arrays: dict, device="cuda") -> ASHModel:
    """The reference's RaBitQ model (an ``ASHModel``) from its arrays."""
    return ASHModel.from_numpy(config, arrays, device=device)


encode = A.encode  # identical payload


def score(model: ASHModel, payload, Qm: torch.Tensor) -> torch.Tensor:
    prep = S.prepare_queries(model, Qm)
    return S.score_dot(model, prep, payload)


def expected_dot_1bit(D: int) -> torch.Tensor:
    """Eq. (33): E_R[<x, quant_1(Rx)>]
    = 2 sqrt(D/pi) G(D/2) / ((D-1) G((D-1)/2)), in float32.

    ~0.798 for D ~ 1000."""
    Df = torch.tensor(float(D), dtype=torch.float32)
    log_ratio = (torch.special.gammaln(Df / 2.0)
                 - torch.special.gammaln((Df - 1.0) / 2.0))
    return (2.0 * torch.sqrt(Df / math.pi) * torch.exp(log_ratio)
            / (Df - 1.0))
