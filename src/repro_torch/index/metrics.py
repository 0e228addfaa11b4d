"""Ground truth and recall metrics for ANN evaluation."""
from __future__ import annotations

import torch

from repro_torch.device import full_fp32
from repro_torch.kernels.ref import stable_top_k


def exact_topk(Qm: torch.Tensor, X: torch.Tensor, k: int = 10,
               metric: str = "dot") -> tuple[torch.Tensor, torch.Tensor]:
    """Brute-force exact top-k on X's device: (scores, indices), each
    (m, k); ties to the lowest index.  metric: "dot" (MIPS), "l2"
    (negated squared distance, larger is better), "cos"."""
    full_fp32()
    Q32 = Qm.to(device=X.device, dtype=torch.float32)
    X32 = X.to(torch.float32)
    if metric == "dot":
        s = Q32 @ X32.T
    elif metric == "l2":
        s = -(
            (Q32 * Q32).sum(-1)[:, None]
            - 2 * Q32 @ X32.T
            + (X32 * X32).sum(-1)[None, :]
        )
    elif metric == "cos":
        s = (Q32 @ X32.T) / (
            torch.linalg.norm(Q32, dim=-1)[:, None]
            * torch.clamp(torch.linalg.norm(X32, dim=-1), min=1e-12)[None, :]
        )
    else:
        raise ValueError(metric)
    return stable_top_k(s, k)


def recall_at(retrieved: torch.Tensor, ground_truth: torch.Tensor,
              k_gt: int = 10) -> float:
    """k_gt-recall@R: |retrieved_R ∩ gt_{k_gt}| / k_gt, averaged over
    queries.  retrieved: (m, R) ids; ground_truth: (m, >= k_gt) ids."""
    gt = ground_truth[:, :k_gt].to(retrieved.device).long()
    hit = (retrieved.long()[:, :, None] == gt[:, None, :]).any(dim=1)
    return float((hit.sum(dim=-1).float() / k_gt).mean())


def recall_curve(retrieved, ground_truth, Rs=(10, 20, 50, 100), k_gt=10):
    """10-recall@R for several R (the paper's accuracy metric)."""
    return {
        R: recall_at(retrieved[:, :R], ground_truth, k_gt)
        for R in Rs
        if R <= retrieved.shape[1]
    }
