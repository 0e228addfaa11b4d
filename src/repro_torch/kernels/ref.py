"""Plain PyTorch versions of the CUDA kernels (the dense half).

Each function here computes what one kernel computes, with torch
operations: the kernel wrappers run them for CPU tensors, and the
tests and ``chip_smoke.py`` hold the kernels against them on the card.
Selection follows the reference's ``lax.top_k`` convention: score
descending, lowest id first on ties, done with STABLE sorts
(``torch.topk`` orders ties differently).
"""
from __future__ import annotations

import torch

from repro_torch.core import quantization as Q
from repro_torch.device import full_fp32

ID_SENTINEL = 2**31 - 1  # id of an exhausted selection slot
TOPK_BLOCK_N = 512  # rows per selection tile (as the reference's block_n)


def ash_score_ref(
    codes: torch.Tensor,  # (n, Wd) int32 packed words
    q_proj: torch.Tensor,  # (m, d_pad) zero-padded query projections
    scale: torch.Tensor,  # (n,)
    offset: torch.Tensor,  # (n,)
    cluster: torch.Tensor,  # (n,) int32
    ip_q_landmarks: torch.Tensor,  # (m, C)
    b: int,
) -> torch.Tensor:
    """Asymmetric ASH scores (Eq. 20): (m, n) f32.  d_pad is implied by
    the packed width; the pad lanes of q_proj must be zero."""
    full_fp32()
    d_pad = codes.shape[1] * Q.codes_per_word(b)
    V = Q.unpack_codes(codes, d_pad, b).to(torch.float32)
    dot = q_proj.to(torch.float32) @ V.T
    bias = ip_q_landmarks.to(torch.float32)[:, cluster.long()]
    return (
        dot * scale.to(torch.float32)[None, :]
        + bias
        + offset.to(torch.float32)[None, :]
    )


def ash_score_metric_ref(
    codes, q_proj, scale, offset, cluster, ip_q_landmarks,
    qterm, rowterm, b: int, metric: str = "dot",
) -> torch.Tensor:
    """Metric-epilogue scores, higher-is-better, in the kernels' op
    order: dot: base; l2: (2*base - qterm) - rowterm; cos:
    (base * qterm) * rowterm."""
    base = ash_score_ref(
        codes, q_proj, scale, offset, cluster, ip_q_landmarks, b
    )
    if metric == "dot":
        return base
    qcol = qterm.to(torch.float32)[:, None]
    rrow = rowterm.to(torch.float32)[None, :]
    if metric == "l2":
        return (2.0 * base - qcol) - rrow
    if metric == "cos":
        return (base * qcol) * rrow
    raise ValueError(metric)


def row_mask(n: int, n_valid=None, row_valid=None, device=None):
    """(n,) bool validity folding ``row_valid`` (0 = tombstone) and
    ``n_valid`` (rows at/beyond it are padding); None if neither."""
    if n_valid is None and row_valid is None:
        return None
    ok = torch.ones(n, dtype=torch.bool, device=device)
    if row_valid is not None:
        ok = ok & row_valid.to(device=device, dtype=torch.bool)
    if n_valid is not None:
        ok = ok & (torch.arange(n, device=device) < int(n_valid))
    return ok


def mask_rows_ref(scores: torch.Tensor, n_valid=None, row_valid=None):
    """Force masked columns to -inf (the materialized-path equivalent of
    the fused kernel's runtime mask operand)."""
    ok = row_mask(scores.shape[-1], n_valid, row_valid, scores.device)
    if ok is None:
        return scores
    return torch.where(ok[None, :], scores, float("-inf"))


def stable_top_k(scores: torch.Tensor, k: int):
    """Top-k along the last axis by (score desc, index asc): the
    ``lax.top_k`` order.  Returns (values, int64 indices)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_geometry(n: int, k: int, k_tilde=None):
    """(n_blocks, k_tilde, block_n) of the fused selection, as the
    reference computes them: tiles of block_n = min(512,
    round_up(n, 128)) rows, k_tilde defaulting to k and clipped to the
    tile; raises when k exceeds the n_blocks * k_tilde strip."""
    block_n = min(TOPK_BLOCK_N, -(-n // 128) * 128)
    n_blocks = -(-n // block_n)
    k_tilde = min(k if k_tilde is None else k_tilde, block_n)
    if k > n_blocks * k_tilde:
        raise ValueError(
            f"k={k} exceeds the {n_blocks} x k_tilde={k_tilde} candidate "
            f"strip; raise k_tilde or use the materializing kernel"
        )
    return n_blocks, k_tilde, block_n


def merge_strip(vals: torch.Tensor, ids: torch.Tensor, k: int):
    """Merge a (m, n_blocks * k_tilde) candidate strip into the top-k by
    (score desc, id asc): a stable sort by id, then a stable sort by
    score; sentinel ids become -1."""
    order = torch.sort(ids, dim=1, stable=True).indices
    vals, ids = vals.gather(1, order), ids.gather(1, order)
    order = torch.sort(vals, dim=1, descending=True, stable=True).indices
    out_s = vals.gather(1, order)[:, :k]
    out_i = ids.gather(1, order)[:, :k]
    return out_s, torch.where(out_i == ID_SENTINEL, -1, out_i)


def ash_score_topk_ref(
    codes, q_proj, scale, offset, cluster, ip_q_landmarks,
    qterm, rowterm, mask, *, b: int, k: int, k_tilde=None,
    metric: str = "dot",
):
    """Plain version of the fused scan + selection kernel: (m, k) f32
    scores and int32 ids.

    Scores every row, then per 512-row tile keeps the partial top-k_tilde
    of (score desc, id asc) among valid rows (``mask`` (n,) nonzero, or
    all rows when None): rows scoring -inf are still emitted once each,
    masked rows never.  Exhausted slots carry the sentinel id; the strip
    is merged by :func:`merge_strip`.  Equal to a stable top-k of the
    masked scores whenever k <= k_tilde.
    """
    n = codes.shape[0]
    m = q_proj.shape[0]
    n_blocks, k_tilde, block_n = topk_geometry(n, k, k_tilde)
    scores = ash_score_metric_ref(
        codes, q_proj, scale, offset, cluster, ip_q_landmarks,
        qterm, rowterm, b=b, metric=metric,
    )
    n_p = n_blocks * block_n
    valid = torch.ones(n, dtype=torch.bool, device=scores.device)
    if mask is not None:
        valid = mask.to(device=scores.device) != 0
    valid = torch.nn.functional.pad(valid, (0, n_p - n), value=False)
    scores = torch.nn.functional.pad(
        scores, (0, n_p - n), value=float("-inf")
    ).reshape(m, n_blocks, block_n)
    valid = valid.reshape(1, n_blocks, block_n).expand(m, -1, -1)
    # per tile: score desc (stable: lowest column first on ties), then
    # valid rows ahead of masked ones (stable again)
    order = torch.sort(scores, dim=2, descending=True, stable=True).indices
    v_ord = valid.gather(2, order)
    second = torch.sort((~v_ord).to(torch.int8), dim=2, stable=True).indices
    order = order.gather(2, second)[:, :, :k_tilde]
    tile_vals = scores.gather(2, order)
    tile_ok = valid.gather(2, order)
    col0 = (torch.arange(n_blocks, device=scores.device) * block_n)[
        None, :, None
    ]
    tile_ids = torch.where(tile_ok, order + col0, ID_SENTINEL)
    tile_vals = torch.where(tile_ok, tile_vals, float("-inf"))
    return merge_strip(
        tile_vals.reshape(m, -1),
        tile_ids.reshape(m, -1).to(torch.int32),
        k,
    )
