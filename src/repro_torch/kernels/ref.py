"""Plain PyTorch versions of the CUDA kernels.

Each function here computes what one kernel computes, with torch
operations: the kernel wrappers run them for CPU tensors, and the
tests and ``chip_smoke.py`` hold the kernels against them on the card.
Selection follows the reference's ``lax.top_k`` convention: score
descending, lowest id (or candidate position) first on ties, done with
STABLE sorts (``torch.topk`` orders ties differently).

The dense scan and its fused selection (kernels 1-2), the gathered
scan over per-query candidate rows and its fused selection (kernels
3-4), the symmetric int8 coarse scan and its fused selection (kernels
5-6), the gathered coarse scan, which has no kernel (the
reference's is oracle-only too), and decode attention over an
ASH-compressed KV cache (kernel 7).
"""
from __future__ import annotations

import torch

from repro_torch.core import quantization as Q
from repro_torch.device import full_fp32

ID_SENTINEL = 2**31 - 1  # id of an exhausted selection slot
TOPK_BLOCK_N = 512  # rows per selection tile (as the reference's block_n)
GATHER_CHUNK = 1 << 16  # candidate positions unpacked at a time


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


def _metric_tail(base, qcol, rrow, metric: str) -> torch.Tensor:
    """The kernels' metric epilogue over an Eq. 20 base: dot: base;
    l2: (2*base - qterm) - rowterm; cos: (base * qterm) * rowterm."""
    if metric == "dot":
        return base
    if metric == "l2":
        return (2.0 * base - qcol) - rrow
    if metric == "cos":
        return (base * qcol) * rrow
    raise ValueError(metric)


def ash_score_metric_ref(
    codes, q_proj, scale, offset, cluster, ip_q_landmarks,
    qterm, rowterm, b: int, metric: str = "dot",
) -> torch.Tensor:
    """Metric-epilogue scores, higher-is-better, in the kernels' op
    order (:func:`_metric_tail`)."""
    base = ash_score_ref(
        codes, q_proj, scale, offset, cluster, ip_q_landmarks, b
    )
    if metric == "dot":
        return base
    return _metric_tail(base, qterm.to(torch.float32)[:, None],
                        rowterm.to(torch.float32)[None, :], metric)


def _gathered_dot(codes, safe, q, b: int) -> torch.Tensor:
    """(m, R) rowwise sums sum_k q[i, k] * v[safe[i, t], k] over the
    unpacked code rows of a candidate table, GATHER_CHUNK positions at a
    time (a broadcast multiply and last-axis sum: each row's value does
    not depend on the batch)."""
    m, R = safe.shape
    d_pad = codes.shape[1] * Q.codes_per_word(b)
    q = q.to(torch.float32)
    out = torch.empty(m, R, dtype=torch.float32, device=q.device)
    for t0 in range(0, R, GATHER_CHUNK):
        sl = safe[:, t0:t0 + GATHER_CHUNK]
        V = Q.unpack_codes(codes[sl.reshape(-1)], d_pad, b).to(
            torch.float32).reshape(m, sl.shape[1], d_pad)
        out[:, t0:t0 + GATHER_CHUNK] = (q[:, None, :] * V).sum(dim=-1)
    return out


def _gathered_tail(base, rows, safe, qterm, rowterm, metric):
    """Metric tail over gathered rows, then pad ids (-1) to -inf."""
    if metric != "dot":
        base = _metric_tail(base, qterm.to(torch.float32)[:, None],
                            rowterm.to(torch.float32)[safe], metric)
    return torch.where(rows >= 0, base, float("-inf"))


def ash_score_gather_ref(
    codes: torch.Tensor,  # (n, Wd) int32 packed words
    rows: torch.Tensor,  # (m, R) int32 candidate rows, -1 = padding
    q_proj: torch.Tensor,  # (m, d_pad)
    scale, offset, cluster, ip_q_landmarks, qterm, rowterm,
    b: int, metric: str = "dot",
) -> torch.Tensor:
    """Gathered scores (m, R): query i against its own candidate rows
    ``rows[i]``, pad entries -inf.  The reference's
    ``ash_score_gather_ref``: a rowwise dot term, then the dense
    epilogue's op order over the gathered headers."""
    safe = rows.clamp(min=0).long()
    dot = _gathered_dot(codes, safe, q_proj, b)
    bias = ip_q_landmarks.to(torch.float32).gather(1, cluster.long()[safe])
    base = (
        dot * scale.to(torch.float32)[safe]
        + bias
        + offset.to(torch.float32)[safe]
    )
    return _gathered_tail(base, rows, safe, qterm, rowterm, metric)


def _coarse_base(dot_int, q_scale, q_corr, scale, offset, bias):
    """Eq. 20 base of the coarse scan, in the coarse kernels' order:
    dotc = acc * q_scale; biasq = bias + q_corr; dotc * scale + biasq +
    offset.  ``dot_int`` holds the exact integer accumulation."""
    dotc = dot_int.to(torch.float32) * q_scale.to(torch.float32)[:, None]
    biasq = bias + q_corr.to(torch.float32)[:, None]
    return dotc * scale.to(torch.float32) + biasq + offset.to(torch.float32)


def ash_score_coarse_ref(
    codes: torch.Tensor,  # (n, Wd) int32 packed words
    q_int8: torch.Tensor,  # (m, d_pad) int8
    q_scale: torch.Tensor,  # (m,)
    q_corr: torch.Tensor,  # (m,)
    scale, offset, cluster, ip_q_landmarks, qterm, rowterm,
    b: int, metric: str = "dot",
) -> torch.Tensor:
    """Symmetric int8 coarse scores (m, n), higher-is-better.

    The dot term is an fp32 product of exact small integers whose
    partial sums stay below 2^24, so it equals the kernels' int32
    accumulation in any order; the epilogue is :func:`_coarse_base`
    then the metric tail."""
    full_fp32()
    d_pad = codes.shape[1] * Q.codes_per_word(b)
    V = Q.unpack_codes(codes, d_pad, b).to(torch.float32)
    dot = q_int8.to(torch.float32) @ V.T
    bias = ip_q_landmarks.to(torch.float32)[:, cluster.long()]
    base = _coarse_base(dot, q_scale, q_corr, scale[None, :],
                        offset[None, :], bias)
    if metric == "dot":
        return base
    return _metric_tail(base, qterm.to(torch.float32)[:, None],
                        rowterm.to(torch.float32)[None, :], metric)


def ash_score_coarse_gather_ref(
    codes, rows, q_int8, q_scale, q_corr, scale, offset, cluster,
    ip_q_landmarks, qterm, rowterm, b: int, metric: str = "dot",
) -> torch.Tensor:
    """Coarse scores over per-query candidate rows (m, R), pad entries
    -inf: the gathered counterpart of :func:`ash_score_coarse_ref`,
    unpacking only the gathered rows."""
    safe = rows.clamp(min=0).long()
    dot = _gathered_dot(codes, safe, q_int8, b)
    bias = ip_q_landmarks.to(torch.float32).gather(1, cluster.long()[safe])
    base = _coarse_base(dot, q_scale, q_corr, scale.to(torch.float32)[safe],
                        offset.to(torch.float32)[safe], bias)
    return _gathered_tail(base, rows, safe, qterm, rowterm, metric)


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


def tile_topk_ref(scores: torch.Tensor, valid: torch.Tensor, k: int,
                  k_tilde=None):
    """The fused kernels' selection over a materialized (m, n) score
    matrix: per tile of ``topk_geometry`` columns, the partial
    top-k_tilde of (score desc, column asc) among valid columns
    (``valid`` (n,) or (m, n) bool); columns scoring -inf are still
    emitted once each, invalid ones never; exhausted slots carry the
    sentinel.  The strip is merged by :func:`merge_strip`: (m, k) f32
    scores and int32 columns, -1 where exhausted."""
    m, n = scores.shape
    n_blocks, k_tilde, block_n = topk_geometry(n, k, k_tilde)
    n_p = n_blocks * block_n
    valid = valid.to(device=scores.device, dtype=torch.bool).expand(m, n)
    valid = torch.nn.functional.pad(valid, (0, n_p - n), value=False)
    scores = torch.nn.functional.pad(
        scores, (0, n_p - n), value=float("-inf")
    ).reshape(m, n_blocks, block_n)
    valid = valid.reshape(m, n_blocks, block_n)
    # per tile: score desc (stable: lowest column first on ties), then
    # valid columns ahead of invalid ones (stable again)
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


def _mask_valid(mask, n: int, device) -> torch.Tensor:
    if mask is None:
        return torch.ones(n, dtype=torch.bool, device=device)
    return mask.to(device=device) != 0


def ash_score_topk_ref(
    codes, q_proj, scale, offset, cluster, ip_q_landmarks,
    qterm, rowterm, mask, *, b: int, k: int, k_tilde=None,
    metric: str = "dot",
):
    """Plain version of the fused scan + selection kernel: (m, k) f32
    scores and int32 ids.  Scores every row, then selects per 512-row
    tile among valid rows (``mask`` (n,) nonzero, or all rows when
    None) with :func:`tile_topk_ref`.  Equal to a stable top-k of the
    masked scores whenever k <= k_tilde.
    """
    scores = ash_score_metric_ref(
        codes, q_proj, scale, offset, cluster, ip_q_landmarks,
        qterm, rowterm, b=b, metric=metric,
    )
    return tile_topk_ref(
        scores, _mask_valid(mask, codes.shape[0], scores.device), k, k_tilde
    )


def positions_to_rows(rows: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Map selected candidate positions (m, k), -1 where exhausted, back
    through the candidate table ``rows`` (m, R); -1 stays -1."""
    got = rows.gather(1, pos.clamp(min=0).long())
    return torch.where(pos < 0, -1, got).to(torch.int32)


def ash_score_gather_topk_ref(
    codes, rows, q_proj, scale, offset, cluster, ip_q_landmarks,
    qterm, rowterm, *, b: int, k: int, k_tilde=None, metric: str = "dot",
):
    """Plain version of the fused gathered scan + selection kernel:
    (m, k) f32 scores and int32 payload rows.  Selects over candidate
    POSITIONS (ties to the lowest position, as the reference's gather
    kernel), pad ids never surface, and maps positions back through
    ``rows``; exhausted slots are (-inf, -1)."""
    scores = ash_score_gather_ref(
        codes, rows, q_proj, scale, offset, cluster, ip_q_landmarks,
        qterm, rowterm, b=b, metric=metric,
    )
    s, pos = tile_topk_ref(scores, rows >= 0, k, k_tilde)
    return s, positions_to_rows(rows, pos)


def ash_score_coarse_topk_ref(
    codes, q_int8, q_scale, q_corr, scale, offset, cluster,
    ip_q_landmarks, qterm, rowterm, mask, *, b: int, k: int,
    k_tilde=None, metric: str = "dot",
):
    """Plain version of the fused coarse scan + selection kernel: the
    selection of :func:`ash_score_topk_ref` over
    :func:`ash_score_coarse_ref` scores."""
    scores = ash_score_coarse_ref(
        codes, q_int8, q_scale, q_corr, scale, offset, cluster,
        ip_q_landmarks, qterm, rowterm, b=b, metric=metric,
    )
    return tile_topk_ref(
        scores, _mask_valid(mask, codes.shape[0], scores.device), k, k_tilde
    )


KV_NEG = -1e30  # logit of a masked cache position (the kernels' value)


def ash_kv_attn_ref(
    q_k: torch.Tensor,  # (..., G, dk) queries projected into K-code space
    k_codes: torch.Tensor,  # (..., S, Wk) packed K codes (int32 words)
    k_scale: torch.Tensor,  # (..., S)
    k_bias,  # (..., S) per-position logit bias, or None (zero)
    v_codes: torch.Tensor,  # (..., S, Wv) packed V codes
    v_scale: torch.Tensor,  # (..., S)
    b_k: int,
    b_v: int,
    mask=None,  # (..., S) bool, broadcastable; False = ignore
) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode attention over an ASH-compressed KV cache, G query heads
    per KV stream: returns (acc (..., G, dv) f32, p (..., G, S)) with

      logits_i = k_scale_i * <q_k, unpack(k_codes_i)> + k_bias_i
      p = softmax(logits);  acc = sum_i p_i v_scale_i unpack(v_codes_i)

    ``dk``/``dv`` are the packed widths (Wk, Wv words); code lanes past
    the model's code dimension must be zero in ``q_k``.  The caller
    completes the output as W_v^T acc (linear decode).  Masked logits
    are -1e30, as in the kernels: with at least one valid position this
    equals the reference's -inf; with none, p is uniform instead of NaN.
    The reference's single-query form is G = 1.
    """
    full_fp32()
    dk = k_codes.shape[-1] * Q.codes_per_word(b_k)
    dv = v_codes.shape[-1] * Q.codes_per_word(b_v)
    K = Q.unpack_codes(k_codes, dk, b_k).to(torch.float32)
    V = Q.unpack_codes(v_codes, dv, b_v).to(torch.float32)
    logits = torch.matmul(q_k.to(torch.float32), K.transpose(-1, -2))
    logits = logits * k_scale.to(torch.float32)[..., None, :]
    if k_bias is not None:
        logits = logits + k_bias.to(torch.float32)[..., None, :]
    if mask is not None:
        logits = torch.where(mask[..., None, :], logits, KV_NEG)
    p = torch.softmax(logits, dim=-1)
    acc = torch.matmul(p * v_scale.to(torch.float32)[..., None, :], V)
    return acc, p
