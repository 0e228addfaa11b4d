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
from repro_torch.device import full_fp32, row_blocked

ID_SENTINEL = 2**31 - 1  # id of an exhausted selection slot
TOPK_BLOCK_N = 512  # rows per selection tile (as the reference's block_n)
# the fused dense scan's tiles (csrc/ash_score.cu): narrow, MT queries a
# block; wide, WIDE_CHUNK queries a block (WIDE_QUERIES), MT a thread,
# lists of at most WIDE_MAX_L keys (32 * WIDE_MAX_LANES); and the shared
# memory a block may take on sm_90
MT, WIDE_CHUNK, WIDE_MAX_L = 8, 32, 128
SMEM_BLOCK_MAX = 232448
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
    the packed width; the pad lanes of q_proj must be zero.  A row's
    scores do not depend on the other rows of q_proj
    (:func:`row_blocked`), as a kernel's, which scores a row a thread."""
    full_fp32()
    d_pad = codes.shape[1] * Q.codes_per_word(b)
    V_T = Q.unpack_codes(codes, d_pad, b).to(torch.float32).T
    dot = row_blocked(lambda q: q @ V_T, q_proj.to(torch.float32))
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


def _gathered_dot(codes, safe, q, b: int,
                  dtype=torch.float32) -> torch.Tensor:
    """(m, R) fp32 rowwise sums sum_k q[i, k] * v[safe[i, t], k] over the
    unpacked code rows of a candidate table, GATHER_CHUNK positions at a
    time (a broadcast multiply and last-axis sum in ``dtype``: each
    row's value does not depend on the batch)."""
    m, R = safe.shape
    d_pad = codes.shape[1] * Q.codes_per_word(b)
    q = q.to(dtype)
    out = torch.empty(m, R, dtype=torch.float32, device=q.device)
    for t0 in range(0, R, GATHER_CHUNK):
        sl = safe[:, t0:t0 + GATHER_CHUNK]
        V = Q.unpack_codes(codes[sl.reshape(-1)], d_pad, b).to(
            dtype).reshape(m, sl.shape[1], d_pad)
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


_U32 = 2.0**-24  # fp32 unit roundoff


def score_tolerance(A, bias, off, qterm, rowterm, base, metric, d_pad):
    """Elementwise bound on |kernel - plain| for one score matrix.

    Both sum d_pad products q_k v_k in fp32, in different orders: each
    is within gamma_d * sum|q_k v_k| of the exact sum (gamma_d =
    d_pad*u / (1 - d_pad*u)), so they differ by at most 2 gamma_d A
    with A = |scale| * (|q| @ |V|^T).  The epilogue's few roundings
    (<= 4 per side, each within u of its operands) add 16 u of the
    magnitudes involved.  l2 doubles the base term; cos scales it by
    qterm * rowterm.
    """
    gamma = d_pad * _U32 / (1 - d_pad * _U32)
    mag = A + bias.abs() + off.abs()[None, :]
    if metric == "dot":
        return 2 * gamma * A + 16 * _U32 * mag
    if metric == "l2":
        extra = qterm.abs()[:, None] + rowterm.abs()[None, :]
        return 4 * gamma * A + 16 * _U32 * (2 * mag + extra + base.abs())
    f = (qterm[:, None] * rowterm[None, :]).abs()
    return f * (2 * gamma * A + 16 * _U32 * mag) + 16 * _U32 * base.abs()


def _coarse_dtype(b: int, d_pad: int) -> torch.dtype:
    """The float type in which the coarse dot term's integer sums are
    exact: fp32 while 127 * (2^b - 1) * d_pad, the largest, stays below
    2^24; else fp64 (b = 8 rows of d_pad above 518 can pass 2^24)."""
    return (torch.float32 if 127 * (2**b - 1) * d_pad < 2**24
            else torch.float64)


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

    The dot term is the exact integer sum_k q_int8 * v, rounded once to
    fp32, as the kernels' int32 accumulation gives it in any order: a
    product of the integers in :func:`_coarse_dtype`, where every sum is
    exact; the epilogue is :func:`_coarse_base` then the metric tail."""
    full_fp32()
    d_pad = codes.shape[1] * Q.codes_per_word(b)
    dt = _coarse_dtype(b, d_pad)
    V = Q.unpack_codes(codes, d_pad, b).to(dt)
    dot = (q_int8.to(dt) @ V.T).to(torch.float32)
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
    unpacking only the gathered rows (the same exact integer dot term)."""
    safe = rows.clamp(min=0).long()
    dot = _gathered_dot(codes, safe, q_int8, b,
                        _coarse_dtype(b, codes.shape[1] * Q.codes_per_word(b)))
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


def span_geometry(n: int, k: int, k_tilde=None, target_spans: int = 264):
    """(n_spans, tiles_per_span, L) of the card's fused selection.

    Tiles are TOPK_BLOCK_N rows; a span is ``tiles_per_span`` whole
    tiles, the last span ragged, and the spans cover every row.  Each
    span keeps its best L = min(k, k_tilde) keys per query.  Where
    k <= k_tilde only the merged top-k is observable, which is the
    exact top-k whatever the spans, so about ``target_spans`` spans
    share the tiles; where k_tilde < k a span is one tile, which keeps
    the per-tile strip of :func:`tile_topk_ref`.  Refuses what
    :func:`topk_geometry` refuses."""
    _, k_tilde, _ = topk_geometry(n, k, k_tilde)
    n_tiles = -(-n // TOPK_BLOCK_N)
    per = -(-n_tiles // max(1, target_spans)) if k <= k_tilde else 1
    return -(-n_tiles // per), per, min(k, k_tilde)


def list_lanes(L: int) -> int:
    """Keys a lane of a selection list of top-L holds (``list_lanes`` in
    ``csrc/ash_select.cuh``): the least power of two N with 32N >= L."""
    n = 1
    while 32 * n < L:
        n *= 2
    return n


def dense_topk_smem(d_pad: int, L: int, chunk: int) -> int:
    """Shared bytes a block of the fused dense scan (kernel 2) takes
    (``topk_smem`` in ``csrc/ash_score.cu``): the chunk's query values,
    then, narrow, a tile of keys a query, a list of 32 * list_lanes(L)
    keys and a bound a query (``span_select_bytes``); wide, a list and a
    bound a query, a take of TOPK_BLOCK_N keys for the warps of each MT
    queries and a lock a query (``tiled_select_bytes``)."""
    lists = chunk * 32 * list_lanes(L) + chunk
    if chunk == MT:
        return 4 * d_pad * MT + 8 * (MT * TOPK_BLOCK_N + lists)
    return (4 * d_pad * chunk + 8 * (lists + chunk // MT * TOPK_BLOCK_N)
            + 4 * chunk)


def dense_query_chunk(m: int, d_pad: int, L: int,
                      smem_max: int = SMEM_BLOCK_MAX) -> int:
    """Queries a block of the fused dense scan takes: WIDE_CHUNK where
    m > MT (each row's words then read once for 32 queries), else MT;
    MT also for lists longer than WIDE_MAX_L and where the wide block's
    shared memory would pass ``smem_max`` (d_pad past ~1,420)."""
    if (m > MT and L <= WIDE_MAX_L
            and dense_topk_smem(d_pad, L, WIDE_CHUNK) <= smem_max):
        return WIDE_CHUNK
    return MT


def dense_target_spans(m: int, chunk: int = MT, n_sm: int = 132,
                       wide_blocks=None) -> int:
    """Spans a query chunk of the fused dense scan aims at: narrow, two
    512-thread blocks an SM for each chunk; wide, ``wide_blocks``
    (default one 1,024-thread block an SM) shared among the chunks, so
    that one wave fills the card and a span's first tiles, where every
    key passes the bound, are few among its tiles."""
    if chunk == MT:
        return 2 * n_sm
    blocks = n_sm if wide_blocks is None else wide_blocks
    return max(1, blocks // -(-max(m, 1) // chunk))


def dense_span_geometry(n: int, m: int, k: int, k_tilde=None,
                        chunk: int = MT, n_sm: int = 132, wide_blocks=None):
    """(n_spans, tiles_per_span, L) of the fused dense scan at m queries
    taken ``chunk`` a block: :func:`span_geometry` at
    :func:`dense_target_spans`."""
    return span_geometry(n, k, k_tilde,
                         dense_target_spans(m, chunk, n_sm, wide_blocks))


def gather_span_geometry(R: int, m: int, k: int, k_tilde=None,
                         n_sm: int = 132):
    """(n_spans, tiles_per_span, L) of the card's fused gathered
    selection: :func:`span_geometry` over the R candidate positions of
    each query, about two blocks per SM over all m queries (a block
    walks one query's tiles; two are resident at once where the
    kernel's instance takes at most 64 registers, see
    ``csrc/ash_gather.cu``)."""
    return span_geometry(R, k, k_tilde, -(-2 * n_sm // max(1, m)))


def gather_span_strip_ref(scores: torch.Tensor, rows: torch.Tensor, k: int,
                          k_tilde=None, target_spans: int = 264):
    """The key strip the fused gathered kernel emits, from a
    materialized (m, R) gathered score matrix: :func:`span_strip_ref`
    over candidate positions, pad ids (-1) never entering, as
    :func:`make_keys` keys of (score, position).  Merged by
    :func:`merge_keys_ref` and mapped by :func:`positions_to_rows`."""
    return make_keys(*span_strip_ref(scores, rows >= 0, k, k_tilde,
                                     target_spans))


def span_strip_ref(scores: torch.Tensor, valid: torch.Tensor, k: int,
                   k_tilde=None, target_spans: int = 264):
    """The strip the fused kernels emit, from a materialized (m, n)
    score matrix: per span of :func:`span_geometry`, the best L valid
    columns by (score desc, column asc), as (m, n_spans * L) f32 scores
    and int32 columns, (-inf, sentinel) past a span's valid columns.
    ``valid`` is (n,) or (m, n) bool; columns scoring -inf still enter,
    invalid ones never."""
    m, n = scores.shape
    n_spans, per, L = span_geometry(n, k, k_tilde, target_spans)
    span_n = per * TOPK_BLOCK_N
    pad = n_spans * span_n - n
    valid = valid.to(device=scores.device, dtype=torch.bool).expand(m, n)
    valid = torch.nn.functional.pad(valid, (0, pad), value=False)
    scores = torch.nn.functional.pad(scores, (0, pad), value=float("-inf"))
    ids = torch.arange(n_spans * span_n, device=scores.device).expand(m, -1)
    # invalid columns last within a span, then (score desc, column asc)
    keys = torch.where(valid, scores, float("-inf")).reshape(m, n_spans, -1)
    order = torch.sort(keys, dim=2, descending=True, stable=True).indices
    second = torch.sort((~valid.reshape(m, n_spans, -1).gather(2, order))
                        .to(torch.int8), dim=2, stable=True).indices
    order = order.gather(2, second)[:, :, :L]
    ok = valid.reshape(m, n_spans, -1).gather(2, order)
    vals = torch.where(ok, keys.gather(2, order), float("-inf"))
    cols = torch.where(ok, ids.reshape(m, n_spans, -1).gather(2, order),
                       ID_SENTINEL)
    return vals.reshape(m, -1), cols.reshape(m, -1).to(torch.int32)


_U32 = 0xFFFFFFFF


def make_keys(vals: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The kernels' 64-bit selection keys (``make_key`` in
    ``csrc/ash_common.cuh``) as int64 bit patterns: ascending unsigned
    key == (score desc, id asc), signed zeros folded; sentinel ids give
    the INVALID key (all ones, -1 as int64)."""
    u = vals.to(torch.float32).contiguous().view(torch.int32).to(
        torch.int64) & _U32
    u = torch.where((u & 0x7FFFFFFF) == 0, 0, u)
    order = torch.where((u & 0x80000000) != 0, ~u & _U32, u | 0x80000000)
    key = ((~order & _U32) << 32) | (ids.to(torch.int64) & _U32)
    return torch.where(ids == ID_SENTINEL, -1, key)


def keys_to_strip(keys: torch.Tensor):
    """Inverse of :func:`make_keys`: (f32 scores, int32 ids), the
    INVALID key as (-inf, sentinel)."""
    order = ~(keys >> 32) & _U32
    u = torch.where((order & 0x80000000) != 0, order & 0x7FFFFFFF,
                    ~order & _U32)
    vals = torch.where(u >= 2**31, u - 2**32, u).to(torch.int32).view(
        torch.float32)
    ids = torch.where(keys & _U32 >= 2**31, (keys & _U32) - 2**32,
                      keys & _U32).to(torch.int32)
    invalid = keys == -1
    return (torch.where(invalid, float("-inf"), vals),
            torch.where(invalid, ID_SENTINEL, ids))


def merge_keys_ref(keys: torch.Tensor, k: int):
    """Plain version of the card's strip merge (``ash_topk_merge``):
    :func:`merge_strip` of the decoded key strip."""
    return merge_strip(*keys_to_strip(keys), k)


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
