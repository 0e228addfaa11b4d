"""Query preparation, ASH scores (Eq. 20 and the L2 form of Appendix
A), IVF probing, shortlists and exact rerank in plain PyTorch.

Scores are higher-is-better for every metric (L2 scores are negated
squared distances); every selection orders ties by the lower row first.
The scan runs over the whole payload in row chunks and keeps each
query's best ``depth`` rows, so it fits the card at 10^7 rows and more.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ashbench.reference.ash import Model, Payload, row_blocked, unpack

ROW_CHUNK = 1 << 20  # payload rows unpacked at a time
QUERY_BLOCK = 512  # queries scored at a time against a row chunk


@dataclasses.dataclass(frozen=True)
class Prep:
    q: torch.Tensor  # (m, D) fp32
    q_proj: torch.Tensor  # (m, d)
    ipl: torch.Tensor  # (m, C) <q, mu_c>
    q_sq: torch.Tensor  # (m,)


def prepare(model: Model, q: torch.Tensor) -> Prep:
    """W q, <q, mu_c> and ||q||^2 over fixed 32-row blocks."""
    q32 = q.to(device=model.W.device, dtype=torch.float32)
    W_T, lm_T = model.W.T, model.landmarks.T
    q_proj, ipl, q_sq = row_blocked(
        lambda x: (x @ W_T, x @ lm_T, (x * x).sum(dim=-1)), q32, block=32)
    return Prep(q=q32, q_proj=q_proj, ipl=ipl, q_sq=q_sq)


def _tail(model, ipl_c, q_sq, qv, scale, offset, V, cl, metric):
    """Eq. (20) (dot) or the negated L2 of Appendix A from the inner
    products ``qv`` of projected queries and codes; every operand
    broadcasts to the (m, r) score shape (``V`` and the landmark rows
    gathered by ``cl`` carry a trailing d)."""
    scale = scale.to(torch.float32)
    offset = offset.to(torch.float32)
    dot = scale * qv + ipl_c + offset
    if metric == "dot":
        return dot
    if metric != "l2":
        raise ValueError(f"metric {metric!r}: the reference takes dot, l2")
    res_norm = scale * torch.sqrt((V * V).sum(dim=-1))
    mu_sq = model.landmark_sq_norms[cl]
    ip_x_mu = offset + scale * (model.W_landmarks[cl] * V).sum(dim=-1) \
        + mu_sq
    q_sq_mu = q_sq - 2.0 * ipl_c + mu_sq
    return -(q_sq_mu + res_norm ** 2
             - 2.0 * (dot - ip_x_mu - ipl_c + mu_sq))


def probe_lists(model: Model, prep: Prep, nprobe: int) -> torch.Tensor:
    """Each query's ``nprobe`` nearest landmarks, best first (m, nprobe)
    int64: max <q, mu> - ||mu||^2 / 2, ties to the lower list."""
    score = prep.ipl - 0.5 * model.landmark_sq_norms[None, :]
    return torch.sort(score, dim=-1, descending=True,
                      stable=True)[1][:, :nprobe]


def _best(vals, rows, depth):
    """Top ``depth`` of (vals, rows) per query by (value desc, row asc)."""
    o = torch.sort(rows, dim=1, stable=True)[1]
    vals, rows = vals.gather(1, o), rows.gather(1, o)
    o = torch.sort(vals, dim=1, descending=True, stable=True)[1][:, :depth]
    return vals.gather(1, o), rows.gather(1, o)


def exact_scores_of(prep: Prep, raw: torch.Tensor, rows: torch.Tensor,
                    metric: str) -> torch.Tensor:
    """Exact scores (m, r) of the raw rows ``rows`` (m, r) (negative
    entries score -inf) against each query, from the bf16 raw copy."""
    cand = raw[rows.clamp(min=0)].to(torch.float32)
    ip = (prep.q[:, None, :] * cand).sum(dim=-1)
    if metric == "dot":
        out = ip
    else:
        out = -(prep.q_sq[:, None] - 2.0 * ip + (cand * cand).sum(dim=-1))
    return torch.where(rows < 0, float("-inf"), out)


def ash_scores_of(model: Model, payload: Payload, prep: Prep,
                  rows: torch.Tensor, metric: str) -> torch.Tensor:
    """ASH scores (m, r) of payload rows ``rows`` (m, r) for each query
    (negative entries score -inf)."""
    safe = rows.clamp(min=0)
    V = unpack(payload.codes[safe], model.d, model.b).to(torch.float32)
    cl = payload.cluster[safe].long()
    out = _tail(model, prep.ipl.gather(1, cl), prep.q_sq[:, None],
                (prep.q_proj[:, None, :] * V).sum(dim=-1),
                payload.scale[safe], payload.offset[safe], V, cl, metric)
    return torch.where(rows < 0, float("-inf"), out)


@dataclasses.dataclass(frozen=True)
class Shortlists:
    """Each query's best ``depth`` rows by ASH score, with their exact
    scores; ``probe`` holds the probed lists of an IVF search."""

    ash: torch.Tensor  # (m, depth) ASH scores, best first
    rows: torch.Tensor  # (m, depth) int64 rows, -1 where fewer exist
    exact: torch.Tensor  # (m, depth) exact scores of those rows
    probe: Optional[torch.Tensor]  # (m, nprobe) int64, or None


def shortlists(model: Model, payload: Payload, raw: torch.Tensor,
               prep: Prep, metric: str, depth: int,
               nprobe: Optional[int] = None) -> Shortlists:
    """The best ``depth`` rows of every query over the whole payload, or
    over the rows of its ``nprobe`` probed lists."""
    m, n = prep.q.shape[0], payload.codes.shape[0]
    dev = prep.q.device
    probe = None if nprobe is None else probe_lists(model, prep, nprobe)
    allowed = None
    if probe is not None:
        C = model.landmarks.shape[0]
        allowed = torch.zeros(m, C, dtype=torch.bool, device=dev)
        allowed.scatter_(1, probe, True)
    vals = torch.full((m, 0), float("-inf"), device=dev)
    rows = torch.full((m, 0), -1, dtype=torch.int64, device=dev)
    for r0 in range(0, n, ROW_CHUNK):
        sl = slice(r0, min(n, r0 + ROW_CHUNK))
        cl = payload.cluster[sl].long()
        V = unpack(payload.codes[sl], model.d, model.b).to(torch.float32)
        parts_v, parts_r = [], []
        for q0 in range(0, m, QUERY_BLOCK):
            qs = slice(q0, min(m, q0 + QUERY_BLOCK))
            s = _tail(model, prep.ipl[qs][:, cl], prep.q_sq[qs, None],
                      prep.q_proj[qs] @ V.T, payload.scale[sl][None, :],
                      payload.offset[sl][None, :], V, cl[None, :], metric)
            if allowed is not None:
                s = torch.where(allowed[qs][:, cl], s, float("-inf"))
            top = torch.topk(s, min(depth, s.shape[1]), dim=1)
            parts_v.append(top.values)
            parts_r.append(top.indices + r0)
            del s
        vals, rows = _best(torch.cat([vals, torch.cat(parts_v)], dim=1),
                           torch.cat([rows, torch.cat(parts_r)], dim=1),
                           depth)
    rows = torch.where(torch.isneginf(vals), -1, rows)
    return Shortlists(ash=vals, rows=rows,
                      exact=exact_scores_of(prep, raw, rows, metric),
                      probe=probe)


def answers(short: Shortlists, k: int, rerank: int):
    """The top ``k`` of each query's best ``rerank`` rows by exact score
    (score desc, then shortlist order): (scores, rows), each (m, k)."""
    exact = short.exact[:, :rerank]
    o = torch.sort(exact, dim=1, descending=True, stable=True)[1][:, :k]
    s, r = exact.gather(1, o), short.rows[:, :rerank].gather(1, o)
    return s, torch.where(torch.isneginf(s), -1, r)
