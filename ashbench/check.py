"""The comparison that decides ``correct``.

The plain reference (``ashbench.reference``) works the index out again
from the same seeded rows and generator seed, and the outputs of the
timed path are held to it.  Each number has its limit in the
configuration's file (``limits``), set from the readings in ``PERF.md``:

* ``model``: the learned projection W and the landmarks (IVF
  centroids), the largest gap relative to the reference's largest
  entry;
* ``codes``: the share of payload rows whose packed codes, fp16 SCALE
  or OFFSET or landmark id differ;
* ``probes`` (IVF): the share of judged query rows whose probed lists,
  best first, differ;
* ``answers``: the widest gap over the judged answers, each gap relative
  to the largest score of its query's reference shortlist.  An answer
  of ids and scores is held to four things: each reported score is the
  exact score of its id; each id is a row the scan may keep (its ASH
  score not below the reference's ``rerank``-th best, and for IVF in a
  probed list); no row that the scan must keep (ASH score above that
  threshold by more than ``tie`` of the scale) beats the answer's worst
  by exact score; and the ids come best first.  Near-ties between the
  kernels' and the reference's summation orders move an id by no more
  than their own width;
* ``unanswered``: requests that never got an answer (limit 0).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ashbench import reference as R

FAIL = 1.0  # the gap of an answer that is missing or not a row at all


@dataclasses.dataclass
class Outputs:
    """What the side under judgement produced."""

    W: torch.Tensor
    landmarks: torch.Tensor
    codes: torch.Tensor  # payload rows, in the side's own row order
    scale: torch.Tensor
    offset: torch.Tensor
    cluster: torch.Tensor
    row_ids: Optional[torch.Tensor]  # the input row of each payload row
    probe: Optional[np.ndarray]  # (r, nprobe) lists of the judged rows
    scores: np.ndarray  # (r, k) answers of the judged query rows
    ids: np.ndarray  # (r, k)
    unanswered: int = 0


def _rel(a, b) -> float:
    a, b = a.to(b.device, torch.float32), b.to(torch.float32)
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view({1: torch.int8, 2: torch.int16,
                                4: torch.int32, 8: torch.int64}[
                                   t.element_size()])


def setup_numbers(out: Outputs, model: R.Model, payload: R.Payload) -> dict:
    """``model`` and ``codes`` of a side against the reference."""
    dev = out.codes.device
    n = payload.codes.shape[0]
    rows = (torch.arange(n, device=dev) if out.row_ids is None
            else out.row_ids.to(dev).long())
    differ = torch.zeros(rows.shape[0], dtype=torch.bool, device=dev)
    for mine, ref in ((out.codes, payload.codes), (out.scale, payload.scale),
                      (out.offset, payload.offset),
                      (out.cluster, payload.cluster)):
        ref = ref.to(dev)[rows]
        if mine.dtype != ref.dtype or mine.shape != ref.shape:
            return {"model": FAIL, "codes": FAIL}
        differ |= (_bits(mine) != _bits(ref)).reshape(rows.shape[0],
                                                     -1).any(dim=1)
    return {
        "model": max(_rel(out.W, model.W),
                     _rel(out.landmarks, model.landmarks)),
        "codes": float(differ.float().mean()) if n == rows.shape[0]
        else FAIL,
    }


def answer_gaps(out: Outputs, model: R.Model, payload: R.Payload,
                raw: torch.Tensor, queries: torch.Tensor, metric: str,
                rerank: int, tie: float, nprobe: Optional[int] = None
                ) -> tuple[np.ndarray, Optional[float]]:
    """(the gap of each judged answer row, the ``probes`` share or
    None): ``queries`` (r, D) are the judged rows on the reference's
    device, answered by ``out.scores``/``out.ids``."""
    dev = queries.device
    prep = R.prepare(model, queries)
    depth = rerank + 28  # rows near the threshold, and a margin
    short = R.shortlists(model, payload, raw, prep, metric, depth,
                         nprobe=nprobe)
    ids = torch.as_tensor(out.ids, device=dev).long()
    got = torch.as_tensor(out.scores, device=dev, dtype=torch.float32)
    r, k = ids.shape
    n = payload.codes.shape[0]
    ash_top = short.ash[:, :rerank]
    fin = torch.isfinite(ash_top)
    scale_a = torch.where(fin, ash_top.abs(), 0).amax(1).clamp(min=1e-30)
    ex_top = short.exact[:, :rerank]
    scale_e = torch.where(torch.isfinite(ex_top), ex_top.abs(), 0).amax(
        1).clamp(min=1e-30)
    t = torch.where(fin, ash_top, float("inf")).amin(1)
    valid = (ids >= 0) & (ids < n)
    safe = torch.where(valid, ids, 0)
    want = torch.isfinite(short.exact[:, :k])  # the reference has a row
    e_ids = R.exact_scores_of(prep, raw, safe, metric)
    a_ids = R.ash_scores_of(model, payload, prep, safe, metric)
    gap = torch.zeros(r, device=dev)

    def worst(g):
        return torch.nan_to_num(g, nan=FAIL, posinf=FAIL).clamp(
            max=FAIL).amax(1) if g.dim() == 2 else g

    # a missing or foreign id where the reference has a row
    bad = (~valid & want) | (valid & ~want)
    gap = torch.maximum(gap, bad.any(1).float() * FAIL)
    # each reported score is its id's exact score
    gap = torch.maximum(gap, worst(torch.where(
        valid, (got - e_ids).abs() / scale_e[:, None], 0)))
    # each id may be kept by the scan
    adm = torch.where(valid, (t[:, None] - a_ids).clamp(min=0)
                      / scale_a[:, None], 0)
    gap = torch.maximum(gap, worst(adm))
    if nprobe is not None:
        lists = payload.cluster[safe].long()
        probed = torch.zeros(r, model.landmarks.shape[0], dtype=torch.bool,
                             device=dev)
        probed.scatter_(1, short.probe, True)
        off = valid & ~probed.gather(1, lists)
        gap = torch.maximum(gap, off.any(1).float() * FAIL)
    # no id twice
    srt = torch.sort(torch.where(valid, ids, -1 - torch.arange(
        k, device=dev)[None, :]), dim=1)[0]
    gap = torch.maximum(gap, (srt[:, 1:] == srt[:, :-1]).any(1).float()
                        * FAIL)
    # nothing the scan must keep beats the answer's worst
    e_valid = torch.where(valid, e_ids, float("inf"))
    floor = e_valid.amin(1)
    sure = short.ash[:, :rerank] > (t + tie * scale_a)[:, None]
    chosen = (short.rows[:, :rerank, None] == ids[:, None, :]).any(2)
    beat = torch.where(sure & ~chosen,
                       (short.exact[:, :rerank] - floor[:, None]).clamp(
                           min=0) / scale_e[:, None], 0)
    gap = torch.maximum(gap, worst(torch.nan_to_num(beat, posinf=0.0)))
    # best first
    step = torch.where(valid[:, 1:] & valid[:, :-1],
                       (e_ids[:, 1:] - e_ids[:, :-1]).clamp(min=0)
                       / scale_e[:, None], 0)
    gap = torch.maximum(gap, worst(step))
    probes = None
    if nprobe is not None:
        mine = torch.as_tensor(out.probe, device=dev).long()
        probes = float((mine != short.probe).any(1).float().mean())
    return gap.cpu().numpy(), probes


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    shown = {name: {"value": float(v), "limit": float(limits[name])}
             for name, v in numbers.items()}
    return all(s["value"] <= s["limit"] for s in shown.values()), shown
