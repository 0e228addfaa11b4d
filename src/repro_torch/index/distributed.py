"""Sharded ASH search over a list of devices, from one process.

Counterpart of ``repro.index.distributed``.  The reference lays a
``Mesh`` over ``jax.devices()`` and runs a ``shard_map``; the port keeps
its single-controller design without a collective: one process holds a
list of devices, shard ``s`` of the rows lives on ``devices[s]`` (a
device may repeat, so several logical shards can share one card), and
the ported kernels are launched per shard.

The payload is padded to a multiple of the shard count
(:func:`pad_to_multiple`) and split into equal contiguous blocks
(:func:`shard_rows`), so shard ``s`` holds global rows ``[s * n_local,
(s + 1) * n_local)``.  A search (:func:`search_shards`; the reference
builds a jitted searcher per option set with ``make_sharded_search``,
and with nothing to compile the port runs the search directly) copies
the query prep to each shard's device bit for bit and runs
``common.execute_plan`` there with a dense ``ScanPlan`` over the shard's
real rows (pad rows are cut off by ``n_valid`` before any scan, so their
-1 cluster sentinel never reaches a landmark lookup), for ``k_loc =
min(k, n_valid)``.  Every shard's scan is launched before any result is
copied, so shards on different cards overlap.  The (m, k_loc) results
move to the first shard's device, local rows become global ones (``li +
s * n_local``), and one merge takes the global top-k in the port's
stable order, score descending, then id ascending (on the card the
strip merge ``ash_topk_merge_cuda`` over one sorted run of 64-bit keys
per shard; on the CPU ``ref.merge_strip``).  The reference's
``lax.top_k`` over the gathered shards breaks ties by shard order, then
by local rank: the same order.

Exact rerank runs inside each shard, as the reference's: a shard's plan
carries ``rerank`` and the shard's own raw rows, so it reranks its own
top ``max(rerank, k_loc)`` rows by ASH score exactly, on its device, and
returns its top ``k_loc`` by exact score; the merge then takes the
global top-k of exact scores.  That reranks a superset of the flat
backend's shortlist, so the exact score at every rank is at least
flat's, and the ids may differ from flat's.

``coarse="int8"`` keeps its shortlist per shard, as the reference does:
the result equals a merge of flat coarse searches over each shard's
rows alone, and flat's own only when every shard's shortlist covers its
top-k_loc.
"""
from __future__ import annotations

import copy
from typing import Optional, Sequence

import torch

from repro_torch.core import scoring as S
from repro_torch.core.types import (
    ASHModel, ASHPayload, ASHStats, CoarseCodes, QueryPrep,
)
from repro_torch.index import common as C
from repro_torch.kernels import ref
from repro_torch.kernels.ash_score import MERGE_MAX_K, ash_topk_merge_cuda

PAD_CLUSTER = -1  # cluster id of pad rows; never a valid landmark


def pad_rows(t: torch.Tensor, pad: int, value=0) -> torch.Tensor:
    """``t`` with ``pad`` rows of ``value`` appended."""
    if pad == 0:
        return t
    fill = torch.full((pad,) + tuple(t.shape[1:]), value, dtype=t.dtype,
                      device=t.device)
    return torch.cat([t, fill])


def pad_to_multiple(payload: ASHPayload, multiple: int) -> ASHPayload:
    """Pad rows so ``multiple`` shards divide them evenly.  Pad rows
    carry ``scale = 0``, ``offset = finfo.min`` and ``cluster =
    PAD_CLUSTER`` (-1), a sentinel no real row uses: the valid-row count
    is derivable from the payload itself, and ``ivf._assemble`` refuses
    it."""
    pad = (-payload.n) % multiple
    if pad == 0:
        return payload
    return ASHPayload(
        b=payload.b, d=payload.d,
        codes=pad_rows(payload.codes, pad),
        scale=pad_rows(payload.scale, pad),
        offset=pad_rows(payload.offset, pad,
                        torch.finfo(payload.offset.dtype).min),
        cluster=pad_rows(payload.cluster, pad, PAD_CLUSTER),
    )


def pad_stats(stats: Optional[ASHStats], pad: int) -> Optional[ASHStats]:
    """Zero-pad stats rows to match a padded payload."""
    if stats is None or pad == 0:
        return stats
    return ASHStats(res_norm=pad_rows(stats.res_norm, pad),
                    ip_x_mu=pad_rows(stats.ip_x_mu, pad),
                    x_sq=pad_rows(stats.x_sq, pad))


def _rows_of(t, r0: int, r1: int, device):
    """Rows ``[r0, r1)`` of a tensor, payload or stats on ``device``."""
    if t is None:
        return None
    if isinstance(t, ASHPayload):
        return ASHPayload(b=t.b, d=t.d, **{
            f: getattr(t, f)[r0:r1].to(device)
            for f in ASHPayload.ARRAY_FIELDS})
    if isinstance(t, ASHStats):
        return ASHStats(res_norm=t.res_norm[r0:r1].to(device),
                        ip_x_mu=t.ip_x_mu[r0:r1].to(device),
                        x_sq=t.x_sq[r0:r1].to(device))
    return t[r0:r1].to(device)


def shard_rows(devices: Sequence[torch.device], tree) -> list:
    """Split a tensor, payload or stats block (or None) into
    ``len(devices)`` equal contiguous row blocks, block ``s`` on
    ``devices[s]``.  The row count must divide evenly (see
    :func:`pad_to_multiple`); a block already on its device is a view."""
    if tree is None:
        return [None] * len(devices)
    n = tree.n if isinstance(tree, (ASHPayload, ASHStats)) else \
        tree.shape[0]
    S_ = len(devices)
    if n % S_:
        raise ValueError(f"{n} rows do not split into {S_} equal shards")
    nl = n // S_
    return [_rows_of(tree, s * nl, (s + 1) * nl, dev)
            for s, dev in enumerate(devices)]


def _prep_to(prep: QueryPrep, device) -> QueryPrep:
    """The prep on ``device``, bit for bit."""
    return QueryPrep(q=prep.q.to(device), q_proj=prep.q_proj.to(device),
                     ip_q_landmarks=prep.ip_q_landmarks.to(device),
                     q_sq_norm=prep.q_sq_norm.to(device))


def model_to(model: ASHModel, device) -> ASHModel:
    """The model on ``device``, bit for bit (itself when already there)."""
    if model.device == torch.device(device):
        return model
    return ASHModel(config=model.config, **{
        f: getattr(model, f).to(device) for f in ASHModel.ARRAY_FIELDS})


def merge_shards(parts, k: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Global top-k of per-shard results.

    ``parts``: one (scores (m, w), global rows (m, w)) pair per shard,
    each sorted by (score desc, row asc), -inf slots carrying row -1.
    Returns (m, min(k, width)) scores and int32 rows by (score desc, row
    asc), (-inf, -1) past the valid entries.  On the card one launch of
    the strip merge over one sorted run of keys per shard (runs padded
    to one width with the INVALID key), or stable sorts above its
    ``MERGE_MAX_K``; on the CPU ``ref.merge_strip``."""
    w = max(p[0].shape[1] for p in parts)
    m = parts[0][0].shape[0]
    vals, ids = [], []
    for s, g in parts:
        s, g = s.to(device), g.to(device)
        pad = w - s.shape[1]
        if pad:
            s = torch.nn.functional.pad(s, (0, pad), value=float("-inf"))
            g = torch.nn.functional.pad(g, (0, pad), value=-1)
        vals.append(s)
        ids.append(torch.where(torch.isneginf(s) | (g < 0),
                               ref.ID_SENTINEL, g).to(torch.int32))
    vals, ids = torch.cat(vals, dim=1), torch.cat(ids, dim=1)
    k_out = min(k, vals.shape[1])
    if m == 0 or vals.device.type == "cpu" or k_out > MERGE_MAX_K:
        return ref.merge_strip(vals, ids, k_out)
    return ash_topk_merge_cuda(ref.make_keys(vals, ids).contiguous(),
                               k_out, w)


class ShardSet:
    """What a sharded search reads of each shard: its device, its copy of
    the model, and its real rows (payload, stats, bf16 raw rows for
    rerank, tombstone bitmap, coarse operands); shard ``s``'s first row
    is global row ``s * n_local``."""

    def __init__(self, devices, model, payload, stats=None, raw=None,
                 valid=None):
        """``payload``/``stats``/``raw``/``valid``: the padded global
        blocks (:func:`pad_to_multiple`); each shard's real rows are
        counted from the pad sentinel."""
        self.devices = [torch.device(d) for d in devices]
        if payload.n % len(self.devices):
            raise ValueError(
                f"{payload.n} rows do not split into {len(self.devices)} "
                "equal shards; pad_to_multiple first")
        self.n_local = payload.n // len(self.devices)
        self.n_valid = [int((p.cluster != PAD_CLUSTER).sum())
                        for p in shard_rows(self.devices, payload)]
        self.models = [model_to(model, d) for d in self.devices]
        self.payloads = self._real(payload)
        self.stats = self._real(stats)
        self.raw = self._real(raw)
        self.valid = self._real(valid)
        self.coarse: list[Optional[CoarseCodes]] = [
            S.coarse_codes(p) if p.n else None for p in self.payloads]

    def _real(self, tree) -> list:
        """Each shard's real rows of a padded global block."""
        return [_rows_of(b, 0, nv, d) for b, nv, d in
                zip(shard_rows(self.devices, tree), self.n_valid,
                    self.devices)]

    def with_valid(self, valid) -> "ShardSet":
        """A copy with another (padded) tombstone bitmap; nothing else
        is placed again."""
        out = copy.copy(self)
        out.valid = self._real(valid)
        return out

    def __len__(self) -> int:
        return len(self.devices)


def search_shards(shards: ShardSet, prep: QueryPrep, k: int, *,
                  metric: str, rerank: int = 0, use_kernel: bool = True,
                  coarse: Optional[str] = None,
                  shortlist: Optional[int] = None):
    """(scores, global rows), each (m, k) on the first shard's device:
    the scatter-gather search described in the module docstring."""
    C.validate_metric(metric)
    if rerank and any(r is None for r, nv in zip(shards.raw, shards.n_valid)
                      if nv):
        raise ValueError(
            "rerank on the sharded backend requires keep_raw=True "
            "(bf16 raw rows are sharded with the payload)")
    launched = []
    for s in range(len(shards)):  # every shard's scan launches first
        nv = shards.n_valid[s]
        if nv == 0:
            continue
        plan = C.ScanPlan(
            metric=metric, k=min(k, nv), rerank=rerank,
            row_valid=shards.valid[s], use_kernel=use_kernel, coarse=coarse,
            shortlist=shortlist)
        ls, li = C.execute_plan(
            shards.models[s], _prep_to(prep, shards.devices[s]),
            shards.payloads[s], plan, stats=shards.stats[s],
            raw=shards.raw[s] if rerank else None,
            coarse_cache=shards.coarse[s])
        launched.append((s, ls, li))
    parts = [(ls, torch.where(li < 0, -1, li + s * shards.n_local))
             for s, ls, li in launched]
    return merge_shards(parts, k, shards.devices[0])
