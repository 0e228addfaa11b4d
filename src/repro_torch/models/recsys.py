"""CTR / ranking recommenders: DCN-v2, FM, AutoInt (counterpart of
``repro.models.recsys``).

The hot path is the sparse-embedding lookup over huge tables: every
field's table is folded into one (field f owns rows [f·V, (f+1)·V)),
so a batch's lookup is one ``index_select`` and its backward one
``index_add`` into a dense gradient of the whole table (the reference's
AdamW updates every row every step; no sparse gradients here).
``retrieval_score`` scores one user context against a large candidate
set by broadcasting the user-side features and swapping the item
field.

Parameters are the reference's tree: a nested dict (``mlp`` and
``attn`` lists of dicts) of tensors.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.models import common as cm

make_trainable = cm.make_trainable


@dataclasses.dataclass(frozen=True)
class RecSysConfig:
    name: str
    kind: str  # "dcn_v2" | "fm" | "autoint"
    n_dense: int
    n_sparse: int
    embed_dim: int
    vocab_per_field: int = 1_000_000
    # dcn-v2
    n_cross_layers: int = 3
    mlp_dims: tuple = (1024, 1024, 512)
    cross_rank: int = 0  # 0 = full-rank W
    # autoint
    n_attn_layers: int = 3
    n_attn_heads: int = 2
    d_attn: int = 32
    dtype: Any = torch.float32
    param_dtype: Any = torch.float32

    @property
    def interaction_dim(self) -> int:
        return self.n_dense + self.n_sparse * self.embed_dim


def init_params(gen: torch.Generator, cfg: RecSysConfig, *,
                device="cuda") -> dict:
    """Seeded parameters on ``device`` (drawn on the generator's
    device): tables N(0, 0.02^2), dense weights N(0, 1/fan_in), biases
    0, in the reference's tree."""
    dev = resolve_device(device)
    pd = cfg.param_dtype

    def dense(shape):
        return cm.dense_init(gen, shape, dtype=pd, device=dev)

    def zeros(shape):
        return torch.zeros(shape, dtype=pd, device=dev)

    rows = cfg.n_sparse * cfg.vocab_per_field
    params = {"tables": cm.embed_init(gen, (rows, cfg.embed_dim), dtype=pd,
                                      device=dev)}
    if cfg.kind == "fm":
        params["linear_sparse"] = cm.embed_init(gen, (rows, 1), dtype=pd,
                                                device=dev)
        if cfg.n_dense:
            params["linear_dense"] = dense((cfg.n_dense, 1))
            params["dense_emb"] = dense((cfg.n_dense, cfg.embed_dim))
        params["bias"] = zeros(())
        return params

    d0 = cfg.interaction_dim
    if cfg.kind == "dcn_v2":
        L = cfg.n_cross_layers
        if cfg.cross_rank:
            params["cross_u"] = torch.stack(
                [dense((d0, cfg.cross_rank)) for _ in range(L)])
            params["cross_v"] = torch.stack(
                [dense((cfg.cross_rank, d0)) for _ in range(L)])
        else:
            params["cross_w"] = torch.stack([dense((d0, d0))
                                             for _ in range(L)])
        params["cross_b"] = zeros((L, d0))
        dims = (d0,) + tuple(cfg.mlp_dims)
        params["mlp"] = [{"w": dense((dims[i], dims[i + 1])),
                          "b": zeros((dims[i + 1],))}
                         for i in range(len(dims) - 1)]
        params["head"] = dense((d0 + cfg.mlp_dims[-1], 1))
        return params

    if cfg.kind == "autoint":
        hd = cfg.n_attn_heads * cfg.d_attn
        params["attn"] = []
        d_in = cfg.embed_dim
        for _ in range(cfg.n_attn_layers):
            params["attn"].append({n: dense((d_in, hd))
                                   for n in ("wq", "wk", "wv", "wres")})
            d_in = hd
        params["head"] = dense((cfg.n_sparse * d_in, 1))
        if cfg.n_dense:
            params["dense_proj"] = dense((cfg.n_dense, cfg.embed_dim))
        return params

    raise ValueError(cfg.kind)


# ---------------------------------------------------------------------------
# Embedding lookup (the hot path)
# ---------------------------------------------------------------------------


def _folded(sparse_ids: torch.Tensor, cfg: RecSysConfig) -> torch.Tensor:
    """(B, n_sparse) field-local ids -> (B * n_sparse,) rows of the
    folded table."""
    offsets = torch.arange(cfg.n_sparse, device=sparse_ids.device) \
        * cfg.vocab_per_field
    return (sparse_ids.long() + offsets[None, :]).reshape(-1)


def lookup(params, sparse_ids: torch.Tensor,
           cfg: RecSysConfig) -> torch.Tensor:
    """(B, n_sparse) int -> (B, n_sparse, embed_dim): one gather from
    the folded table."""
    rows = cm.gather(params["tables"], _folded(sparse_ids, cfg), select=True)
    return rows.reshape(sparse_ids.shape[0], cfg.n_sparse, cfg.embed_dim)


# ---------------------------------------------------------------------------
# Forwards
# ---------------------------------------------------------------------------


def _fm_forward(params, batch, cfg: RecSysConfig):
    emb = lookup(params, batch["sparse"], cfg)  # (B, F, e)
    if cfg.n_dense:
        dense = batch["dense"].to(emb.dtype)  # (B, nd)
        demb = dense[:, :, None] * params["dense_emb"][None]  # (B, nd, e)
        emb = torch.cat([emb, demb], dim=1)
    # O(nk) sum-square trick: 0.5 * ((sum v)^2 - sum v^2)
    s = emb.sum(1)
    s2 = (emb * emb).sum(1)
    pair = 0.5 * (s * s - s2).sum(-1)  # (B,)
    lin = cm.gather(params["linear_sparse"], _folded(batch["sparse"], cfg),
                    select=True).reshape(
        batch["sparse"].shape[0], cfg.n_sparse).sum(1)
    if cfg.n_dense:
        lin = lin + (batch["dense"] @ params["linear_dense"])[:, 0]
    return pair + lin + params["bias"]


def _dcn_forward(params, batch, cfg: RecSysConfig):
    emb = lookup(params, batch["sparse"], cfg).reshape(
        batch["sparse"].shape[0], -1)
    x0 = torch.cat([batch["dense"].to(emb.dtype), emb], dim=-1) \
        if cfg.n_dense else emb  # (B, d0)
    x = x0
    for i in range(cfg.n_cross_layers):
        if cfg.cross_rank:
            wx = (x @ params["cross_u"][i]) @ params["cross_v"][i]
        else:
            wx = x @ params["cross_w"][i]
        x = x0 * (wx + params["cross_b"][i]) + x  # x0 ⊙ (Wx + b) + x
    h = x0
    for layer in params["mlp"]:
        h = torch.relu(h @ layer["w"] + layer["b"])
    both = torch.cat([x, h], dim=-1)
    return (both @ params["head"])[:, 0]


def _autoint_layer(x, wq, wk, wv, wres, H: int, da: int):
    B, F = x.shape[0], x.shape[1]
    q = (x @ wq).reshape(B, F, H, da)
    k = (x @ wk).reshape(B, F, H, da)
    v = (x @ wv).reshape(B, F, H, da)
    logits = torch.einsum("bfhd,bghd->bhfg", q, k) / math.sqrt(da)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhfg,bghd->bfhd", p, v).reshape(B, F, H * da)
    return torch.relu(o + x @ wres)


def _autoint_forward(params, batch, cfg: RecSysConfig):
    x = lookup(params, batch["sparse"], cfg)  # (B, F, e)
    layer = functools.partial(_autoint_layer, H=cfg.n_attn_heads,
                              da=cfg.d_attn)
    for lp in params["attn"]:
        # rows are independent: sharded rows attend on their own cards
        x = cm.per_row(layer, x, shared=(lp["wq"], lp["wk"], lp["wv"],
                                         lp["wres"]))
    return (x.reshape(x.shape[0], -1) @ params["head"])[:, 0]


_FORWARDS = {"fm": _fm_forward, "dcn_v2": _dcn_forward,
             "autoint": _autoint_forward}


def forward(params, batch, cfg: RecSysConfig,
            constrain=cm.keep) -> torch.Tensor:
    """CTR logit (B,).  ``constrain`` is the common sharding hook of the
    model forwards; as in the reference, this family calls it nowhere."""
    if cfg.kind not in _FORWARDS:
        raise ValueError(cfg.kind)
    return _FORWARDS[cfg.kind](params, batch, cfg)


def loss_fn(params, batch, cfg: RecSysConfig,
            constrain=cm.keep) -> torch.Tensor:
    return cm.binary_cross_entropy(forward(params, batch, cfg, constrain),
                                   batch["labels"])


def retrieval_score(params, user_batch: dict, cand_ids: torch.Tensor,
                    cfg: RecSysConfig) -> torch.Tensor:
    """Score ONE user context against n candidates (retrieval_cand cell).

    Candidates replace sparse field 0 (the item field); user-side fields
    broadcast.  Returns (n_candidates,) logits.
    """
    n = cand_ids.shape[0]
    # the candidates' column beside the user's others, broadcast: rows
    # follow the candidates (sharded with them on a mesh)
    user = user_batch["sparse"][0].long()[None, 1:].expand(
        n, cfg.n_sparse - 1)
    batch = {"sparse": torch.cat([cand_ids.long()[:, None], user], dim=1)}
    if cfg.n_dense:
        batch["dense"] = user_batch["dense"][0][None, :].expand(
            n, cfg.n_dense)
    return forward(params, batch, cfg)

