"""SASRec [Kang & McAuley 2018]: self-attentive sequential recommender
(counterpart of ``repro.models.sasrec``).

Next-item retrieval is a MIPS problem over the item-embedding table.
``retrieval_score`` gives the exact dot products; the ASH-compressed
path (item embeddings encoded once, user states scored by the fused
asymmetric scan) is ``serving.retrieval.sasrec_retrieve``.

Parameters are the reference's tree: a nested dict whose ``blocks`` is
a list of dicts, in the reference's order, with tensors for leaves.
The attention is the reference's einsums with fp32 logits and the
``-1e30`` mask (not SDPA): a row whose keys are all padding gets the
reference's uniform softmax.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.models import common as cm

make_trainable = cm.make_trainable


@dataclasses.dataclass(frozen=True)
class SASRecConfig:
    name: str = "sasrec"
    n_items: int = 1_000_000
    embed_dim: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    seq_len: int = 50
    n_neg: int = 128  # sampled-softmax negatives for training
    dtype: Any = torch.float32
    param_dtype: Any = torch.float32


def init_params(gen: torch.Generator, cfg: SASRecConfig, *,
                device="cuda") -> dict:
    """Seeded parameters on ``device`` (drawn on the generator's device):
    embeddings N(0, 0.02^2), projections N(0, 1/e), norms 1 and 0."""
    dev = resolve_device(device)
    pd, e = cfg.param_dtype, cfg.embed_dim

    def dense(shape):
        return cm.dense_init(gen, shape, dtype=pd, device=dev)

    def ones():
        return torch.ones((e,), dtype=pd, device=dev)

    def zeros():
        return torch.zeros((e,), dtype=pd, device=dev)

    params = {
        "item_emb": cm.embed_init(gen, (cfg.n_items, e), dtype=pd,
                                  device=dev),
        "pos_emb": cm.embed_init(gen, (cfg.seq_len, e), dtype=pd,
                                 device=dev),
        "blocks": [],
        "final_ln_s": ones(),
        "final_ln_b": zeros(),
    }
    for _ in range(cfg.n_blocks):
        params["blocks"].append({
            "ln1_s": ones(), "ln1_b": zeros(),
            "wq": dense((e, e)), "wk": dense((e, e)),
            "wv": dense((e, e)), "wo": dense((e, e)),
            "ln2_s": ones(), "ln2_b": zeros(),
            "ff1": dense((e, e)), "ff1_b": zeros(),
            "ff2": dense((e, e)), "ff2_b": zeros(),
        })
    return params


def encode_sequence(params, seq: torch.Tensor,
                    cfg: SASRecConfig) -> torch.Tensor:
    """(B, S) item ids (0 = padding) -> (B, S, e) hidden states."""
    B, S = seq.shape
    e = cfg.embed_dim
    seq = seq.long()
    x = cm.gather(params["item_emb"], seq) * math.sqrt(e)
    x = x + params["pos_emb"][None, :S]
    pad_mask = (seq > 0)[:, :, None]
    x = x * pad_mask.to(x.dtype)
    H = cfg.n_heads
    dh = e // H
    causal = torch.ones((S, S), dtype=torch.bool, device=seq.device).tril()
    keep = causal[None, None] & (seq > 0)[:, None, None, :]
    for bp in params["blocks"]:
        h = cm.layer_norm(x, bp["ln1_s"], bp["ln1_b"])
        q = (h @ bp["wq"]).reshape(B, S, H, dh)
        k = (h @ bp["wk"]).reshape(B, S, H, dh)
        v = (h @ bp["wv"]).reshape(B, S, H, dh)
        logits = torch.einsum("bshd,bthd->bhst", q.to(torch.float32),
                              k.to(torch.float32)) / math.sqrt(dh)
        logits = torch.where(keep, logits, -1e30)
        p = torch.softmax(logits, dim=-1)
        o = torch.einsum("bhst,bthd->bshd", p, v.to(torch.float32))
        x = x + (o.reshape(B, S, e) @ bp["wo"]).to(x.dtype)
        h2 = cm.layer_norm(x, bp["ln2_s"], bp["ln2_b"])
        ff = torch.relu(h2 @ bp["ff1"] + bp["ff1_b"])
        x = x + (ff @ bp["ff2"] + bp["ff2_b"])
        x = x * pad_mask.to(x.dtype)
    return cm.layer_norm(x, params["final_ln_s"], params["final_ln_b"])


def loss_fn(params, batch, cfg: SASRecConfig,
            constrain=cm.keep) -> torch.Tensor:
    """Sampled-softmax next-item loss (``constrain``, the common
    sharding hook, is unused here as in the reference).

    batch: seq (B, S), labels (B, S) next item per position (0 = pad),
    negatives (n_neg,) shared sampled item ids.
    """
    h = encode_sequence(params, batch["seq"], cfg).to(torch.float32)
    pos_emb = cm.gather(params["item_emb"],
                        batch["labels"].long())  # (B, S, e)
    neg_emb = cm.gather(params["item_emb"],
                        batch["negatives"].long())  # (n_neg, e)
    pos_logit = (h * pos_emb.to(torch.float32)).sum(-1)  # (B, S)
    neg_logit = torch.einsum("bse,ne->bsn", h,
                             neg_emb.to(torch.float32))  # (B, S, n_neg)
    logits = torch.cat([pos_logit[..., None], neg_logit], dim=-1)
    mask = (batch["labels"] > 0).to(torch.float32)
    nll = -torch.log_softmax(logits, dim=-1)[..., 0]
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def user_state(params, seq: torch.Tensor,
               cfg: SASRecConfig) -> torch.Tensor:
    """(B, S) -> (B, e): the query vector for next-item retrieval (the
    hidden state at the last non-padding position)."""
    h = encode_sequence(params, seq, cfg)
    lengths = (seq > 0).sum(-1)
    idx = torch.clamp(lengths - 1, min=0)
    return cm.per_row(
        lambda h, i: h[torch.arange(h.shape[0], device=h.device), i], h, idx)


def retrieval_score(params, seq: torch.Tensor, cand_ids: torch.Tensor,
                    cfg: SASRecConfig) -> torch.Tensor:
    """Exact MIPS scores of each user state vs candidate items: (B, n)."""
    u = user_state(params, seq, cfg)  # (B, e)
    cand = cm.gather(params["item_emb"], cand_ids.long())  # (n, e)
    return u.to(torch.float32) @ cand.to(torch.float32).T

