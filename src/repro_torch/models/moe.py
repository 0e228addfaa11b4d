"""Mixture-of-Experts FFN block (token-choice top-k, GShard-style).

Counterpart of ``repro.models.moe``.  Dispatch is gather/scatter-based
(not the one-hot einsum, whose FLOP cost would dwarf the expert matmuls
at E = 384): tokens are grouped, each (token, choice) pair receives a
slot in a per-group (E, capacity) buffer via a stable sort by expert id,
and the expert GEMMs run batched over the buffer.  Overflowing pairs
are dropped (``capacity_factor`` controls head room), GShard semantics.

Dtypes as the reference's: router logits and softmax in fp32, the gate
weights rounded to the activation dtype, the buffer and the expert
GEMMs (``torch.bmm`` over E) in the activation dtype.  The router's
top-k is a stable sort, probability descending and then expert id
ascending, the order ``jax.lax.top_k`` gives ties.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch import nn

from repro_torch.models import common as cm


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int  # per-expert hidden width
    capacity_factor: float = 1.25
    group_size: int = 4096  # tokens per dispatch group
    router_aux_weight: float = 0.01


class MoEParams(nn.Module):
    """One layer's MoE weights: ``router`` (D, E) fp32, ``w_gate`` and
    ``w_up`` (E, D, F), ``w_down`` (E, F, D)."""

    NAMES = ("router", "w_gate", "w_up", "w_down")

    def __init__(self, weights: dict):
        super().__init__()
        for name in self.NAMES:
            setattr(self, name,
                    nn.Parameter(weights[name], requires_grad=False))


def init_moe(gen: torch.Generator, cfg: MoEConfig, d_model: int, *,
             dtype=torch.float32, device=None) -> MoEParams:
    """The reference's distributions: dense N(0, 1/fan_in) weights, the
    router in fp32, the experts in ``dtype``."""
    E, F = cfg.n_experts, cfg.d_ff
    return MoEParams({
        "router": cm.dense_init(gen, (d_model, E), dtype=torch.float32,
                                device=device),
        "w_gate": cm.dense_init(gen, (E, d_model, F), dtype=dtype,
                                device=device),
        "w_up": cm.dense_init(gen, (E, d_model, F), dtype=dtype,
                              device=device),
        "w_down": cm.dense_init(gen, (E, F, d_model), dtype=dtype,
                                device=device),
    })


def route(params: MoEParams, x: torch.Tensor, cfg: MoEConfig):
    """The router: (probs (T, E) fp32, top_p (T, k) renormalized, top_e
    (T, k) int64), choices by probability descending, then expert id."""
    logits = x.to(torch.float32) @ params.router
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = cm.per_row(functools.partial(_top, k=cfg.top_k), probs,
                              n_out=2)
    top_p = top_p / torch.clamp(top_p.sum(dim=-1, keepdim=True), min=1e-9)
    return probs, top_p, top_e


def _top(probs: torch.Tensor, k: int):
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    return top_p[:, :k], top_e[:, :k]


def slots(top_e: torch.Tensor, cfg: MoEConfig, G: int):
    """Each (token, choice) pair's buffer slot per group: (slot, keep),
    each (n_groups, G*k).  Position within an expert = the pair's rank
    among the group's pairs for that expert (a stable sort by expert
    id); pairs at or beyond the capacity go to the drop bin E*cap."""
    return cm.per_row(functools.partial(_group_slots, cfg=cfg,
                                        cap=capacity(cfg, G)),
                      top_e.reshape(-1, G * cfg.top_k), n_out=2)


def _group_slots(ge: torch.Tensor, cfg: MoEConfig, cap: int):
    E = cfg.n_experts
    order = torch.argsort(ge, dim=-1, stable=True)
    sorted_e = ge.gather(1, order)
    experts = torch.arange(E, device=ge.device).expand(ge.shape[0], E)
    first = torch.searchsorted(sorted_e.contiguous(), experts.contiguous(),
                               right=False)
    pos_sorted = (torch.arange(ge.shape[1], device=ge.device)[None, :]
                  - first.gather(1, sorted_e))
    pos = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)
    keep = pos < cap
    return torch.where(keep, ge * cap + pos, E * cap), keep


def capacity(cfg: MoEConfig, G: int) -> int:
    return int((G * cfg.top_k * cfg.capacity_factor) / cfg.n_experts) + 1


def expert_counts(top_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """How many rows chose each expert: ``bincount(top_e, minlength=E)``
    with a static (E,) shape (a sum of ones; the same integers), so a
    trace on fake tensors needs no host read of the largest id; on
    sharded rows each card counts its own and the counts are summed."""
    return cm.per_row(lambda e: e.new_zeros(n_experts).index_add_(
        0, e, torch.ones_like(e)), top_e, reduce_out=True)


def _dispatch(xg: torch.Tensor, slot: torch.Tensor, k: int, E: int,
              cap: int) -> torch.Tensor:
    """Scatter each group's pair rows into its (E, cap, D) buffer; the
    drop bin (the last row) is cut after the scatter."""
    n_groups, _, D = xg.shape
    rows = xg.repeat_interleave(k, dim=1)
    buf = rows.new_zeros(n_groups, E * cap + 1, D)
    buf.scatter_(1, slot[..., None].expand(-1, -1, D), rows)
    return buf[:, :-1].reshape(n_groups, E, cap, D)


def _combine(out_buf: torch.Tensor, slot: torch.Tensor, w: torch.Tensor,
             k: int) -> torch.Tensor:
    """Gather each pair's expert output back (the drop bin reads zeros)
    and sum a token's k choices weighted by ``w``: (n_groups, G, D)."""
    n_groups, E, cap, D = out_buf.shape
    out_flat = out_buf.reshape(n_groups, E * cap, D)
    out_flat = torch.cat([out_flat, out_flat.new_zeros(n_groups, 1, D)],
                         dim=1)
    picked = out_flat.gather(1, slot[..., None].expand(-1, -1, D))
    contrib = picked * w[..., None]
    return contrib.reshape(n_groups, -1, k, D).sum(dim=2)


def moe_block(params: MoEParams, x: torch.Tensor, cfg: MoEConfig,
              constrain=cm.keep):
    """x (T, D) flattened tokens -> (out (T, D) in x's dtype, aux loss
    scalar fp32).  ``constrain`` pins the (groups, E, cap, D) expert
    buffers, as the reference's."""
    T, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    G = min(cfg.group_size, T)
    if T % G:
        raise ValueError(f"{T} tokens do not split into groups of {G}")
    n_groups = T // G
    cap = capacity(cfg, G)

    probs, top_p, top_e = route(params, x, cfg)
    # load-balance auxiliary loss (Switch/GShard)
    me = probs.mean(dim=0)
    ce = expert_counts(top_e[:, 0], E).to(torch.float32) / T
    aux = cfg.router_aux_weight * E * (me * ce).sum()

    slot, keep = slots(top_e, cfg, G)  # (n_groups, G*k)
    gp = top_p.reshape(n_groups, G * k).to(x.dtype)

    # dispatch and combine run per group (on each card's groups when
    # sharded); the expert products batch over E
    buf = cm.per_row(functools.partial(_dispatch, k=k, E=E, cap=cap),
                     x.reshape(n_groups, G, D), slot)
    buf = constrain(buf, "moe_buffer")
    # (E, n_groups*cap, D): one batched product per weight over E
    eb = buf.transpose(0, 1).reshape(E, n_groups * cap, D)
    gate = torch.bmm(eb, params.w_gate.to(x.dtype))
    up = torch.bmm(eb, params.w_up.to(x.dtype))
    out_buf = torch.bmm(cm.swiglu(gate, up), params.w_down.to(x.dtype))
    out_buf = constrain(out_buf.reshape(E, n_groups, cap, D).transpose(0, 1),
                        "moe_buffer")
    out = cm.per_row(functools.partial(_combine, k=k), out_buf, slot,
                     gp * keep.to(gp.dtype)).reshape(T, D)
    if cm.is_dtensor(out):  # back to the tokens' sharding (groups may
        # be sharded over more axes than the batch they reshape into)
        from torch.distributed.tensor import Replicate

        out = out.redistribute(x.device_mesh, [
            Replicate() if p.is_partial() else p for p in x.placements])
    return out, aux
