"""Optimizers (counterpart of ``repro.train.optim``): AdamW, Adafactor
(factored second moment; with ``b1 = 0`` no first moment at all, the
1T-parameter MoE's memory saving) and Muon (momentum orthogonalized by
the Newton-Schulz iteration of the ASH learner's Procrustes step).

The API mirrors the reference's (and optax's): ``init(params) ->
state``; ``update(grads, state, params) -> (updates, state)``; updates
are ADDED by ``apply_updates``.  ``params``, ``grads`` and the moment
buffers are trees: nested dicts and lists of tensors, flattened as the
reference's pytrees, each leaf the reference's leaf (a
transformer's layer weights stacked along L: ``models.transformer.
make_trainable``).  Every rule sees the stacked leaf, so Adafactor's
column statistic of an (L, D) norm scale is a mean over layers and
Muon orthogonalizes it as an L x D matrix, as the reference's do.

Plain functions on tensors with the reference's arithmetic in its order
(not ``torch.optim``, which orders and fuses the operations otherwise).
Unlike the reference, state buffers are updated in place, and
``clip_by_global_norm`` and ``apply_updates`` write into their first
argument: a functional copy of billions of parameters and their moments
does not fit the card.  Scalars (the learning rate, bias corrections,
Adafactor's decay) are computed in fp32 as the reference's are; AdamW's
elementwise work runs in row chunks to bound its fp32 temporaries.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, NamedTuple

import torch

from repro_torch.core.learning import newton_schulz
from repro_torch.device import full_fp32, host_scalars

CHUNK_ELEMS = 1 << 24  # elements a chunk of AdamW's and apply's row loops


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"  # adamw | adafactor | muon
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    # memory knobs for the >=100B regime
    moment_dtype: torch.dtype = torch.float32  # bf16 halves optimizer memory
    # muon
    ns_steps: int = 5
    # warmup/cosine schedule
    warmup_steps: int = 100
    total_steps: int = 10_000


# ---------------------------------------------------------------------------
# Trees: nested dicts and lists of tensors, in the reference's pytree
# order (dict keys sorted, lists in order)
# ---------------------------------------------------------------------------


def tree_leaves(tree) -> list:
    """The leaves of a nested dict/list, keys sorted at every level."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, list):
        return [tree_map(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
    return fn(tree, *rest)


def _chunks(*tensors, max_elems: int = CHUNK_ELEMS):
    """Matching slices of same-shape tensors along dim 0, each of at most
    ``max_elems`` elements (at least one row).  A DTensor sharded along
    dim 0 (a leaf of ``configs.base``'s sharded states) is not sliced: a
    slice of its sharded dim would gather it, and each card's shard is
    already a fraction."""
    t0 = tensors[0]
    if (t0.dim() == 0 or t0.numel() <= max_elems
            or any(getattr(p, "dim", None) == 0
                   for p in getattr(t0, "placements", ()))):
        yield tensors
        return
    rows = max(1, max_elems // (t0.numel() // t0.shape[0]))
    for i in range(0, t0.shape[0], rows):
        yield tuple(t[i:i + rows] for t in tensors)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


# ---------------------------------------------------------------------------
# Schedule and clipping
# ---------------------------------------------------------------------------


@host_scalars()
def lr_at(cfg: OptConfig, step) -> float:
    """Linear warmup then cosine decay to 10 % of ``cfg.lr``, in fp32;
    ``step`` an int or an int tensor.  The fp32 value as a float."""
    step = torch.as_tensor(step).to(torch.int32)
    warm = torch.clamp(step.float() / _f32(max(cfg.warmup_steps, 1)),
                       max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps).float()
        / _f32(max(cfg.total_steps - cfg.warmup_steps, 1)), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return float(cfg.lr * warm * (0.1 + 0.9 * cos))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares."""
    return torch.sqrt(sum(x.to(torch.float32).square().sum()
                          for x in tree_leaves(tree)))


@torch.no_grad()
def clip_by_global_norm(tree, max_norm: float):
    """Scale every leaf by min(1, max_norm / ||tree||) IN PLACE (in fp32,
    rounded back to the leaf's dtype); returns (tree, the norm before)."""
    gn = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for g in tree_leaves(tree):
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:
            g.copy_(g.to(torch.float32) * scale)
    return tree, gn


@host_scalars()
def _pow_correction(b: float, step: torch.Tensor) -> float:
    """1 - b ** step in fp32 (Adam's bias correction)."""
    return float(1 - _f32(b) ** step.float())


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


class AdamState(NamedTuple):
    step: torch.Tensor  # int32, on the CPU
    mu: Any
    nu: Any


@host_scalars()
def _step0() -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32)


@host_scalars()
def next_step(step: torch.Tensor) -> torch.Tensor:
    """``step + 1``: the CPU counter of a state, kept real in a trace."""
    return step + 1


@host_scalars()
def _adafactor_decay(step: torch.Tensor) -> float:
    return float(1.0 - (step.float() + 1.0) ** -0.8)


@host_scalars()
def _muon_scale(shape) -> float:
    return float(torch.sqrt(_f32(max(shape)) / _f32(min(shape))))


def adamw_init(cfg: OptConfig, params) -> AdamState:
    def z(p):
        return torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)

    return AdamState(step=_step0(), mu=tree_map(z, params),
                     nu=tree_map(z, params))


@torch.no_grad()
def adamw_update(cfg: OptConfig, grads, state: AdamState, params):
    step = next_step(state.step)
    lr = lr_at(cfg, step)
    grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
    bc1 = _pow_correction(cfg.b1, step)
    bc2 = _pow_correction(cfg.b2, step)

    def upd(g, m, v, p):
        u = torch.empty_like(p)
        for gc, mc, vc, pc, uc in _chunks(g, m, v, p, u):
            g32 = gc.to(torch.float32)
            m32 = cfg.b1 * mc.to(torch.float32) + (1 - cfg.b1) * g32
            v32 = cfg.b2 * vc.to(torch.float32) + (1 - cfg.b2) * g32 * g32
            mhat = m32 / bc1
            vhat = v32 / bc2
            uc.copy_(-lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                            + cfg.weight_decay * pc.to(torch.float32)))
            mc.copy_(m32)
            vc.copy_(v32)
        return u

    updates = tree_map(upd, grads, state.mu, state.nu, params)
    return updates, AdamState(step=step, mu=state.mu, nu=state.nu)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment; Shazeer & Stern 2018)
# ---------------------------------------------------------------------------


class AdafactorState(NamedTuple):
    step: torch.Tensor
    mu: Any  # first moment (moment_dtype); (1,) dummies when b1 == 0
    vr: Any  # row statistics
    vc: Any  # col statistics
    v: Any  # full second moment for <2D params


def _factored(p) -> bool:
    return p.dim() >= 2


def _settled(t):
    """``t``, or for a DTensor mean over a sharded dim (pending sums on
    some mesh axes) the same values with the sums reduced, before it
    meets a sharded operand; a plain tensor as it is."""
    pending = [getattr(p, "is_partial", lambda: False)()
               for p in getattr(t, "placements", ())]
    if not any(pending):
        return t
    from torch.distributed.tensor import Replicate

    return t.redistribute(placements=[
        Replicate() if d else p for p, d in zip(t.placements, pending)])


def adafactor_init(cfg: OptConfig, params) -> AdafactorState:
    f32 = torch.float32

    def zr(p):
        shape = p.shape[:-1] if _factored(p) else (1,)
        return torch.zeros(shape, dtype=f32, device=p.device)

    def zc(p):
        shape = p.shape[:-2] + p.shape[-1:] if _factored(p) else (1,)
        return torch.zeros(shape, dtype=f32, device=p.device)

    def zv(p):
        shape = (1,) if _factored(p) else p.shape
        return torch.zeros(shape, dtype=f32, device=p.device)

    # b1 == 0 -> momentum-free Adafactor (classic): no first-moment
    # buffers at all, the key memory saving for the 1T-param config.
    def zm(p):
        shape = (1,) if cfg.b1 == 0.0 else p.shape
        return torch.zeros(shape, dtype=cfg.moment_dtype, device=p.device)

    return AdafactorState(step=_step0(), mu=tree_map(zm, params),
                          vr=tree_map(zr, params), vc=tree_map(zc, params),
                          v=tree_map(zv, params))


@torch.no_grad()
def adafactor_update(cfg: OptConfig, grads, state: AdafactorState, params):
    step = next_step(state.step)
    lr = lr_at(cfg, step)
    grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
    decay = _adafactor_decay(step)

    def upd(g, m, vr, vc, v, p):
        g32 = g.to(torch.float32)
        g2 = g32 * g32 + 1e-30
        if _factored(p):
            vr_n = decay * vr + (1 - decay) * _settled(g2.mean(dim=-1))
            vc_n = decay * vc + (1 - decay) * _settled(g2.mean(dim=-2))
            denom = torch.clamp(_settled(vr_n.mean(dim=-1, keepdim=True)),
                                min=1e-30)
            vhat = vr_n[..., None] * vc_n[..., None, :] / denom[..., None]
            vr.copy_(vr_n)
            vc.copy_(vc_n)
        else:
            vhat = decay * v + (1 - decay) * g2
            v.copy_(vhat)
        u = g32 / torch.sqrt(vhat + cfg.eps)
        if cfg.b1 == 0.0:
            upd32 = u  # the (1,) dummy buffer stays untouched
        else:
            m.copy_(cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * u)
            upd32 = m.to(torch.float32)
        out = -lr * (upd32 + cfg.weight_decay * p.to(torch.float32))
        return out.to(p.dtype)

    updates = tree_map(upd, grads, state.mu, state.vr, state.vc, state.v,
                       params)
    return updates, state._replace(step=step)


# ---------------------------------------------------------------------------
# Muon (momentum + Newton-Schulz orthogonalization for 2D params)
# ---------------------------------------------------------------------------


class MuonState(NamedTuple):
    step: torch.Tensor
    mu: Any


def muon_init(cfg: OptConfig, params) -> MuonState:
    return MuonState(step=_step0(), mu=tree_map(
        lambda p: torch.zeros(p.shape, dtype=cfg.moment_dtype,
                              device=p.device), params))


@torch.no_grad()
def muon_update(cfg: OptConfig, grads, state: MuonState, params):
    full_fp32()
    step = next_step(state.step)
    lr = lr_at(cfg, step)
    grads, _ = clip_by_global_norm(grads, cfg.grad_clip)

    def upd(g, m, p):
        m32 = cfg.b1 * m.to(torch.float32) + g.to(torch.float32)
        if p.dim() == 2 and min(p.shape) > 1:
            # polar factor of m32 (== U V^T of its SVD), same shape
            o = newton_schulz(m32.T, steps=cfg.ns_steps)
            o = o * _muon_scale(p.shape)
        else:
            o = m32 / (torch.linalg.vector_norm(m32.reshape(-1)) + 1e-9)
        m.copy_(m32)
        return (-lr * (o + cfg.weight_decay * p.to(torch.float32))).to(
            p.dtype)

    updates = tree_map(upd, grads, state.mu, params)
    return updates, MuonState(step=step, mu=state.mu)


# ---------------------------------------------------------------------------
# Dispatcher
# ---------------------------------------------------------------------------


def make_optimizer(cfg: OptConfig):
    if cfg.name == "adamw":
        return (functools.partial(adamw_init, cfg),
                functools.partial(adamw_update, cfg))
    if cfg.name == "adafactor":
        return (functools.partial(adafactor_init, cfg),
                functools.partial(adafactor_update, cfg))
    if cfg.name == "muon":
        return (functools.partial(muon_init, cfg),
                functools.partial(muon_update, cfg))
    raise ValueError(cfg.name)


@torch.no_grad()
def apply_updates(params, updates):
    """p <- (p + u) in fp32, rounded to p's dtype, IN PLACE; returns
    ``params``."""
    def add(p, u):
        for pc, uc in _chunks(p, u):
            pc.copy_(pc.to(torch.float32) + uc.to(torch.float32))

    tree_map(add, params, updates)
    return params
