"""Shared model-building blocks, over torch tensors.

Counterpart of ``repro.models.common``: initializers, RMSNorm, SwiGLU,
RoPE and grouped-query attention, with the reference's layouts (heads
in the second-to-last axis, weights applied as ``x @ W``) and its
rounding points: reductions and softmax in fp32, results cast back to
the activation dtype where the reference casts.  The two training
losses compute in fp32, as the reference's.  ``layer_norm``,
``segment_sum`` and ``embedding_bag`` serve the recommender and
interatomic families; ``make_trainable`` is their training hook (a
nested dict/list parameter tree is its own training tree).
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch


def keep(a, kind: str):
    """The identity sharding hook: every model forward's default
    ``constrain`` (``launch.sharding.make_constrain`` gives the others)."""
    return a


def only(kind: str, constrain):
    """``constrain`` applied to activations of one ``kind`` alone."""
    return lambda a, k: constrain(a, k) if k == kind else a


def dense_init(gen: torch.Generator, shape, *, dtype=torch.float32,
               device=None):
    """N(0, 1/fan_in) with fan_in = shape[-2], drawn on the generator's
    device and moved to ``device``."""
    std = 1.0 / math.sqrt(shape[-2])
    w = torch.randn(shape, generator=gen, device=gen.device) * std
    return w.to(device=device, dtype=dtype)


def embed_init(gen: torch.Generator, shape, *, dtype=torch.float32,
               device=None):
    w = torch.randn(shape, generator=gen, device=gen.device) * 0.02
    return w.to(device=device, dtype=dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """Variance in fp32; x rescaled in its own dtype, as the reference."""
    var = x.to(torch.float32).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * scale.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Statistics and the affine map in fp32, output in x's dtype."""
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * scale + bias).to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.silu(gate.to(torch.float32)).to(gate.dtype) * up


def rope_freqs(d_head: int, theta: float = 10000.0, device=None):
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, dh); positions: (..., S)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)
    angles = positions[..., :, None, None].to(torch.float32) * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)  # (..., S, 1, dh/2)
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def gqa_attention(
    q: torch.Tensor,  # (B, S, H, dh)
    k: torch.Tensor,  # (B, T, KV, dh)
    v: torch.Tensor,  # (B, T, KV, dh)
    *,
    causal: bool = True,
    q_chunk: int = 0,
    kv_len: Optional[torch.Tensor] = None,  # (B,) valid KV prefix lengths
) -> torch.Tensor:
    """Grouped-query attention, KV heads shared by H/KV query heads.

    The reference keeps q/k/v in their storage dtype and accumulates in
    fp32; here the operands are widened to fp32 (products of bf16 values
    are exact in fp32), logits and softmax stay fp32, p is rounded to the
    activation dtype before the value product, as in the reference.
    ``q_chunk`` > 0 processes queries in chunks of that size when it
    divides S (bounds the (Sc, T) logit tile of a long prefill).
    """
    if is_dtensor(q):
        if kv_len is not None:
            raise NotImplementedError("kv_len on sharded operands")
        return on_local_shards(
            lambda q, k, v: gqa_attention(q, k, v, causal=causal,
                                          q_chunk=q_chunk),
            (q, k, v), head_dims=(2, 2, 2), out_head_dim=2)
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(dh)
    qr = q.reshape(B, S, KV, G, dh)
    k32, v32 = k.to(torch.float32), v.to(torch.float32)
    tpos = torch.arange(T, device=q.device)
    len_mask = None
    if kv_len is not None:
        len_mask = (tpos[None, :] < kv_len[:, None])[:, None, None, None, :]

    def chunk_attn(q_c, qpos_c):
        logits = torch.einsum("bskgd,btkd->bkgst", q_c.to(torch.float32),
                              k32) * scale  # (B, KV, G, Sc, T)
        mask = None
        if causal:
            mask = (qpos_c[:, None] >= tpos[None, :])[None, None, None]
        if len_mask is not None:
            mask = len_mask if mask is None else (mask & len_mask)
        if mask is not None:
            logits = torch.where(mask, logits, -1e30)
        p = torch.softmax(logits, dim=-1).to(q.dtype)
        out = torch.einsum("bkgst,btkd->bskgd", p.to(torch.float32), v32)
        return out.to(q.dtype)

    qpos = torch.arange(S, device=q.device)
    if q_chunk and S > q_chunk and S % q_chunk == 0:
        outs = [chunk_attn(qr[:, i:i + q_chunk], qpos[i:i + q_chunk])
                for i in range(0, S, q_chunk)]
        return torch.cat(outs, dim=1).reshape(B, S, H, dh)
    return chunk_attn(qr, qpos).reshape(B, S, H, dh)


# ---------------------------------------------------------------------------
# Sharded operands (DTensors of a dry-run, ``launch.analysis``)
# ---------------------------------------------------------------------------


def is_dtensor(t) -> bool:
    return hasattr(t, "_local_tensor") and hasattr(t, "placements")


def on_local_shards(fn, tensors, *, shared=(), head_dims=None,
                    out_head_dim=None, n_out: int = 1,
                    reduce_out: bool = False):
    """``fn(*tensors)`` for DTensor operands independent along their
    batch (dim 0) and, with ``head_dims``, head dims, run on each card's
    shards, as GSPMD partitions an attention: the operands take the
    first one's batch sharding and, on a mesh axis where its heads are
    sharded and every operand's head count divides, that head sharding;
    other axes are replicated.  DTensor's own propagation cannot shard
    the grouped-head products of an attention (its strided shards), and
    the backward of a gather builds a replicated tensor of the whole
    input, so the attention cores and the token losses go through here
    (``torch.distributed.tensor.experimental.local_map``); the
    redistributions into this layout are counted like any other.
    ``n_out`` outputs, each sharded as the batch; with ``reduce_out``
    each card's output is its part of a sum over the batch (``Partial``
    on the batch's axes).  ``shared`` operands (tables, weights) follow
    ``tensors`` as arguments of ``fn``, whole on every card; their
    gradients are sums over the cards.  Plain tensors among the operands
    are replicated."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = next(t for t in tensors + tuple(shared)
                if is_dtensor(t)).device_mesh

    def dt(t):
        return t if is_dtensor(t) else DTensor.from_local(
            t, mesh, [Replicate()] * mesh.ndim, run_check=False)

    tensors = tuple(dt(t) for t in tensors)
    shared = tuple(dt(t) for t in shared)
    first = tensors[0]
    ins = [[] for _ in tensors]
    out = []
    for i, p in enumerate(first.placements):
        n = mesh.size(i)
        if isinstance(p, Shard) and p.dim == 0:
            for pl in ins:
                pl.append(Shard(0))
            out.append(Partial() if reduce_out else Shard(0))
        elif (head_dims and isinstance(p, Shard) and p.dim == head_dims[0]
              and all(t.shape[d] % n == 0
                      for t, d in zip(tensors, head_dims))):
            for pl, d in zip(ins, head_dims):
                pl.append(Shard(d))
            out.append(Shard(out_head_dim))
        else:
            for pl in ins:
                pl.append(Replicate())
            out.append(Replicate())
    def local(*ts):
        return fn(*(_ContiguousGrad.apply(t) for t in ts))

    grads = ins + [[Partial()] * mesh.ndim for _ in shared]
    ins += [[Replicate()] * mesh.ndim for _ in shared]
    return local_map(local, out_placements=out if n_out == 1 else
                     (out,) * n_out, in_placements=tuple(ins),
                     in_grad_placements=tuple(grads), device_mesh=mesh,
                     redistribute_inputs=True)(*tensors, *shared)


def per_row(fn, *tensors, shared=(), n_out: int = 1,
            reduce_out: bool = False):
    """``fn(*tensors, *shared)`` for operands whose rows (dim 0) are
    independent: directly on plain tensors, on each card's rows of
    DTensors (:func:`on_local_shards`)."""
    if not any(is_dtensor(t) for t in tensors + tuple(shared)):
        return fn(*tensors, *shared)
    return on_local_shards(fn, tensors, shared=tuple(shared), n_out=n_out,
                           reduce_out=reduce_out)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose gradient is made contiguous: a shard's gradient
    leaves :func:`on_local_shards` in the layout the sharded ops after
    it view."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token CE. logits (..., V); labels (...,) int; with
    ``mask`` the masked mean (at least one in the denominator)."""
    if is_dtensor(logits):
        # per card on its rows, the vocabulary gathered (the gather's
        # backward would otherwise build the whole logits on every card)
        nll = on_local_shards(_token_nll, (logits, labels))
    else:
        nll = _token_nll(logits, labels)
    if mask is not None:
        mask = mask.to(torch.float32)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def _token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.long()[..., None])[..., 0]
    return lse - ll


def binary_cross_entropy(logits: torch.Tensor,
                         labels: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid CE of logits against {0, 1} labels, in the stable
    form max(l, 0) - l y + log1p(exp(-|l|))."""
    logits = logits.to(torch.float32)
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs()))).mean()


# ---------------------------------------------------------------------------
# Segment sums and EmbeddingBag
# ---------------------------------------------------------------------------


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: row i of ``data`` added to row
    ``segment_ids[i]`` of a zero (num_segments, ...) tensor, with
    ``index_add`` (every id must lie in [0, num_segments)); under
    ``torch.use_deterministic_algorithms(True)`` the card sums in a
    fixed order.  Sharded rows are summed on each card and the cards'
    sums added."""
    return per_row(functools.partial(_segment_sum, num_segments=num_segments),
                   data, segment_ids, reduce_out=True)


def _segment_sum(data, segment_ids, num_segments):
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add(0, segment_ids.long(), data)


def gather(table: torch.Tensor, ids: torch.Tensor,
           select: bool = False) -> torch.Tensor:
    """``table[ids]``, or ``table.index_select(0, ids)`` with ``select``;
    each card of sharded ``ids`` gathers its own rows from the whole
    table (replicated for the gather; its gradient the cards' sum)."""
    fn = (lambda i, t: t.index_select(0, i)) if select else (
        lambda i, t: t[i])
    return per_row(fn, ids, shared=(table,))


def embedding_bag(
    table: torch.Tensor,  # (vocab, dim)
    indices: torch.Tensor,  # (n_lookups,)
    segment_ids: torch.Tensor,  # (n_lookups,) which bag each lookup joins
    num_bags: int,
    weights: Optional[torch.Tensor] = None,
    combiner: str = "sum",
) -> torch.Tensor:
    """Multi-hot embedding lookup + per-bag reduction: (num_bags, dim);
    ``combiner`` ``sum`` or ``mean`` (an empty bag's mean is 0)."""
    rows = table.index_select(0, indices.long())
    if weights is not None:
        rows = rows * weights[:, None]
    summed = segment_sum(rows, segment_ids, num_bags)
    if combiner == "sum":
        return summed
    if combiner == "mean":
        counts = segment_sum(torch.ones_like(segment_ids, dtype=rows.dtype),
                             segment_ids, num_bags)
        return summed / torch.clamp(counts[:, None], min=1.0)
    raise ValueError(combiner)


# ---------------------------------------------------------------------------
# Training hooks of the families whose parameters are plain trees
# ---------------------------------------------------------------------------


def tree_items(tree, path=()):
    """(path, leaf) pairs of a nested dict/list of tensors in the
    reference's flatten order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in tree_items(tree[k],
                                                              path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree) for kv in tree_items(
            x, path + (i,))]
    return [(path, tree)]


def make_trainable(params):
    """A nested dict/list parameter tree is its own training tree: every
    leaf gets ``requires_grad`` (the optimizer updates it in place)."""
    for _, leaf in tree_items(params):
        leaf.requires_grad_(True)
    return params

