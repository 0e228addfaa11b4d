"""Shared model-building blocks, over torch tensors.

Counterpart of ``repro.models.common``: initializers, RMSNorm, SwiGLU,
RoPE and grouped-query attention, with the reference's layouts (heads
in the second-to-last axis, weights applied as ``x @ W``) and its
rounding points: reductions and softmax in fp32, results cast back to
the activation dtype where the reference casts.  Losses, ``layer_norm``
and ``embedding_bag`` come with the training and recsys slices.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


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
