"""Decoder-only transformer (dense, GQA, RoPE, SwiGLU) for serving.

Counterpart of ``repro.models.transformer`` for the dense
architectures: ``init_params``, ``forward``/``prefill``, ``init_cache``
and ``decode_step`` with a bf16 KV cache or, with
``cfg.kv_quant_bits > 0``, an ASH-compressed one.  Keys and values are
projected per KV head by a row-orthonormal matrix, quantized to b bits
on the V_b grid and bit-packed (``_encode_kv``); attention logits use
the asymmetric estimator of Eq. (20) with mu = 0, and the V
de-projection is applied once per step after the probability-weighted
reduction (the linear decoder of Section 2.2).  On the card that
attention is the hand-written kernel ``kernels/csrc/ash_kv_attn.cu``
(``ops.ash_kv_attention``), which reads the packed cache in place and
never unpacks it into device memory.

The parameters are an ``nn.Module`` with per-layer weights in the
reference's layout (applied as ``x @ W``); the reference's layer scan is
a Python loop.  Serving only: no remat, sharding constraints or MoE
(a config with ``moe`` raises), and the cache is updated in place
(``decode_step`` returns the same dict), since a copy of a 31 GB cache
per step is not affordable.  Entry points run on ``device="cuda"``
unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
from torch import nn

from repro_torch.core import quantization as Q
from repro_torch.device import full_fp32, resolve_device
from repro_torch.kernels import ops
from repro_torch.models import common as cm


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    moe: Optional[Any] = None
    dtype: torch.dtype = torch.bfloat16  # activation dtype
    param_dtype: torch.dtype = torch.bfloat16
    q_chunk: int = 2048  # query chunking for long prefill (0 = off)
    # ASH-KV cache compression (0 = off -> bf16 cache)
    kv_quant_bits: int = 0
    kv_quant_dim: int = 0  # 0 -> d_head (no dim reduction)

    def __post_init__(self):
        if self.moe is not None:
            raise NotImplementedError(
                "MoE transformers are not ported yet (models/moe.py)")

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def code_dim(self) -> int:
        return self.kv_quant_dim or self.head_dim

    def param_count(self) -> int:
        D, H, KV, dh = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim
        attn = D * (H * dh) + 2 * D * (KV * dh) + (H * dh) * D
        return (self.n_layers * (attn + 3 * D * self.d_ff + 2 * D)
                + 2 * self.vocab * D + D)


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Layer(nn.Module):
    """One decoder layer's weights (the reference's ``layers`` slice)."""

    NAMES = ("attn_norm", "ffn_norm", "wq", "wk", "wv", "wo", "w_gate",
             "w_up", "w_down")
    BIAS_NAMES = ("bq", "bk", "bv")

    def __init__(self, weights: dict):
        super().__init__()
        for name, t in weights.items():
            setattr(self, name, _frozen(t))


class Transformer(nn.Module):
    """Parameters of a dense decoder: ``embed``, ``layers``,
    ``final_norm``, ``lm_head`` and, for an ASH-KV config, the per
    (layer, KV head) projections ``kv_Wk``/``kv_Wv`` (L, KV, dc, dh)
    fp32."""

    def __init__(self, cfg: TransformerConfig, embed, layers, final_norm,
                 lm_head, kv_Wk=None, kv_Wv=None):
        super().__init__()
        self.cfg = cfg
        self.embed = _frozen(embed)
        self.layers = nn.ModuleList(Layer(w) for w in layers)
        self.final_norm = _frozen(final_norm)
        self.lm_head = _frozen(lm_head)
        self.kv_Wk = None if kv_Wk is None else _frozen(kv_Wk)
        self.kv_Wv = None if kv_Wv is None else _frozen(kv_Wv)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self, tokens, self.cfg)[0]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(gen: torch.Generator, cfg: TransformerConfig, *,
                device="cuda") -> Transformer:
    """Random parameters drawn from ``gen`` (on its own device), placed on
    ``device``.  Distributions as the reference's: dense weights
    N(0, 1/fan_in), embedding N(0, 0.02^2), norms one, biases zero, and
    for ASH-KV a random row-orthonormal (dc, dh) projection per (layer,
    KV head) for K and for V (data-agnostic ASH)."""
    dev = resolve_device(device)
    D, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    F, V, pd = cfg.d_ff, cfg.vocab, cfg.param_dtype

    def dense(shape):
        return cm.dense_init(gen, shape, dtype=pd, device=dev)

    layers = []
    for _ in range(cfg.n_layers):
        w = {
            "attn_norm": torch.ones(D, dtype=pd, device=dev),
            "ffn_norm": torch.ones(D, dtype=pd, device=dev),
            "wq": dense((D, H * dh)), "wk": dense((D, KV * dh)),
            "wv": dense((D, KV * dh)), "wo": dense((H * dh, D)),
            "w_gate": dense((D, F)), "w_up": dense((D, F)),
            "w_down": dense((F, D)),
        }
        if cfg.qkv_bias:
            w["bq"] = torch.zeros(H * dh, dtype=pd, device=dev)
            w["bk"] = torch.zeros(KV * dh, dtype=pd, device=dev)
            w["bv"] = torch.zeros(KV * dh, dtype=pd, device=dev)
        layers.append(w)
    embed = cm.embed_init(gen, (V, D), dtype=pd, device=dev)
    lm_head = dense((D, V))
    kv_Wk = kv_Wv = None
    if cfg.kv_quant_bits:
        full_fp32()
        g = torch.randn(cfg.n_layers, KV, 2, dh, dh, generator=gen,
                        device=gen.device).to(dev)
        qm = torch.linalg.qr(g).Q[..., :cfg.code_dim].transpose(-1, -2)
        kv_Wk = qm[:, :, 0].contiguous()
        kv_Wv = qm[:, :, 1].contiguous()
    return Transformer(cfg, embed, layers, torch.ones(D, dtype=pd, device=dev),
                       lm_head, kv_Wk, kv_Wv)


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------


def _qkv(cfg: TransformerConfig, lp: Layer, h: torch.Tensor):
    q, k, v = h @ lp.wq, h @ lp.wk, h @ lp.wv
    if cfg.qkv_bias:
        q, k, v = q + lp.bq, k + lp.bk, v + lp.bv
    return q, k, v


def _ffn(cfg: TransformerConfig, lp: Layer, x: torch.Tensor) -> torch.Tensor:
    h = cm.rms_norm(x, lp.ffn_norm, cfg.norm_eps)
    return x + cm.swiglu(h @ lp.w_gate, h @ lp.w_up) @ lp.w_down


def _layer(cfg: TransformerConfig, lp: Layer, x: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    B, S, _ = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = cm.rms_norm(x, lp.attn_norm, cfg.norm_eps)
    q, k, v = _qkv(cfg, lp, h)
    pos = positions.expand(B, S)
    q = cm.apply_rope(q.reshape(B, S, H, dh), pos, cfg.rope_theta)
    k = cm.apply_rope(k.reshape(B, S, KV, dh), pos, cfg.rope_theta)
    attn = cm.gqa_attention(q, k, v.reshape(B, S, KV, dh), causal=True,
                            q_chunk=cfg.q_chunk)
    x = x + attn.reshape(B, S, H * dh) @ lp.wo
    return _ffn(cfg, lp, x)


def _logits(params: Transformer, cfg: TransformerConfig, x: torch.Tensor):
    x = cm.rms_norm(x, params.final_norm, cfg.norm_eps)
    return (x @ params.lm_head).to(torch.float32)


@torch.no_grad()
def forward(params: Transformer, tokens: torch.Tensor,
            cfg: TransformerConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, V) fp32, aux loss (zero: dense model))."""
    S = tokens.shape[1]
    x = params.embed[tokens.long()].to(cfg.dtype)
    positions = torch.arange(S, device=x.device)
    for lp in params.layers:
        x = _layer(cfg, lp, x, positions)
    return _logits(params, cfg, x), torch.zeros((), device=x.device)


def prefill(params: Transformer, tokens: torch.Tensor,
            cfg: TransformerConfig) -> torch.Tensor:
    """Prefill serve step: full forward, returns last-position logits."""
    return forward(params, tokens, cfg)[0][:, -1]


# ---------------------------------------------------------------------------
# Serving: decode with a bf16 or an ASH-compressed KV cache
# ---------------------------------------------------------------------------


def init_cache(cfg: TransformerConfig, batch: int, max_len: int, *,
               device="cuda") -> dict:
    """Zeroed cache, the reference's layout: ASH-KV codes (L, B, S, KV, W)
    int32 (the reference's uint32 bit patterns) and scales (L, B, S, KV)
    in ``cfg.dtype``; or bf16 ``k``/``v`` (L, B, S, KV, dh)."""
    dev = resolve_device(device)
    L, KV, dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    if cfg.kv_quant_bits:
        W = Q.packed_width(cfg.code_dim, cfg.kv_quant_bits)
        return {
            "k_codes": torch.zeros(L, batch, max_len, KV, W,
                                   dtype=torch.int32, device=dev),
            "v_codes": torch.zeros(L, batch, max_len, KV, W,
                                   dtype=torch.int32, device=dev),
            "k_scale": torch.zeros(L, batch, max_len, KV, dtype=cfg.dtype,
                                   device=dev),
            "v_scale": torch.zeros(L, batch, max_len, KV, dtype=cfg.dtype,
                                   device=dev),
        }
    return {
        "k": torch.zeros(L, batch, max_len, KV, dh, dtype=cfg.dtype,
                         device=dev),
        "v": torch.zeros(L, batch, max_len, KV, dh, dtype=cfg.dtype,
                         device=dev),
    }


def _encode_kv(W: torch.Tensor, vec: torch.Tensor, b: int):
    """ASH-encode head vectors (mu = 0), one projection per KV head.

    W (..., KV, dc, dh) fp32; vec (..., KV, dh), the lead dims
    broadcasting -> (codes (..., KV, Wc) int32, scale (..., KV) fp32), as
    the reference's ``_encode_kv`` per head: u = (vec / ||vec||) W^T,
    V = quant_b(u) (exact for b <= 4), scale = ||vec|| / ||V||.
    """
    full_fp32()
    v32 = vec.to(torch.float32)
    norm = torch.linalg.norm(v32, dim=-1, keepdim=True)
    u = torch.einsum("...kd,...kcd->...kc",
                     v32 / torch.clamp(norm, min=1e-12), W)
    V = Q.quant(u, b, exact=(b <= 4))
    scale = norm[..., 0] / torch.clamp(Q.code_norms(V), min=1e-12)
    return Q.pack_codes(V, b), scale


def _ash_attention(params, cfg, cache, l, q, k, v, cache_len, valid,
                   use_kernel):
    """ASH-KV attention of one layer: encode and write the new K/V at
    ``cache_len``, then the reduced-space attention over the layer's
    packed cache, read in place, and the V decode once per head."""
    B = q.shape[0]
    H, KV, dh, dc = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.code_dim
    b = cfg.kv_quant_bits
    Wk_l, Wv_l = params.kv_Wk[l], params.kv_Wv[l]  # (KV, dc, dh)
    # K and V in one encode: half the small launches of a step
    (kc, vc), (ks, vs) = _encode_kv(torch.stack([Wk_l, Wv_l])[:, None],
                                    torch.stack([k, v]), b)
    k_codes, v_codes = cache["k_codes"][l], cache["v_codes"][l]
    k_scale, v_scale = cache["k_scale"][l], cache["v_scale"][l]
    k_codes[:, cache_len] = kc
    v_codes[:, cache_len] = vc
    k_scale[:, cache_len] = ks.to(cfg.dtype)
    v_scale[:, cache_len] = vs.to(cfg.dtype)
    # q projected into code space, rounded to the activation dtype as in
    # the reference; 1/sqrt(dh) folded into the fp32 query
    qr = q.reshape(B, KV, H // KV, dh).to(cfg.dtype)
    qp = torch.einsum("bkgd,kcd->bkgc", qr.to(torch.float32),
                      Wk_l.to(cfg.dtype).to(torch.float32)).to(cfg.dtype)
    q_k = qp.to(torch.float32) / math.sqrt(dh)
    d_pad = k_codes.shape[-1] * Q.codes_per_word(b)
    if d_pad > dc:
        q_k = torch.nn.functional.pad(q_k, (0, d_pad - dc))
    red = ops.ash_kv_attention(
        q_k, k_codes.permute(0, 2, 1, 3), k_scale.permute(0, 2, 1), None,
        v_codes.permute(0, 2, 1, 3), v_scale.permute(0, 2, 1), valid,
        b_k=b, b_v=b, use_kernel=use_kernel,
    )[..., :dc]  # (B, KV, G, dc)
    attn = torch.einsum("bkgc,kcd->bkgd", red, Wv_l)  # decode once
    return attn.reshape(B, H * dh).to(cfg.dtype)


def _bf16_attention(cfg, cache, l, q, k, v, cache_len, valid):
    """Exact-cache attention of one layer (the operands are widened to
    fp32 per layer, a transient of the layer's cache size)."""
    B = q.shape[0]
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kc, vc = cache["k"][l], cache["v"][l]
    kc[:, cache_len] = k.to(cfg.dtype)
    vc[:, cache_len] = v.to(cfg.dtype)
    qr = q.reshape(B, KV, H // KV, dh).to(cfg.dtype)
    logits = torch.einsum("bkgd,bskd->bkgs", qr.to(torch.float32),
                          kc.to(torch.float32)) / math.sqrt(dh)
    logits = torch.where(valid, logits, -1e30)
    p = torch.softmax(logits, dim=-1).to(cfg.dtype)
    attn = torch.einsum("bkgs,bskd->bkgd", p.to(torch.float32),
                        vc.to(torch.float32))
    return attn.reshape(B, H * dh).to(cfg.dtype)


@torch.no_grad()
def decode_step(params: Transformer, cache: dict, tokens: torch.Tensor,
                cache_len: int, cfg: TransformerConfig, *,
                use_kernel: bool = True):
    """One decode step: the next input token per sequence (B,) at
    position ``cache_len`` (the current prefix length).  Writes the new
    K/V into ``cache`` in place and returns (logits (B, V) fp32, cache).

    With an ASH-KV config the attention goes through
    ``ops.ash_kv_attention``: the CUDA kernel for a cache on the card,
    its plain version on the CPU or with ``use_kernel=False``.
    """
    B = tokens.shape[0]
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cache_len = int(cache_len)
    x = params.embed[tokens.long()].to(cfg.dtype)  # (B, D)
    dev = x.device
    max_len = (cache["k_codes"] if cfg.kv_quant_bits else cache["k"]).shape[2]
    valid = torch.arange(max_len, device=dev) <= cache_len  # + new slot
    pos = torch.full((B, 1), cache_len, dtype=torch.int32, device=dev)
    for l, lp in enumerate(params.layers):
        h = cm.rms_norm(x, lp.attn_norm, cfg.norm_eps)
        q, k, v = _qkv(cfg, lp, h)
        q = cm.apply_rope(q.reshape(B, 1, H, dh), pos, cfg.rope_theta)[:, 0]
        k = cm.apply_rope(k.reshape(B, 1, KV, dh), pos, cfg.rope_theta)[:, 0]
        v = v.reshape(B, KV, dh)
        if cfg.kv_quant_bits:
            attn = _ash_attention(params, cfg, cache, l, q, k, v, cache_len,
                                  valid, use_kernel)
        else:
            attn = _bf16_attention(cfg, cache, l, q, k, v, cache_len, valid)
        x = _ffn(cfg, lp, x + attn @ lp.wo)
    return _logits(params, cfg, x), cache
