"""Decoder-only transformer (dense + MoE, GQA, RoPE, SwiGLU): serving and
training.

Counterpart of ``repro.models.transformer``: ``init_params``,
``forward``/``prefill``, ``loss_fn``, ``init_cache``
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
a Python loop.  With ``cfg.moe`` each layer's FFN is ``moe.moe_block``
over the flattened tokens (``forward`` returns the summed router aux
loss).  Serving (``forward``, ``prefill``, ``decode_step``) runs under
``torch.no_grad`` on frozen weights, and the cache is updated in place
(``decode_step`` returns the same dict), since a copy of a 31 GB cache
per step is not affordable.  Training (``loss_fn``) runs the same layer
body with autograd on; with ``cfg.remat`` each layer is recomputed in
the backward pass (``torch.utils.checkpoint``, the reference's
``jax.checkpoint`` with ``nothing_saveable``).  ``make_trainable``
turns a model's weights into training weights: each layer weight
becomes a view of one (L, ...) tensor per reference leaf, the tree the
optimizers and checkpoints work on.  Entry points run on
``device="cuda"`` unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.core import quantization as Q
from repro_torch.device import full_fp32, host_scalars, resolve_device
from repro_torch.kernels import ops
from repro_torch.models import common as cm
from repro_torch.models.moe import MoEConfig, MoEParams, init_moe, moe_block


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
    moe: Optional[MoEConfig] = None
    dtype: torch.dtype = torch.bfloat16  # activation dtype
    param_dtype: torch.dtype = torch.bfloat16
    remat: bool = True  # recompute each layer in the backward pass
    q_chunk: int = 2048  # query chunking for long prefill (0 = off)
    # ASH-KV cache compression (0 = off -> bf16 cache)
    kv_quant_bits: int = 0
    kv_quant_dim: int = 0  # 0 -> d_head (no dim reduction)

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def code_dim(self) -> int:
        return self.kv_quant_dim or self.head_dim

    def _count(self, experts: int) -> int:
        D, H, KV, dh = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim
        attn = D * (H * dh) + 2 * D * (KV * dh) + (H * dh) * D
        if self.moe:
            ffn = D * self.moe.n_experts + experts * 3 * D * self.moe.d_ff
        else:
            ffn = 3 * D * self.d_ff
        return self.n_layers * (attn + ffn + 2 * D) + 2 * self.vocab * D + D

    def param_count(self) -> int:
        return self._count(self.moe.n_experts if self.moe else 0)

    def active_param_count(self) -> int:
        """6*N_active*D convention for MoE rooflines: the router and the
        top-k experts of each layer."""
        return self._count(self.moe.top_k if self.moe else 0)


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Layer(nn.Module):
    """One decoder layer's weights (the reference's ``layers`` slice);
    an MoE layer holds ``moe`` (:class:`~repro_torch.models.moe.MoEParams`)
    in place of ``w_gate``/``w_up``/``w_down``."""

    NAMES = ("attn_norm", "ffn_norm", "wq", "wk", "wv", "wo")
    FFN_NAMES = ("w_gate", "w_up", "w_down")
    BIAS_NAMES = ("bq", "bk", "bv")

    def __init__(self, weights: dict):
        super().__init__()
        for name, t in weights.items():
            setattr(self, name, t if isinstance(t, MoEParams) else _frozen(t))


class Transformer(nn.Module):
    """Parameters of a decoder: ``embed``, ``layers``,
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
        self.tree = None  # the stacked training tree (make_trainable)

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
        }
        if cfg.moe:
            w["moe"] = init_moe(gen, cfg.moe, D, dtype=pd, device=dev)
        else:
            w.update(w_gate=dense((D, F)), w_up=dense((D, F)),
                     w_down=dense((F, D)))
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


def _ffn(cfg: TransformerConfig, lp: Layer, x: torch.Tensor,
         constrain=cm.keep):
    """x + FFN(norm(x)) and the layer's router aux loss (zero when
    dense); an MoE FFN routes the flattened (tokens, D) rows."""
    h = cm.rms_norm(x, lp.ffn_norm, cfg.norm_eps)
    if cfg.moe:
        out, aux = moe_block(lp.moe, h.reshape(-1, h.shape[-1]), cfg.moe,
                             constrain=constrain)
        return x + constrain(out.reshape(x.shape), "resid"), aux
    gate = constrain(h @ lp.w_gate, "ffn_hidden")
    up = constrain(h @ lp.w_up, "ffn_hidden")
    ffn = cm.swiglu(gate, up) @ lp.w_down
    return x + constrain(ffn, "resid"), torch.zeros((), device=x.device)


def _layer(cfg: TransformerConfig, lp: Layer, x: torch.Tensor,
           positions: torch.Tensor, constrain=cm.keep) -> torch.Tensor:
    B, S, _ = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = cm.rms_norm(x, lp.attn_norm, cfg.norm_eps)
    q, k, v = _qkv(cfg, lp, h)
    pos = positions.expand(B, S)
    q = cm.apply_rope(q.reshape(B, S, H, dh), pos, cfg.rope_theta)
    k = cm.apply_rope(k.reshape(B, S, KV, dh), pos, cfg.rope_theta)
    # the attention boundary pinned to its head-sharded layout
    q = constrain(q, "qkv")
    k = constrain(k, "kv")
    v = constrain(v.reshape(B, S, KV, dh), "v")
    attn = cm.gqa_attention(q, k, v, causal=True, q_chunk=cfg.q_chunk)
    attn = constrain(attn, "attn_out")
    x = x + constrain(attn.reshape(B, S, H * dh) @ lp.wo, "resid")
    return _ffn(cfg, lp, x, constrain)  # (x, aux)


def _logits(params: Transformer, cfg: TransformerConfig, x: torch.Tensor):
    x = cm.rms_norm(x, params.final_norm, cfg.norm_eps)
    return (x @ params.lm_head).to(torch.float32)


def _forward(params: Transformer, tokens: torch.Tensor,
             cfg: TransformerConfig,
             constrain=cm.keep) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward body shared by serving and training; with autograd on
    and ``cfg.remat`` each layer runs under a non-reentrant checkpoint."""
    S = tokens.shape[1]
    x = constrain(params.embed[tokens.long()].to(cfg.dtype), "resid")
    positions = torch.arange(S, device=x.device)
    aux = torch.zeros((), device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in params.layers:
        lp = constrain(lp, "layer_params")  # each layer gathers its own
        if remat:
            x, a = torch.utils.checkpoint.checkpoint(
                _layer, cfg, lp, x, positions, constrain,
                use_reentrant=False)
        else:
            x, a = _layer(cfg, lp, x, positions, constrain)
        aux = aux + a
    return constrain(_logits(params, cfg, x), "logits"), aux


@torch.no_grad()
def forward(params: Transformer, tokens: torch.Tensor,
            cfg: TransformerConfig,
            constrain=cm.keep) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, V) fp32, the router aux loss summed over
    layers (zero for a dense model)).  ``constrain(a, kind)`` is the
    sharding hook of ``launch.sharding.make_constrain`` (identity by
    default), called where the reference calls it."""
    return _forward(params, tokens, cfg, constrain)


def loss_fn(params: Transformer, batch: dict,
            cfg: TransformerConfig, constrain=cm.keep) -> torch.Tensor:
    """Next-token CE of ``logits[:, :-1]`` against ``labels[:, 1:]`` plus
    the summed router aux loss, with autograd on (the training loss)."""
    logits, aux = _forward(params, batch["tokens"], cfg, constrain)
    return cm.softmax_cross_entropy(
        logits[:, :-1], batch["labels"][:, 1:]) + aux


# ---------------------------------------------------------------------------
# Training weights: the reference's stacked tree over per-layer views
# ---------------------------------------------------------------------------


def leaf_paths(cfg: TransformerConfig) -> list[tuple[str, ...]]:
    """The reference's parameter leaves in its flatten order (dict keys
    sorted at every level), e.g. ``("layers", "moe", "router")``."""
    layers = dict.fromkeys(Layer.NAMES)
    if cfg.qkv_bias:
        layers.update(dict.fromkeys(Layer.BIAS_NAMES))
    if cfg.moe:
        layers["moe"] = dict.fromkeys(MoEParams.NAMES)
    else:
        layers.update(dict.fromkeys(Layer.FFN_NAMES))
    skeleton = {"embed": None, "final_norm": None, "layers": layers,
                "lm_head": None}

    def walk(node, prefix):
        for key in sorted(node):
            if node[key] is None:
                yield prefix + (key,)
            else:
                yield from walk(node[key], prefix + (key,))

    return list(walk(skeleton, ()))


def _owners(params: Transformer, path: tuple[str, ...]) -> list[nn.Module]:
    """The modules holding leaf ``path``: every layer (or its ``moe``)
    for a layer leaf, else the model itself."""
    if path[0] != "layers":
        return [params]
    return [lp.moe if len(path) == 3 else lp for lp in params.layers]


def train_leaves(params: Transformer) -> list[tuple[tuple[str, ...], list]]:
    """(path, tensors) per reference leaf, in its flatten order: the L
    per-layer weights of a layer leaf, the one tensor of the others."""
    return [(path, [getattr(o, path[-1]) for o in _owners(params, path)])
            for path in leaf_paths(params.cfg)]


def make_trainable(params: Transformer) -> dict:
    """Make ``params`` trainable and return its training tree.

    The tree is the reference's nested parameter dict: ``embed``,
    ``final_norm`` and ``lm_head`` are the model's own parameters, and
    each layer leaf is one (L, ...) tensor of which every layer's
    parameter is a view, so an in-place update of the tree updates the
    model.  Every parameter gets ``requires_grad``.  Kept in
    ``params.tree``; a second call returns it.
    """
    if params.tree is not None:
        return params.tree
    if params.kv_Wk is not None:
        raise ValueError("training takes a config without ASH-KV "
                         "projections (kv_quant_bits = 0)")
    tree: dict = {}
    for path, tensors in train_leaves(params):
        owners = _owners(params, path)
        if path[0] == "layers":
            leaf = torch.stack([t.detach() for t in tensors])
            for l, o in enumerate(owners):
                setattr(o, path[-1], nn.Parameter(leaf[l]))
        else:
            leaf = tensors[0].requires_grad_(True)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    params.tree = tree
    return tree


def stacked_tree(params: Transformer) -> dict:
    """The reference's parameter tree: the training tree when there is
    one (:func:`make_trainable`), else the same leaves stacked anew,
    with ``kv_quant`` (``Wk``, ``Wv``) for an ASH-KV config."""
    tree = params.tree
    if tree is None:
        tree = {}
        for path, tensors in train_leaves(params):
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = (torch.stack(tensors) if path[0] == "layers"
                              else tensors[0])
    if params.kv_Wk is not None:
        tree = dict(tree, kv_quant={"Wk": params.kv_Wk, "Wv": params.kv_Wv})
    return tree


def map_leaves(params: Transformer, fn) -> dict:
    """Replace every leaf of :func:`stacked_tree` by ``fn(path, leaf)``
    (same shape; e.g. a DTensor sharding it), each layer's weights
    becoming views of the new stacked leaves.  The new training tree
    (without ``kv_quant``) is kept in ``params.tree`` and returned."""
    new: dict = {}
    for path, leaf in _items(stacked_tree(params)):
        leaf = fn(path, leaf)
        grad = leaf.requires_grad
        if path[0] == "kv_quant":
            setattr(params, "kv_" + path[1], nn.Parameter(leaf, grad))
            continue
        if path[0] == "layers":
            for l, o in enumerate(_owners(params, path)):
                setattr(o, path[-1], nn.Parameter(leaf[l], grad))
        else:
            leaf = nn.Parameter(leaf, grad)
            setattr(params, path[-1], leaf)
        node = new
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    params.tree = new
    return new


def _items(tree, path=()):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _items(tree[key], path + (key,))
        else:
            yield path + (key,), tree[key]


def prefill(params: Transformer, tokens: torch.Tensor,
            cfg: TransformerConfig, constrain=cm.keep) -> torch.Tensor:
    """Prefill serve step: full forward, returns last-position logits."""
    return forward(params, tokens, cfg, constrain)[0][:, -1]


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
    packed cache, read in place, and the V decode once per head.  A cache
    of DTensors (a dry-run's) runs this on each card's sequences
    (``common.per_row``), the cache's sequence axis whole there."""
    layer = (cache["k_codes"][l], cache["v_codes"][l], cache["k_scale"][l],
             cache["v_scale"][l])
    return cm.per_row(
        functools.partial(_ash_layer, cfg, cache_len=cache_len, valid=valid,
                          use_kernel=use_kernel),
        q, k, v, *layer, shared=(params.kv_Wk[l], params.kv_Wv[l]))


def _ash_layer(cfg, q, k, v, k_codes, v_codes, k_scale, v_scale, Wk_l, Wv_l,
               *, cache_len, valid, use_kernel):
    B = q.shape[0]
    H, KV, dh, dc = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.code_dim
    b = cfg.kv_quant_bits
    # K and V in one encode: half the small launches of a step
    (kc, vc), (ks, vs) = _encode_kv(torch.stack([Wk_l, Wv_l])[:, None],
                                    torch.stack([k, v]), b)
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
    if cm.is_dtensor(kc):
        return _sharded_cache_attention(cfg, kc, vc, q, k, v, cache_len,
                                        valid)
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


def _sharded_cache_attention(cfg, kc, vc, q, k, v, cache_len, valid):
    """:func:`_bf16_attention` over a cache sharded as DTensors (the
    dry-run's, ``launch.analysis``): batch over the data axes and the
    sequence over others (flash-decoding).  Each card writes the new K/V
    into its slice if the position falls there, attends over its slice,
    and the slices combine across the sequence axes: the largest logit,
    then the rescaled sums of p and p·v (all-reduces of (B, H) and
    (B, H, dh) values)."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = kc.device_mesh
    seq_axes = [i for i, p in enumerate(kc.placements)
                if isinstance(p, Shard) and p.dim == 1]
    batch = [Shard(0) if isinstance(p, Shard) and p.dim == 0
             else Replicate() for p in kc.placements]
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    coord = mesh.get_coordinate() or [0] * mesh.ndim

    def local(q, k, v, kc, vc):
        B, S_l = q.shape[0], kc.shape[1]
        start = 0
        for i in seq_axes:  # this card's slice of the sequence
            start = start * mesh.size(i) + coord[i] * S_l
        if start <= cache_len < start + S_l:
            kc[:, cache_len - start] = k.to(cfg.dtype)
            vc[:, cache_len - start] = v.to(cfg.dtype)
        qr = q.reshape(B, KV, H // KV, dh).to(cfg.dtype)
        logits = torch.einsum("bkgd,bskd->bkgs", qr.to(torch.float32),
                              kc.to(torch.float32)) / math.sqrt(dh)
        logits = torch.where(valid[start:start + S_l], logits, -1e30)
        m = logits.amax(dim=-1, keepdim=True)
        for i in seq_axes:
            m = funcol.all_reduce(m, "max", (mesh, i))
        e = torch.exp(logits - m)
        den = e.sum(dim=-1, keepdim=True)
        out = torch.einsum("bkgs,bskd->bkgd", e, vc.to(torch.float32))
        for i in seq_axes:
            den = funcol.all_reduce(den, "sum", (mesh, i))
            out = funcol.all_reduce(out, "sum", (mesh, i))
        return (out / den).reshape(B, H * dh).to(cfg.dtype)

    return local_map(local, out_placements=batch,
                     in_placements=(batch,) * 3 + (kc.placements,) * 2,
                     device_mesh=mesh, redistribute_inputs=True)(
        q, k, v, kc, vc)


@torch.no_grad()
def decode_step(params: Transformer, cache: dict, tokens: torch.Tensor,
                cache_len: int, cfg: TransformerConfig,
                constrain=cm.keep, *, use_kernel: bool = True):
    """One decode step: the next input token per sequence (B,) at
    position ``cache_len`` (the current prefix length).  Writes the new
    K/V into ``cache`` in place and returns (logits (B, V) fp32, cache).

    With an ASH-KV config the attention goes through
    ``ops.ash_kv_attention``: the CUDA kernel for a cache on the card,
    its plain version on the CPU or with ``use_kernel=False``.  As in the
    reference, ``constrain`` reaches only an MoE layer's buffers.
    """
    B = tokens.shape[0]
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    with host_scalars():
        cache_len = int(cache_len)
    moe_constrain = cm.only("moe_buffer", constrain)
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
        x = _ffn(cfg, lp, x + attn @ lp.wo, moe_constrain)[0]
    return _logits(params, cfg, x), cache
