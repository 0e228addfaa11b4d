"""The reference's parameter and cache trees <-> the port's.

The reference stacks layer weights along a leading L axis in a nested
dict of arrays; handed over as numpy (``np.asarray`` of each leaf), they
become a :class:`~repro_torch.models.transformer.Transformer` with
per-layer weights.  Cache trees keep their layout; packed uint32 words
travel as int32 bit patterns, as everywhere in the port, and bf16
arrays (numpy's ``bfloat16`` extension dtype) keep their bits.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.moe import MoEParams
from repro_torch.models.transformer import Layer, Transformer, TransformerConfig


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """A numpy array as a tensor with the same bits: uint32 -> int32,
    bfloat16 -> torch.bfloat16, other dtypes as they are."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32).copy()).to(device)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def params_from_numpy(tree: dict, cfg: TransformerConfig, *,
                      device="cuda") -> Transformer:
    """The reference's ``init_params`` tree (numpy leaves) as the port's
    parameters; layer weights in ``cfg.param_dtype``, the ASH-KV
    projections and an MoE ``router`` (L, D, E) in fp32, the experts'
    ``w_gate``/``w_up`` (L, E, D, F) and ``w_down`` (L, E, F, D) in
    ``cfg.param_dtype``."""
    dev = resolve_device(device)

    def t(a, dtype):
        return tensor_from_numpy(a, dev).to(dtype)

    pd = cfg.param_dtype
    lay = tree["layers"]
    names = (Layer.NAMES + (() if cfg.moe else Layer.FFN_NAMES)
             + (Layer.BIAS_NAMES if cfg.qkv_bias else ()))
    layers = [{n: t(lay[n][i], pd) for n in names}
              for i in range(cfg.n_layers)]
    if cfg.moe:
        moe = lay["moe"]
        for i, w in enumerate(layers):
            w["moe"] = MoEParams({
                n: t(moe[n][i], torch.float32 if n == "router" else pd)
                for n in MoEParams.NAMES})
    kvq = tree.get("kv_quant")
    return Transformer(
        cfg, t(tree["embed"], pd), layers, t(tree["final_norm"], pd),
        t(tree["lm_head"], pd),
        None if kvq is None else t(kvq["Wk"], torch.float32),
        None if kvq is None else t(kvq["Wv"], torch.float32),
    )


def cache_from_numpy(tree: dict, *, device="cuda") -> dict:
    """The reference's cache tree (numpy leaves) as the port's."""
    dev = resolve_device(device)
    return {k: tensor_from_numpy(v, dev) for k, v in tree.items()}


def cache_to_numpy(cache: dict) -> dict:
    """The port's cache as the reference's: codes as uint32 words, bf16
    scales and values as numpy ``bfloat16`` (ml_dtypes)."""
    import ml_dtypes

    out = {}
    for k, v in cache.items():
        v = v.detach().cpu()
        if v.dtype == torch.int32 and k.endswith("codes"):
            out[k] = v.numpy().view(np.uint32)
        elif v.dtype == torch.bfloat16:
            out[k] = v.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        else:
            out[k] = v.numpy()
    return out
