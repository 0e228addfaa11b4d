"""The reference's parameter and cache trees <-> the port's.

The reference stacks layer weights along a leading L axis in a nested
dict of arrays; handed over as numpy (``np.asarray`` of each leaf), they
become a :class:`~repro_torch.models.transformer.Transformer` with
per-layer weights, and ``params_to_numpy`` gives the port's parameters
back as that stacked tree.  Cache trees keep their layout; packed uint32
words travel as int32 bit patterns, as everywhere in the port, and bf16
arrays (numpy's ``bfloat16`` extension dtype) keep their bits.
The other families (``sasrec``, ``recsys``, ``nequip``) keep the
reference's nested dict/list tree as their parameters, so theirs cross
leaf by leaf, bit for bit.  Training states convert in
``repro_torch.train.checkpoint``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.moe import MoEParams
from repro_torch.models.transformer import (
    Layer, Transformer, TransformerConfig, train_leaves,
)


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


def params_from_numpy(tree: dict, cfg, *, device="cuda"):
    """The reference's ``init_params`` tree (numpy leaves) as the port's
    parameters.  For a ``TransformerConfig``, a ``Transformer``: layer
    weights in ``cfg.param_dtype``, the ASH-KV projections and an MoE
    ``router`` (L, D, E) in fp32, the experts' ``w_gate``/``w_up``
    (L, E, D, F) and ``w_down`` (L, E, F, D) in ``cfg.param_dtype``.
    For the other families' configs, the same tree of tensors with the
    leaves' bits."""
    dev = resolve_device(device)
    if not isinstance(cfg, TransformerConfig):
        return tree_from_numpy(tree, dev)

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


def _numpy(t: torch.Tensor):
    """A copy of a tensor's bits as numpy: bf16 as ``ml_dtypes.bfloat16``."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_to_numpy(params) -> dict:
    """The port's parameters as the reference's tree: nested dicts (and
    lists), a transformer's layer weights stacked along L (a trainable
    model's own tree; otherwise stacked here), numpy leaves with the
    tensors' dtypes."""
    if not isinstance(params, Transformer):
        return tree_to_numpy(params)
    if params.tree is not None:
        return tree_to_numpy(params.tree)
    out: dict = {}
    for path, tensors in train_leaves(params):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = (_numpy(tensors[0]) if path[0] != "layers"
                          else np.stack([_numpy(t) for t in tensors]))
    return out


def tree_to_numpy(tree):
    """A nested dict/list of tensors as the same tree of numpy copies."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to_numpy(v) for v in tree]
    return _numpy(tree)


def tree_from_numpy(tree, device):
    """A nested dict/list of numpy arrays as the same tree of tensors on
    ``device``."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_from_numpy(v, device) for v in tree]
    return tensor_from_numpy(tree, device)


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
