"""Sharding policy: DP / FSDP / TP / EP / SP rules for every family
(counterpart of ``repro.launch.sharding``, the same rules and results).

Everything is divisibility-checked: an axis is only assigned to a dim it
divides, otherwise the next candidate (or replication) is used, so the
same rules serve 40-expert granite and 384-expert kimi on the single-pod
and the 2-pod mesh alike.

A spec is :class:`P`, an immutable tuple with one entry per tensor dim:
None, an axis name, or a tuple of axis names.  :func:`placements` turns
it into DTensor placements (for each mesh axis ``Shard(dim)`` if the
spec names that axis at ``dim``, else ``Replicate()``), and
:func:`distribute` shards a tensor by it.  The rules read any mesh with
``.shape`` (axis name -> size) and ``.axis_names``
(``launch.mesh.Mesh``, or a duck-typed stand-in); only
:func:`distribute` and :func:`make_constrain`'s redistributions need the
mesh's ``DeviceMesh``.  Trees are the port's nested dicts and lists,
their leaves named by '/'-joined paths as the reference names them
(``layers/wq``, ``mlp/0/w``).
"""
from __future__ import annotations

import dataclasses
import re
import types
from typing import Callable

import torch

from repro_torch.models.common import is_dtensor


class P(tuple):
    """A partition spec, ``P(None, "model")``; ``P()`` replicates.  As
    ``jax.sharding.PartitionSpec``, a one-axis tuple entry is that axis
    and an empty one None."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            (e[0] if len(e) == 1 else e or None)
            if isinstance(e, tuple) else e for e in entries))

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """Knobs the perf hillclimb flips."""

    tp_axis: str = "model"
    seq_parallel: bool = False  # shard activations' seq dim over tp
    fsdp: bool = True  # shard big params over the data axis too
    shard_moe_buffer: bool = True
    # Attention-boundary and FFN-hidden layout pins: pinning swaps weight
    # gathers for activation gathers, a win for large models and a loss
    # for small ones whose FFN weights are cheaper to replicate than
    # their activations are to gather.  Per-arch override via
    # Arch.policy_overrides.
    pin_attn_boundary: bool = True
    pin_ffn_hidden: bool = True

    def dp(self, mesh) -> tuple:
        return tuple(a for a in mesh.axis_names if a != self.tp_axis)


def _div(n: int, mesh, axes) -> bool:
    if axes is None:
        return True
    if isinstance(axes, str):
        axes = (axes,)
    total = 1
    for a in axes:
        if a not in mesh.shape:  # e.g. no "pod" axis on single-pod mesh
            return False
        total *= mesh.shape[a]
    return n % total == 0


def pick(mesh, dim: int, *candidates):
    """First candidate axis (or axis tuple) that divides dim; else None."""
    for c in candidates:
        if c is None:
            continue
        if _div(dim, mesh, c):
            return c
    return None


def fit_spec(spec: P, ndim: int) -> P:
    """Adapt a spec to a lower-rank tensor by dropping trailing Nones
    (adafactor vr/vc reuse the parameter rules on reduced shapes)."""
    entries = list(spec)
    while len(entries) > ndim and entries[-1] is None:
        entries.pop()
    if len(entries) > ndim:
        return P()
    return P(*entries)


def path_str(path) -> str:
    return "/".join(str(p) for p in path)


def tree_items(tree, path=()):
    """(path, leaf) of a nested dict/list, dict keys sorted (the
    reference's flatten order); a spec :class:`P` is a leaf."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in tree_items(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return [kv for i, x in enumerate(tree)
                for kv in tree_items(x, path + (i,))]
    return [(path, tree)]


def map_with_path(fn: Callable, tree, path=()):
    """``fn(path, leaf)`` over a nested dict/list, same structure."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in
                tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, path + (i,)) for i, v in
                enumerate(tree)]
    return fn(path, tree)


def specs_by_rules(tree, rules: Callable[[str, tuple], P]):
    """Map a (path, shape) -> spec rule over a tree of tensors."""
    return map_with_path(
        lambda path, leaf: rules(path_str(path), tuple(leaf.shape)), tree)


# ---------------------------------------------------------------------------
# Transformer parameter rules
# ---------------------------------------------------------------------------


def transformer_param_rules(mesh, pol: ShardingPolicy):
    tp = pol.tp_axis

    def rules(path: str, shape: tuple) -> P:
        nd = len(shape)

        def ax(i, *cands):
            # bounds-safe: reduced shapes (adafactor row/col stats) use
            # the same rules with trailing dims dropped
            if i >= nd or i < -nd:
                return None
            return pick(mesh, shape[i], *cands)

        if path.endswith("embed"):  # (V, D)
            return P(ax(0, tp), ax(1, "data", "pod"))
        if path.endswith("lm_head"):  # (D, V)
            return P(ax(0, "data", "pod"), ax(1, tp))
        if re.search(r"layers/(wq|wk|wv)$", path):  # (L, D, X)
            return P(None, ax(1, "data", "pod") if pol.fsdp else None,
                     ax(2, tp))
        if path.endswith("layers/wo"):  # (L, X, D)
            return P(None, ax(1, tp),
                     ax(2, "data", "pod") if pol.fsdp else None)
        if re.search(r"layers/(w_gate|w_up)$", path):  # (L, D, F)
            return P(None, ax(1, "data", "pod") if pol.fsdp else None,
                     ax(2, tp))
        if path.endswith("layers/w_down"):  # (L, F, D)
            return P(None, ax(1, tp),
                     ax(2, "data", "pod") if pol.fsdp else None)
        if path.endswith("moe/router"):  # (L, D, E)
            return P(None, ax(1, "data", "pod") if pol.fsdp else None,
                     None)
        if re.search(r"moe/(w_gate|w_up)$", path):  # (L, E, D, Fe)
            e_ax = ax(1, tp, "pod")
            d_ax = ax(2, "pod" if e_ax != "pod" else None)
            f_ax = ax(3, "data") if pol.fsdp else None
            return P(None, e_ax, d_ax, f_ax)
        if path.endswith("moe/w_down"):  # (L, E, Fe, D)
            e_ax = ax(1, tp, "pod")
            f_ax = ax(2, "data") if pol.fsdp else None
            d_ax = ax(3, "pod" if e_ax != "pod" else None)
            return P(None, e_ax, f_ax, d_ax)
        # norms, biases, kv_quant projections: replicated
        return P()

    return rules


# ---------------------------------------------------------------------------
# RecSys / SASRec / NequIP parameter rules
# ---------------------------------------------------------------------------


def recsys_param_rules(mesh, pol: ShardingPolicy):
    tp = pol.tp_axis

    def rules(path: str, shape: tuple) -> P:
        def ax(i, *cands):
            return pick(mesh, shape[i], *cands)

        if path.endswith("tables") or path.endswith("linear_sparse"):
            # (F*V, e): row-shard the huge table over EVERYTHING possible
            return P(ax(0, ("pod", "data", "model"), ("data", "model"),
                        ("data",)), None)
        if path.endswith("item_emb"):  # (n_items, e)
            return P(ax(0, ("pod", "data", "model"), ("data", "model"),
                        ("data",)), None)
        if "mlp" in path and len(shape) == 2:
            return P(None, ax(1, tp))
        if "cross" in path and len(shape) == 3:
            return P(None, None, None)  # tiny (429 x 429)
        if len(shape) >= 2:
            return P(*([None] * (len(shape) - 1) + [ax(-1, tp)]))
        return P()

    return rules


def nequip_param_rules(mesh, pol: ShardingPolicy):
    def rules(path: str, shape: tuple) -> P:
        return P()  # ~100k params: replicate

    return rules


# ---------------------------------------------------------------------------
# Batch / activation specs
# ---------------------------------------------------------------------------


def batch_rules_leading_dp(mesh, pol: ShardingPolicy):
    """Shard dim 0 over the DP axes (batch/nodes/edges); rest replicated."""
    dpa = pol.dp(mesh)

    def rules(path: str, shape: tuple) -> P:
        if not shape:
            return P()
        a0 = pick(mesh, shape[0], dpa, dpa[:1], dpa[-1:])
        return P(*([a0] + [None] * (len(shape) - 1)))

    return rules


def kv_cache_rules(mesh, pol: ShardingPolicy):
    """Cache (L, B, S, KV, dh) or codes (L, B, S, KV, W):
    B over DP, S over tp (flash-decoding style length splits)."""
    dpa = pol.dp(mesh)
    tp = pol.tp_axis

    def rules(path: str, shape: tuple) -> P:
        if len(shape) < 4:
            return P()
        b_ax = pick(mesh, shape[1], dpa, dpa[:1], dpa[-1:])
        s_ax = pick(mesh, shape[2], tp)
        return P(*([None, b_ax, s_ax] + [None] * (len(shape) - 3)))

    return rules


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------


def placements(spec: P, mesh) -> list:
    """DTensor placements of ``spec`` over ``mesh``'s axes: ``Shard(d)``
    on each axis of more than one card the spec names at dim d (an axis
    tuple shards its dim over those axes in mesh order), ``Replicate()``
    elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    at = {}
    for d, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else (entry or ())):
            at[a] = d
    # an axis of one card replicates (the same bytes; DTensor cannot
    # reshape a dim it counts as sharded, even over one card)
    return [Shard(at[a]) if a in at and mesh.shape[a] > 1 else Replicate()
            for a in mesh.axis_names]


def distribute(t: torch.Tensor, mesh, spec: P):
    """``t`` as a DTensor sharded by ``spec`` over ``mesh`` (no data
    moves: each rank keeps its own chunk of ``t``)."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh.device_mesh, placements(spec, mesh),
                             src_data_rank=None)


def with_shardings(tree, specs, mesh):
    """Distribute a tree of (fake) tensors by a matching tree of specs."""
    flat = dict(tree_items(specs))
    return map_with_path(lambda path, t: distribute(t, mesh, flat[path]),
                         tree)


def local_nbytes(t: torch.Tensor) -> int:
    """Bytes of one card's shard of ``t`` (a DTensor) or of ``t``."""
    local = getattr(t, "_local_tensor", t)
    return local.numel() * local.element_size()


# ---------------------------------------------------------------------------
# Activation constraint hook (passed into model forwards)
# ---------------------------------------------------------------------------


def activation_spec(mesh, pol: ShardingPolicy, kind: str, shape: tuple):
    """The reference's ``with_sharding_constraint`` spec for an
    activation of ``kind`` and ``shape``; None leaves it as it is."""
    dpa = pol.dp(mesh)
    tp = pol.tp_axis

    def dp0():
        return pick(mesh, shape[0], dpa, dpa[:1], dpa[-1:])

    if kind == "resid":  # (B, S, D)
        sp = pick(mesh, shape[1], tp) if pol.seq_parallel else None
        return P(dp0(), sp, None)
    if kind in ("qkv", "kv"):  # (B, S, H, dh)
        return P(dp0(), None, pick(mesh, shape[2], tp), None)
    if kind == "ffn_hidden":  # (B, S, F): Megatron column-parallel
        if not pol.pin_ffn_hidden:
            return None
        return P(dp0(), None, pick(mesh, shape[2], tp))
    if kind in ("attn_out", "v"):  # (B, S, H|KV, dh)
        if not pol.pin_attn_boundary:
            return None
        return P(dp0(), None, pick(mesh, shape[2], tp), None)
    if kind == "logits":  # (B, S, V)
        return P(dp0(), None, pick(mesh, shape[2], tp))
    if kind == "moe_buffer" and pol.shard_moe_buffer:
        # (n_groups, E, C, D); the expert axis must not reuse an axis
        # already carrying the group dim
        g_ax = dp0()
        used = (g_ax,) if isinstance(g_ax, str) else (g_ax or ())
        e_cands = [c for c in (tp, "pod") if c not in used]
        return P(g_ax, pick(mesh, shape[1], *e_cands) if e_cands else None,
                 None, None)
    if kind == "node_feats":  # (N, C, m)
        return P(dp0(), None, None)
    if kind == "edge_feats":  # (E, ...) edge-wise tensors
        return P(*([dp0()] + [None] * (len(shape) - 1)))
    if kind == "edge_chunked":  # (chunks, E/chunks, ...)
        return P(*([None, pick(mesh, shape[1], dpa, dpa[:1], dpa[-1:])]
                   + [None] * (len(shape) - 2)))
    return None


def redistribute(a, mesh, spec: P):
    """DTensor ``a`` resharded by ``spec`` (unchanged when the spec has
    more entries than ``a`` has dims)."""
    if len(spec) > a.ndim:
        return a
    return a.redistribute(mesh.device_mesh, placements(spec, mesh))


def make_constrain(mesh, pol: ShardingPolicy, param_rules=None):
    """``constrain(a, kind)``: a DTensor activation redistributed to the
    reference's spec for ``kind`` (:func:`activation_spec`); a plain
    tensor unchanged.  ``layer_params`` takes one layer's weights (an
    ``nn.Module``, its sub-modules nested) and returns a namespace of
    the same names, each weight redistributed to its parameter spec
    without the layer axis, so each layer gathers its own FSDP shards."""

    def layer(module, prefix):
        ns = types.SimpleNamespace()
        for name, sub in module.named_children():
            setattr(ns, name, layer(sub, prefix + name + "/"))
        for name, w in module.named_parameters(recurse=False):
            if is_dtensor(w):
                spec = param_rules(prefix + name, (None,) + tuple(w.shape))
                w = redistribute(w, mesh, P(*spec[1:w.ndim + 1]))
            setattr(ns, name, w)
        return ns

    def constrain(a, kind: str):
        if kind == "layer_params":
            if param_rules is None or not any(
                    is_dtensor(w) for w in a.parameters()):
                return a
            return layer(a, "layers/")
        if not is_dtensor(a):
            return a
        try:
            spec = activation_spec(mesh, pol, kind, tuple(a.shape))
        except IndexError:
            return a
        return a if spec is None else redistribute(a, mesh, spec)

    return constrain
