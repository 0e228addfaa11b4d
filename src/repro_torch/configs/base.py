"""Cells and cell programs (counterpart of ``repro.configs.base``).

Every architecture of ``configs.registry`` has shape cells: a
:class:`Cell` names a workload (train, prefill, decode, serve,
retrieval) and its shapes, with the reference's names, kinds, shapes
and ``skip`` reasons word for word.  ``Arch.make_cell_program`` gives,
for a mesh and a sharding policy, ``(fn, args)``: ``fn`` the step the
cell runs and ``args`` fake tensors (no storage) distributed as DTensors
by the sharding rules of ``launch.sharding``.  The dry-run
(``launch.dryrun``) traces ``fn(*args)`` inside ``fn.fake_mode``; on
real tensors ``fn`` computes what the reference's program computes.

The train state's leaves are named as the reference's ``TrainState``
pytree names them (``params/layers/wq``, ``opt_state/mu/embed``,
``step``, ``rng``): :func:`state_items` lists them and
:func:`state_specs` gives each its spec, optimizer moments inheriting
their parameter's.  The counters ``step`` and ``rng`` stay real CPU
tensors (``device.host_scalars``), as they are in training.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import quantization as Q
from repro_torch.launch import sharding as SH
from repro_torch.launch.sharding import P


def pad_to(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    kind: str  # train | prefill | decode | serve | retrieval
    shape: dict
    skip: Optional[str] = None  # reason this cell is officially skipped


# ---------------------------------------------------------------------------
# Abstract parameters and train states
# ---------------------------------------------------------------------------


def fake_mode():
    """A fake-tensor mode for abstract parameters and cell programs (real
    CPU tensors, the train state's counters, may enter it)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode(allow_non_fake_inputs=True)


def init_params(arch, cfg=None):
    """The arch's parameters drawn on the CPU: fake tensors inside a
    fake mode (``Arch.abstract_params``)."""
    return arch.model.init_params(torch.Generator(), cfg or arch.cfg,
                                  device="cpu")


def param_tree(params) -> dict:
    """The reference's parameter tree of ``params``: a transformer's
    stacked training tree (``transformer.stacked_tree``), else the
    nested dict/list itself."""
    from repro_torch.models import transformer as TT

    if isinstance(params, TT.Transformer):
        return TT.stacked_tree(params)
    return params


def state_items(state) -> list:
    """(path, leaf) of a ``TrainState`` named as the reference's pytree:
    ``params/...``, ``opt_state/<field>/...`` (``opt_state/step``),
    ``ef_state/residual/...``, ``step``, ``rng``."""
    items = [(("params",) + p, t)
             for p, t in SH.tree_items(param_tree(state.params))]
    for name, value in state.opt_state._asdict().items():
        items += [(("opt_state", name) + p, t)
                  for p, t in SH.tree_items(value)]
    if state.ef_state is not None:
        items += [(("ef_state", "residual") + p, t)
                  for p, t in SH.tree_items(state.ef_state.residual)]
    items += [(("step",), state.step), (("rng",), state.rng)]
    return [(SH.path_str(p), t) for p, t in items]


def _strip_state_prefix(path: str):
    """Map TrainState leaf paths onto parameter paths so optimizer
    moments inherit the parameter sharding."""
    for prefix in ("params/", "opt_state/mu/", "opt_state/nu/",
                   "opt_state/vr/", "opt_state/vc/",
                   "opt_state/v/", "ef_state/residual/"):
        if path.startswith(prefix):
            return path[len(prefix):]
    return None


def state_spec(prules, path: str, shape: tuple) -> P:
    """The reference's spec of a train-state leaf."""
    p = _strip_state_prefix(path)
    if p is None or not shape:
        return P()
    try:
        return SH.fit_spec(prules(p, tuple(shape)), len(shape))
    except Exception:  # rule indexed a dim the reduced shape lacks
        return P()


def state_specs(arch, mesh, pol) -> dict:
    """{path: spec} of every leaf of the arch's train state."""
    prules = arch.param_rules(mesh, pol)
    with fake_mode():
        state = arch.abstract_state()
    return {path: state_spec(prules, path, tuple(t.shape))
            for path, t in state_items(state)}


def shard_params(arch, params, mesh, spec_of, trainable: bool):
    """``params`` with every leaf distributed by ``spec_of(path, leaf)``
    (``path`` the reference's leaf path); a transformer's layer weights
    become views of their stacked DTensor leaves."""
    from repro_torch.models import transformer as TT

    def dist(path, t):
        d = SH.distribute(t.detach(), mesh, spec_of(SH.path_str(path), t))
        return d.requires_grad_(trainable)

    if isinstance(params, TT.Transformer):
        TT.map_leaves(params, dist)
        return params
    return SH.map_with_path(dist, params)


def _sharded_state(arch, mesh, pol):
    """The arch's train state at full size, its leaves fake DTensors
    sharded by :func:`state_spec`; the counters stay real."""
    from repro_torch.train import trainer as TR

    prules = arch.param_rules(mesh, pol)

    def spec_of(path, t):
        return state_spec(prules, path, tuple(t.shape))

    state = arch.abstract_state()
    params = shard_params(arch, state.params, mesh,
                          lambda p, t: spec_of("params/" + p, t), True)

    def shard(prefix, tree):
        return SH.map_with_path(lambda path, t: SH.distribute(
            t, mesh, spec_of(prefix + SH.path_str(path), t)), tree)

    opt = type(state.opt_state)(**{
        name: value if isinstance(value, torch.Tensor)
        else shard(f"opt_state/{name}/", value)
        for name, value in state.opt_state._asdict().items()})
    ef = state.ef_state
    if ef is not None:
        ef = type(ef)(residual=shard("ef_state/residual/", ef.residual))
    return TR.TrainState(params=params, opt_state=opt, ef_state=ef,
                         step=state.step, rng=state.rng)


def _sharded_params(arch, mesh, pol):
    prules = arch.param_rules(mesh, pol)
    return shard_params(arch, arch.abstract_params(), mesh,
                        lambda p, t: prules(p, tuple(t.shape)), False)


def _batch_sds(shapes: dict, mesh, pol, rules=None) -> dict:
    """Fake batch tensors {name: ((shape), dtype)} sharded by ``rules``
    (default: the leading dim over the DP axes)."""
    if rules is None:
        rules = SH.batch_rules_leading_dp(mesh, pol)
    return {k: SH.distribute(torch.zeros(shape, dtype=dtype), mesh,
                             rules(k, tuple(shape)))
            for k, (shape, dtype) in shapes.items()}


def _with_cfg(arch, cfg):
    return dataclasses.replace(arch, cfg=cfg)


def make_constrain_grads(arch, mesh, pol):
    """Pin gradient trees to the parameter sharding."""
    prules = arch.param_rules(mesh, pol)

    def constrain_grads(grads):
        def f(path, leaf):
            if not SH.is_dtensor(leaf):
                return leaf
            try:
                spec = SH.fit_spec(prules(SH.path_str(path),
                                          tuple(leaf.shape)), leaf.ndim)
            except Exception:
                return leaf
            return SH.redistribute(leaf, mesh, spec)

        return SH.map_with_path(f, grads)

    return constrain_grads


def _train_step(arch, mesh, pol, constrain, **static):
    from repro_torch.train import trainer as TR

    return TR.make_train_step(
        arch.loss_fn(constrain, **static), arch.train_cfg,
        constrain_grads=make_constrain_grads(arch, mesh, pol))


# ---------------------------------------------------------------------------
# Transformer cells
# ---------------------------------------------------------------------------


def _tfm_train(arch, cell: Cell, mesh, pol, constrain):
    B, S = cell.shape["global_batch"], cell.shape["seq_len"]
    state = _sharded_state(arch, mesh, pol)
    batch = _batch_sds({"tokens": ((B, S), torch.int32),
                        "labels": ((B, S), torch.int32)}, mesh, pol)
    return _train_step(arch, mesh, pol, constrain), (state, batch)


def _tfm_prefill(arch, cell: Cell, mesh, pol, constrain):
    from repro_torch.models import transformer as TT

    B, S = cell.shape["global_batch"], cell.shape["seq_len"]
    params = _sharded_params(arch, mesh, pol)
    tokens = _batch_sds({"tokens": ((B, S), torch.int32)}, mesh,
                        pol)["tokens"]

    def serve_step(params, tokens):
        return TT.prefill(params, tokens, arch.cfg, constrain)

    return serve_step, (params, tokens)


def _tfm_decode(arch, cell: Cell, mesh, pol, constrain):
    from repro_torch.models import transformer as TT

    B, S = cell.shape["global_batch"], cell.shape["seq_len"]
    if cell.shape.get("kv_quant_bits"):
        # ASH-compressed KV cache variant (the paper's technique applied
        # to serving)
        arch = _with_cfg(arch, dataclasses.replace(
            arch.cfg, kv_quant_bits=cell.shape["kv_quant_bits"],
            kv_quant_dim=cell.shape.get("kv_quant_dim", 0)))
    params = _sharded_params(arch, mesh, pol)
    cache = TT.init_cache(arch.cfg, B, S, device="cpu")
    cache = SH.with_shardings(cache, SH.specs_by_rules(
        cache, SH.kv_cache_rules(mesh, pol)), mesh)
    tokens = _batch_sds({"tokens": ((B,), torch.int32)}, mesh,
                        pol)["tokens"]
    from repro_torch.device import host_scalars
    with host_scalars():
        pos = torch.zeros((), dtype=torch.int32)

    def serve_step(params, cache, tokens, cache_len):
        return TT.decode_step(params, cache, tokens, cache_len, arch.cfg,
                              constrain)

    return serve_step, (params, cache, tokens, pos)


# ---------------------------------------------------------------------------
# NequIP cells (all train steps over graph batches)
# ---------------------------------------------------------------------------


def _nequip_train(arch, cell: Cell, mesh, pol, constrain):
    s = cell.shape
    overrides = {}
    if s.get("d_feat"):
        # feature-graph cells: the embedding consumes d_feat-dim inputs
        overrides["d_feat_in"] = s["d_feat"]
    if s.get("edge_chunks"):
        overrides["edge_chunks"] = s["edge_chunks"]
    if overrides:
        arch = _with_cfg(arch, dataclasses.replace(arch.cfg, **overrides))
    N = pad_to(s["n_nodes"], 512)
    E = pad_to(s["n_edges"], 512)
    n_graphs = s.get("n_graphs", 1)
    shapes = {
        "positions": ((N, 3), torch.float32),
        "edge_src": ((E,), torch.int32),
        "edge_dst": ((E,), torch.int32),
        "edge_mask": ((E,), torch.bool),
        "node_mask": ((N,), torch.bool),
    }
    if s.get("d_feat"):
        # feature-graph cells train node-property regression (1st-order)
        shapes["node_feats"] = ((N, s["d_feat"]), torch.float32)
        shapes["node_targets"] = ((N,), torch.float32)
    else:
        # molecular cells train energy + forces (2nd-order AD)
        shapes["species"] = ((N,), torch.int32)
        shapes["energy"] = ((n_graphs,), torch.float32)
        shapes["forces"] = ((N, 3), torch.float32)
    if n_graphs > 1:
        shapes["graph_ids"] = ((N,), torch.int32)
    state = _sharded_state(arch, mesh, pol)
    batch = _batch_sds(shapes, mesh, pol)
    # n_graphs is static (the segment count): closed over
    static = {"n_graphs": n_graphs} if n_graphs > 1 else {}
    return _train_step(arch, mesh, pol, constrain, **static), (state, batch)


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------


def _recsys_batch_shapes(arch, B: int) -> dict:
    cfg = arch.cfg
    shapes = {
        "sparse": ((B, cfg.n_sparse), torch.int32),
        "labels": ((B,), torch.float32),
    }
    if cfg.n_dense:
        shapes["dense"] = ((B, cfg.n_dense), torch.float32)
    return shapes


def _recsys_train(arch, cell: Cell, mesh, pol, constrain):
    state = _sharded_state(arch, mesh, pol)
    batch = _batch_sds(_recsys_batch_shapes(arch, cell.shape["batch"]),
                       mesh, pol)
    return _train_step(arch, mesh, pol, constrain), (state, batch)


def _recsys_serve(arch, cell: Cell, mesh, pol, constrain):
    from repro_torch.models import recsys as R

    params = _sharded_params(arch, mesh, pol)
    shapes = _recsys_batch_shapes(arch, cell.shape["batch"])
    shapes.pop("labels")
    batch = _batch_sds(shapes, mesh, pol)

    def serve_step(params, batch):
        return R.forward(params, batch, arch.cfg, constrain)

    return serve_step, (params, batch)


def _recsys_retrieval(arch, cell: Cell, mesh, pol, constrain):
    from repro_torch.models import recsys as R

    params = _sharded_params(arch, mesh, pol)
    user_shapes = _recsys_batch_shapes(arch, 1)
    user_shapes.pop("labels")
    user = _batch_sds(user_shapes, mesh, pol)
    cand = _batch_sds({"cand_ids": ((cell.shape["n_candidates"],),
                                    torch.int32)}, mesh, pol)["cand_ids"]

    def serve_step(params, user, cand_ids):
        return R.retrieval_score(params, user, cand_ids, arch.cfg)

    return serve_step, (params, user, cand)


# ---------------------------------------------------------------------------
# SASRec cells
# ---------------------------------------------------------------------------


def _sasrec_batch_shapes(arch, B: int) -> dict:
    cfg = arch.cfg
    return {
        "seq": ((B, cfg.seq_len), torch.int32),
        "labels": ((B, cfg.seq_len), torch.int32),
        "negatives": ((cfg.n_neg,), torch.int32),
    }


def _sasrec_train(arch, cell: Cell, mesh, pol, constrain):
    state = _sharded_state(arch, mesh, pol)
    batch = _batch_sds(_sasrec_batch_shapes(arch, cell.shape["batch"]),
                       mesh, pol)
    return _train_step(arch, mesh, pol, constrain), (state, batch)


def _seq(arch, B, mesh, pol):
    return _batch_sds({"seq": ((B, arch.cfg.seq_len), torch.int32)}, mesh,
                      pol)["seq"]


def _sasrec_serve(arch, cell: Cell, mesh, pol, constrain):
    from repro_torch.models import sasrec as SR

    params = _sharded_params(arch, mesh, pol)
    seq = _seq(arch, cell.shape["batch"], mesh, pol)

    def serve_step(params, seq):
        # online inference: user state + full-catalog MIPS scores
        u = SR.user_state(params, seq, arch.cfg)
        return u @ params["item_emb"].to(torch.float32).T

    return serve_step, (params, seq)


def ash_catalog_scores(u, ash: dict, d_code: int, b: int):
    """The reference's ASH candidate scores of ``retrieval_cand_ash``, in
    plain torch: unpack the codes, a bf16 product summed in fp32, bf16
    scale and offset headers and the bias u·mu.  (Not kernel 1's
    function, which takes fp16 headers and the landmark form.)"""
    q_proj = (u @ ash["W"].T).to(torch.bfloat16)  # (B, d)
    V = Q.unpack_codes(ash["codes"], d_code, b).to(torch.bfloat16)
    # products of bf16 values are exact in fp32: a bf16 einsum with an
    # fp32 result
    dot = torch.matmul(q_proj.to(torch.float32), V.to(torch.float32).T)
    bias = (u @ ash["mu"]).to(torch.float32)  # (B,)
    return (dot * ash["scale"].to(torch.float32)[None, :]
            + bias[:, None]
            + ash["offset"].to(torch.float32)[None, :])


def _sasrec_retrieval(arch, cell: Cell, mesh, pol, constrain):
    from repro_torch.models import sasrec as SR

    n_cand = cell.shape["n_candidates"]
    params = _sharded_params(arch, mesh, pol)
    seq = _seq(arch, cell.shape.get("batch", 1), mesh, pol)

    if cell.shape.get("ash_bits"):
        # the paper's technique as the optimization: candidates
        # ASH-encoded offline; the step reads packed codes and 2-byte
        # headers instead of the fp32 table
        b = cell.shape["ash_bits"]
        e = arch.cfg.embed_dim
        d_code = e // cell.shape.get("ash_reduce", 1)
        Wd = Q.packed_width(d_code, b)
        row = SH.batch_rules_leading_dp(mesh, pol)
        ash = _batch_sds({"codes": ((n_cand, Wd), torch.int32),
                          "scale": ((n_cand,), torch.bfloat16),
                          "offset": ((n_cand,), torch.bfloat16)},
                         mesh, pol, row)
        ash.update(_batch_sds({"W": ((d_code, e), torch.float32),
                               "mu": ((e,), torch.float32)}, mesh, pol,
                              lambda k, shape: P()))

        def serve_step(params, ash, seq):
            u = SR.user_state(params, seq, arch.cfg)  # (B, e)
            return ash_catalog_scores(u, ash, d_code, b)

        return serve_step, (params, ash, seq)

    cand = _batch_sds({"cand_ids": ((n_cand,), torch.int32)}, mesh,
                      pol)["cand_ids"]

    def serve_step(params, seq, cand_ids):
        return SR.retrieval_score(params, seq, cand_ids, arch.cfg)

    return serve_step, (params, seq, cand)


CELL_BUILDERS = {
    ("transformer", "train"): _tfm_train,
    ("transformer", "prefill"): _tfm_prefill,
    ("transformer", "decode"): _tfm_decode,
    ("nequip", "train"): _nequip_train,
    ("recsys", "train"): _recsys_train,
    ("recsys", "serve"): _recsys_serve,
    ("recsys", "retrieval"): _recsys_retrieval,
    ("sasrec", "train"): _sasrec_train,
    ("sasrec", "serve"): _sasrec_serve,
    ("sasrec", "retrieval"): _sasrec_retrieval,
}


# ---------------------------------------------------------------------------
# Standard shape-cell sets
# ---------------------------------------------------------------------------


def lm_cells(full_attention: bool = True) -> dict:
    cells = {
        "train_4k": Cell("train_4k", "train",
                         {"seq_len": 4096, "global_batch": 256}),
        "prefill_32k": Cell("prefill_32k", "prefill",
                            {"seq_len": 32768, "global_batch": 32}),
        "decode_32k": Cell("decode_32k", "decode",
                           {"seq_len": 32768, "global_batch": 128}),
        "long_500k": Cell(
            "long_500k", "decode",
            {"seq_len": 524288, "global_batch": 1},
            skip=(
                "pure full-attention arch: long_500k officially skipped "
                "per brief (runnable via --include-skipped using the "
                "ASH-compressed KV cache)" if full_attention else None
            ),
        ),
        # EXTRA (beyond the 40 assigned cells): decode with the paper's
        # technique applied to the KV cache — 8x cache compression at
        # b=4 with d_code = d_head/2.
        "decode_32k_ashkv": Cell(
            "decode_32k_ashkv", "decode",
            {"seq_len": 32768, "global_batch": 128,
             "kv_quant_bits": 4, "kv_quant_dim": 0},
            skip="extra cell (beyond-paper ASH-KV serving variant)",
        ),
    }
    return cells


def recsys_cells() -> dict:
    return {
        "train_batch": Cell("train_batch", "train", {"batch": 65536}),
        "serve_p99": Cell("serve_p99", "serve", {"batch": 512}),
        "serve_bulk": Cell("serve_bulk", "serve", {"batch": 262144}),
        "retrieval_cand": Cell(
            "retrieval_cand", "retrieval",
            {"batch": 1, "n_candidates": 1_000_000},
        ),
    }


def gnn_cells() -> dict:
    return {
        "full_graph_sm": Cell(
            "full_graph_sm", "train",
            {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433},
        ),
        "minibatch_lg": Cell(
            "minibatch_lg", "train",
            # padded sampled-subgraph sizes for batch_nodes=1024,
            # fanout 15-10 (see data.graphs.neighbor_sample)
            {"n_nodes": 1024 * 16 * 11, "n_edges": 1024 * 150 * 26,
             "d_feat": 602, "edge_chunks": 8},
        ),
        "ogb_products": Cell(
            "ogb_products", "train",
            {"n_nodes": 2_449_029, "n_edges": 61_859_140, "d_feat": 100,
             "edge_chunks": 16},
        ),
        "molecule": Cell(
            "molecule", "train",
            {"n_nodes": 30 * 128, "n_edges": 64 * 128, "n_graphs": 128},
        ),
    }
